"""Shape-and-dtype stand-ins and shardings for every (arch x shape) cell.

Counterpart of ``repro/launch/inputs.py``.  Nothing here allocates: the
abstract arguments are :class:`~repro_torch._device.ShapeDtype` records
(the dry-run makes ``meta`` tensors of them), the shardings
:class:`~repro_torch.sharding.NamedSharding` records keyed like them.  The
modality front ends are stubs, as in the reference: [vlm] gets
precomputed patch embeddings, [audio] precomputed frame embeddings.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import ShapeDtype
from repro_torch.models import transformer as T
from repro_torch.sharding.specs import NamedSharding, to_pspec


class ShapeCell(NamedTuple):
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train", 4096, 256),
    "prefill_32k": ShapeCell("prefill", 32768, 32),
    "decode_32k": ShapeCell("decode", 32768, 128),
    "long_500k": ShapeCell("decode", 524288, 1),
}

# long_500k needs a sub-quadratic path: run only for SSM/hybrid
LONG_OK_FAMILIES = ("ssm", "hybrid")

VLM_PATCHES = 256  # stub patch-embedding prefix length for [vlm] train/prefill


def cell_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, ("full-attention arch: no sub-quadratic path at 500k "
                       "(see DESIGN.md)")
    return True, ""


def batch_specs(cfg, cell: ShapeCell) -> dict:
    """Abstract training/serving batch for one cell; tokens, labels and
    positions int32, as the reference's."""
    b, s = cell.batch, cell.seq
    cd = getattr(torch, cfg.compute_dtype)
    out = {"tokens": ShapeDtype((b, s), torch.int32)}
    if cell.kind == "train":
        out["labels"] = ShapeDtype((b, s), torch.int32)
    if cfg.mrope_sections:
        out["positions"] = ShapeDtype((b, s, 3), torch.int32)
    if cfg.frontend == "vision" and cell.kind in ("train", "prefill"):
        out["extra_embeds"] = ShapeDtype((b, VLM_PATCHES, cfg.d_model), cd)
    if cfg.enc_layers and cell.kind in ("train", "prefill"):
        out["enc_frames"] = ShapeDtype((b, cfg.enc_ctx, cfg.d_model), cd)
    return out


def batch_shardings(cfg, cell: ShapeCell, mesh) -> dict:
    an = mesh.axis_names

    def sh(*tags):
        return NamedSharding(mesh, to_pspec(tags, an))

    out = {"tokens": sh("dp", None)}
    if cell.kind == "train":
        out["labels"] = sh("dp", None)
    if cfg.mrope_sections:
        out["positions"] = sh("dp", None, None)
    if cfg.frontend == "vision" and cell.kind in ("train", "prefill"):
        out["extra_embeds"] = sh("dp", None, None)
    if cfg.enc_layers and cell.kind in ("train", "prefill"):
        out["enc_frames"] = sh("dp", None, None)
    return out


def param_shardings(cfg, mesh) -> dict:
    return {path: NamedSharding(mesh, spec) for path, spec
            in T.param_pspecs(cfg, mesh.axis_names).items()}


def _enc_len(cfg) -> int:
    return cfg.enc_ctx if cfg.enc_layers else 0


def cache_shardings(cfg, cell: ShapeCell, mesh) -> dict:
    specs = T.cache_pspecs(cfg, cell.batch, cell.seq, mesh.axis_names,
                           enc_len=_enc_len(cfg))
    return {path: NamedSharding(mesh, spec) for path, spec in specs.items()}


def abstract_cache(cfg, cell: ShapeCell) -> dict:
    return T.abstract_cache(cfg, cell.batch, cell.seq, enc_len=_enc_len(cfg))
