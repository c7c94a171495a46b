"""Mixture-of-Experts: capacity-based, sort-free dispatch and a grouped
gated FFN over the experts.

Counterpart of ``repro/models/moe.py``: ``moe_apply_local`` without a
mesh (``axis=None``, which is ``moe_ref``) and over a ``"model"`` axis
(the reference's ``shard_map``, as a host loop over the axis's
positions).  Each (token, choice) pair gets a rank within its expert
from a one-hot cumsum; ranks at or past the capacity are dropped, as in
the reference.  The
router runs in float32 (TF32 stays off, ``_device.py``: a TF32 router
flips expert choices); the experts run in the compute dtype, their
float32 weights cast at use, one stack at a time.  Plain torch, as the
reference is plain ``jnp``: no Pallas kernel lies on this path.

Experts are padded to a multiple of ``EP_GRANULARITY`` (granite: 40 ->
48) and the padded ones get ``-1e30`` router logits, so the parameter
shapes and the routing are the reference's.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import PD, register

# the reference pads the experts to its production model-axis width, so
# the shapes (and the routing) do not depend on the mesh
EP_GRANULARITY = 16


def padded_experts(cfg) -> int:
    e = cfg.moe.n_experts
    return -(-e // EP_GRANULARITY) * EP_GRANULARITY


def moe_defs(cfg):
    d = cfg.d_model
    m = cfg.moe
    e_pad = padded_experts(cfg)
    f = m.d_expert or cfg.d_ff
    defs = {
        "router": PD((d, e_pad), (None, None), d),
        "wi": PD((e_pad, d, f), ("tp", None, None), d),
        "wg": PD((e_pad, d, f), ("tp", None, None), d),
        "wo": PD((e_pad, f, d), ("tp", None, None), f),
    }
    if m.n_shared:
        fs = f * m.n_shared
        defs |= {
            "shared_wi": PD((d, fs), (None, "tp"), d),
            "shared_wg": PD((d, fs), (None, "tp"), d),
            "shared_wo": PD((fs, d), ("tp", None), fs),
        }
    return defs


def _capacity(cfg, n_tokens: int, e_pad: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / e_pad) + 1
    return -(-c // 8) * 8


class Routing(NamedTuple):
    """One call's routing over its T tokens: ``top_p``, ``top_e`` (T, k);
    then per (token, choice) pair, token-major: ``ranks`` within the
    expert, ``keep`` (rank below ``cap``) and ``slot`` (``e * cap +
    rank``, the sentinel ``E * cap`` where dropped).  Routed in groups
    (data shards), each field has a leading group axis."""
    top_p: torch.Tensor
    top_e: torch.Tensor
    ranks: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def route(cfg, router, xf) -> Routing:
    """The router over ``xf`` (T, D), in float32; ``xf`` (G, T, D) routes
    G groups of T tokens each on their own (ranks counted within the
    group, the capacity from its T), as G data shards do.

    The tie rule: among equal probabilities the lower expert index comes
    first, as ``lax.top_k`` orders them (``torch.topk`` promises no order
    among ties).  The top k are taken from a stable descending sort, which
    keeps equal values in index order; so a zero router picks experts
    ``0 .. k-1``, as the reference does.
    """
    m = cfg.moe
    t = xf.shape[-2]
    e_pad = router.shape[1]
    logits = xf.float() @ router.float()
    if e_pad > m.n_experts:
        pad = torch.arange(e_pad, device=xf.device) >= m.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :m.top_k], top_e[..., :m.top_k]
    if m.renorm:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # sort-free rank within the expert: the pairs before this one (token
    # major, choice minor) that chose the same expert.  The one-hot is held
    # an expert a row, so that the cumsum runs along the contiguous axis:
    # along the other, torch scans each of the E columns in one thread
    flat_e = top_e.flatten(-2)
    oh = (torch.arange(e_pad, device=xf.device)[:, None]
          == flat_e[..., None, :]).to(torch.int32)
    ranks = (oh.cumsum(-1, dtype=torch.int32) - oh).gather(
        -2, flat_e[..., None, :])[..., 0, :]
    cap = _capacity(cfg, t, e_pad)
    keep = ranks < cap
    slot = torch.where(keep, flat_e * cap + ranks, e_pad * cap)
    return Routing(top_p, top_e, ranks, keep, slot, cap)


def _act(cfg):
    return F.silu if cfg.mlp_act == "silu" else functools.partial(
        F.gelu, approximate="tanh")


def _pair_inputs(r: Routing, xf):
    """What every position of the axis shares: each pair's row among the
    G groups' tokens (``g T + token``, pairs token-major, flat), the
    tokens' rows (G T, D) with a zero row appended, and each pair's
    weight ``top_p`` in the compute dtype (G, T, k, 1)."""
    n_grp, t, d = xf.shape
    k = r.top_e.shape[-1]
    tok = torch.arange(t * k, device=xf.device) // k
    if n_grp > 1:
        tok = (tok + torch.arange(n_grp, device=xf.device)[:, None] * t
               ).reshape(-1)
    x_ext = torch.cat([xf.reshape(-1, d), xf.new_zeros(1, d)])
    return tok, x_ext, r.top_p.to(xf.dtype)[..., None]


def _local_experts(cap: int, tok, x_ext, w, rows, wi, wg, wo, act):
    """The combined output (G, T, D) of the experts whose weights ``wi``,
    ``wg``, ``wo`` are (E_loc of them), each pair at its row ``rows`` (G,
    T k) of the G groups' (G E_loc C) local slots, a pair at the sentinel
    row ``G E_loc C`` (not kept here) adding zeros; ``tok``, ``x_ext``,
    ``w`` are :func:`_pair_inputs`'.  The groups' slots of one expert
    form one (G C, D) block of its products.

    Both gathers are ``F.embedding`` over rows with a zero row appended as
    the ``padding_idx``: an empty slot reads it, and so does a pair not
    kept here, and its backward skips them.  (A plain index's backward
    accumulates the pairs not kept, most of them at one position of the
    axis, into that one row one by one.)"""
    n_grp, t, k, _ = w.shape
    d = x_ext.shape[1]
    cd = x_ext.dtype
    e_loc = wi.shape[0]
    n_all = n_grp * e_loc * cap
    buf_tok = torch.full((n_all + 1,), n_grp * t, dtype=torch.long,
                         device=x_ext.device)
    buf_tok[rows.reshape(-1)] = tok
    h = F.embedding(buf_tok[:n_all], x_ext, padding_idx=n_grp * t)
    h = h.reshape(n_grp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n_grp * cap, d)
    g = act(torch.bmm(h, wg.to(cd)))
    g = g * torch.bmm(h, wi.to(cd))
    del h
    y = torch.bmm(g, wo.to(cd))
    del g
    y = y.reshape(e_loc, n_grp, cap, d).transpose(0, 1).reshape(-1, d)
    y_ext = torch.cat([y, y.new_zeros(1, d)])
    del y
    picked = F.embedding(rows, y_ext, padding_idx=n_all)
    del y_ext
    return (picked.reshape(n_grp, t, k, d) * w).sum(2)


def _shared(act, xf, wi, wg, wo):
    cd = xf.dtype
    return (act(xf @ wg.to(cd)) * (xf @ wi.to(cd))) @ wo.to(cd)


def moe_apply_local(cfg, p, x, *, axis=None, devices=None, shards: int = 1):
    """x: (B, S, D); ``p`` holds ``moe_defs``' weights (a :class:`MoE`).

    The dispatch buffer holds one token index per slot of the (E, C) grid,
    plus a sentinel slot at ``E * C`` that takes every pair not kept and
    is then cut off, as the reference's ``mode="drop"`` drops it:
    duplicate writes land only there, so the order of ``index_put_``'s
    writes touches nothing that is read.  Empty slots gather a zero row.
    Then the gated FFN of every expert over its (C, D) block in the
    compute dtype, the combine weighted by ``top_p`` cast to the compute
    dtype, and the shared experts.  The (E, C, D) blocks are freed as
    soon as they are used: at the no-drop capacity (C ~ T) they are the
    largest tensors of a layer.

    ``shards``: the batch holds that many data shards, ``B / shards``
    rows each, and each routes its own tokens with the capacity of its
    own token count, as the reference's data-parallel shards do; their
    experts' products run as one batch.

    ``axis=None``: no mesh (the reference's ``moe_ref``).  ``axis`` a
    name (``"model"``): ``devices`` lists the devices at that axis's
    positions, in order, and the call does what the reference's
    ``shard_map`` over the axis does, as a host loop: the routing, which
    the reference replicates, once on x's device; then position ``i``, on
    ``devices[i]`` (its slices and the routing copied there where that is
    another device), takes experts ``[i E_loc, (i + 1) E_loc)``, the pairs
    whose slot lies in its ``[i E_loc C, (i + 1) E_loc C)``, and the
    ``fs / tp`` slice of the shared experts that ``moe_defs`` tags
    ``"tp"`` (``shared_wi`` and ``shared_wg`` by column, ``shared_wo`` by
    row); the positions' outputs are summed on x's device in position
    order, in place of the reference's ``psum``.  Raises ValueError where
    the axis does not divide the padded experts or the shared width.
    """
    b, s, d = x.shape
    if b % shards:
        raise ValueError(f"a batch of {b} does not split into {shards} "
                         "data shards")
    if axis is None:
        devices = [x.device]
    elif not devices:
        raise ValueError(f"axis={axis!r} needs the devices of its positions")
    tp = len(devices)
    e_pad = p.router.shape[1]
    shared = ("shared_wi", "shared_wg", "shared_wo") \
        if cfg.moe.n_shared else ()
    fs = p.shared_wi.shape[1] if shared else 0
    if e_pad % tp or fs % tp:
        raise ValueError(
            f"a {tp}-way {axis!r} axis does not divide the {e_pad} padded "
            f"experts" + (f" or the shared width {fs}" if shared else ""))
    e_loc, f_loc = e_pad // tp, fs // tp
    xf = x.reshape(shards, b // shards * s, d)
    r = route(cfg, p.router, xf)
    n_loc = e_loc * r.cap
    if tp > 1 or shards > 1:
        # each pair's position (tp for a dropped pair: its slot is the
        # sentinel E C) and its row among that position's groups' slots
        pos = torch.div(r.slot, n_loc, rounding_mode="floor")
        base = r.slot - pos * n_loc
        if shards > 1:
            base = base + torch.arange(shards, device=x.device)[:, None] \
                * n_loc
    act = _act(cfg)
    tok, x_ext, w = _pair_inputs(r, xf)
    out = None
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        rows = r.slot if tp == shards == 1 else torch.where(
            pos == i, base, shards * n_loc)
        ex = slice(i * e_loc, (i + 1) * e_loc)
        part = _local_experts(r.cap, tok.to(dev), x_ext.to(dev), w.to(dev),
                              rows.to(dev), p.wi[ex].to(dev),
                              p.wg[ex].to(dev), p.wo[ex].to(dev), act)
        if shared:
            fl = slice(i * f_loc, (i + 1) * f_loc)
            part = part + _shared(act, xf.to(dev), p.shared_wi[:, fl].to(dev),
                                  p.shared_wg[:, fl].to(dev),
                                  p.shared_wo[fl].to(dev))
        part = part.to(x.device)
        out = part if out is None else out + part
    return out.reshape(b, s, d)


def moe_ref(cfg, p, x):
    """The single-device path: ``moe_apply_local`` without a mesh."""
    return moe_apply_local(cfg, p, x, axis=None)


def moe_call(cfg, p, x, mesh):
    """The MoE MLP over ``mesh`` (the reference's ``transformer._moe_call``).

    Without a mesh: ``moe_ref``.  With one: where the batch divides the
    data positions (``"pod"`` x ``"data"``), its rows split into as many
    data shards (``batch_tag = "dp"``), in the order a ``PartitionSpec(
    ("pod", "data"))`` lays them out, and each shard routes its own
    tokens, so its capacity comes from its local token count; else the
    batch is one shard, replicated.  The experts run over the ``"model"``
    positions (``moe_apply_local(axis="model")``) of the mesh's first
    data row, the data shards batched: the port runs one program, and
    only the model axis places work on the positions' devices."""
    if mesh is None:
        return moe_ref(cfg, p, x)
    names = mesh.axis_names
    dp_total = math.prod(mesh.shape[a] for a in ("pod", "data")
                         if a in names)
    grid = mesh.devices[tuple(slice(None) if a == "model" else 0
                              for a in names)]
    return moe_apply_local(
        cfg, p, x, axis="model", devices=list(np.ravel(grid)),
        shards=dp_total if x.shape[0] % dp_total == 0 else 1)


class MoE(nn.Module):
    """The MoE MLP under the reference's name ``mlp``; its parameters carry
    ``moe_defs``' names and shapes (``router``, ``wi``, ``wg``, ``wo`` and,
    with shared experts, ``shared_wi``, ``shared_wg``, ``shared_wo``)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        register(self, moe_defs(cfg), device=device, dtype=dtype)

    def forward(self, x, mesh=None):
        return moe_call(self.cfg, self, x, mesh)
