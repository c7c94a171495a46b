"""Mixture-of-Experts: capacity-based, sort-free dispatch and a grouped
gated FFN over the experts.

Counterpart of ``repro/models/moe.py`` without a mesh (the reference's
``moe_apply_local`` with ``axis=None``, which is ``moe_ref``; the
``shard_map`` over ``"model"`` waits with the rest of ``launch/``).  Each
(token, choice) pair gets a rank within its expert from a one-hot cumsum;
ranks at or past the capacity are dropped, as in the reference.  The
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
from typing import NamedTuple

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
    rank``, the sentinel ``E * cap`` where dropped)."""
    top_p: torch.Tensor
    top_e: torch.Tensor
    ranks: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def route(cfg, router, xf) -> Routing:
    """The router over ``xf`` (T, D), in float32.

    The tie rule: among equal probabilities the lower expert index comes
    first, as ``lax.top_k`` orders them (``torch.topk`` promises no order
    among ties).  The top k are taken from a stable descending sort, which
    keeps equal values in index order; so a zero router picks experts
    ``0 .. k-1``, as the reference does.
    """
    m = cfg.moe
    t = xf.shape[0]
    e_pad = router.shape[1]
    logits = xf.float() @ router.float()
    if e_pad > m.n_experts:
        pad = torch.arange(e_pad, device=xf.device) >= m.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :m.top_k], top_e[:, :m.top_k]
    if m.renorm:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # sort-free rank within the expert: the pairs before this one (token
    # major, choice minor) that chose the same expert.  The one-hot is held
    # an expert a row, so that the cumsum runs along the contiguous axis:
    # along the other, torch scans each of the E columns in one thread
    flat_e = top_e.reshape(-1)
    oh = (torch.arange(e_pad, device=xf.device)[:, None] == flat_e).to(
        torch.int32)
    ranks = (oh.cumsum(1, dtype=torch.int32) - oh).gather(
        0, flat_e[None, :])[0]
    cap = _capacity(cfg, t, e_pad)
    keep = ranks < cap
    slot = torch.where(keep, flat_e * cap + ranks, e_pad * cap)
    return Routing(top_p, top_e, ranks, keep, slot, cap)


def _act(cfg):
    return F.silu if cfg.mlp_act == "silu" else functools.partial(
        F.gelu, approximate="tanh")


def moe_apply_local(cfg, p, x, *, axis=None):
    """x: (B, S, D); ``p`` holds ``moe_defs``' weights (a :class:`MoE`).

    Only ``axis=None`` (no mesh) is ported.  The dispatch buffer holds one
    token index per slot of the (E, C) grid, plus a sentinel slot at
    ``E * C`` that takes every dropped pair and is then cut off, as the
    reference's ``mode="drop"`` drops it: duplicate writes land only
    there, so the order of ``index_put_``'s writes touches nothing that
    is read.  Empty slots gather a zero row.  Then the gated FFN of every
    expert over its (C, D) block in the compute dtype, the combine
    weighted by ``top_p`` cast to the compute dtype (a dropped pair adds
    zeros), and the shared experts.  The (E, C, D) blocks are freed as
    soon as they are used: at the no-drop capacity (C ~ T) they are the
    largest tensors of a layer.
    """
    if axis is not None:
        raise NotImplementedError(
            "the MoE over a mesh axis (shard_map over 'model') is not "
            "ported yet: ROADMAP.md Queue 1 item 1.5")
    b, s, d = x.shape
    cd = x.dtype
    k = cfg.moe.top_k
    t = b * s
    e_pad = p.router.shape[1]
    xf = x.reshape(t, d)
    r = route(cfg, p.router, xf)
    n_slots = e_pad * r.cap

    tok = torch.arange(t * k, device=x.device) // k
    buf_tok = torch.full((n_slots + 1,), t, dtype=torch.long,
                         device=x.device)
    buf_tok[r.slot] = tok
    x_ext = torch.cat([xf, xf.new_zeros(1, d)])
    h = x_ext[buf_tok[:n_slots]].reshape(e_pad, r.cap, d)

    act = _act(cfg)
    g = act(torch.bmm(h, p.wg.to(cd)))
    g = g * torch.bmm(h, p.wi.to(cd))
    del h
    y = torch.bmm(g, p.wo.to(cd)).reshape(n_slots, d)
    del g
    # a dropped pair reads zeros, as the reference's sentinel row
    picked = torch.where(r.keep[:, None], y[r.slot.clamp_max(n_slots - 1)],
                         0.0).reshape(t, k, d)
    del y
    out = (picked * r.top_p.to(cd).reshape(t, k, 1)).sum(1)

    if cfg.moe.n_shared:
        gs = act(xf @ p.shared_wg.to(cd))
        out = out + (gs * (xf @ p.shared_wi.to(cd))) @ p.shared_wo.to(cd)
    return out.reshape(b, s, d)


def moe_ref(cfg, p, x):
    """The single-device path: ``moe_apply_local`` without a mesh."""
    return moe_apply_local(cfg, p, x, axis=None)


class MoE(nn.Module):
    """The MoE MLP under the reference's name ``mlp``; its parameters carry
    ``moe_defs``' names and shapes (``router``, ``wi``, ``wg``, ``wo`` and,
    with shared experts, ``shared_wi``, ``shared_wg``, ``shared_wo``)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        register(self, moe_defs(cfg), device=device, dtype=dtype)

    def forward(self, x):
        return moe_ref(self.cfg, self, x)
