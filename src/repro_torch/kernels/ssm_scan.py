"""Wrapper of the CUDA selective-scan kernel ``csrc/ssm_scan.cu``.

Counterparts of ``repro/kernels/ssm_scan.py``: :func:`ssm_scan_chunk` of
``ssm_scan_chunk_pallas`` (time-major layout, a given ``h0``) and
:func:`ssm_scan` of ``ssm_scan_pallas`` (the ``(B, S, .)`` layout from
``h0 = 0``).  Each is one kernel launch over the whole sequence; the TPU's
``chunk`` and ``bdi`` blockings have no counterpart.  A CUDA tensor launches
the kernel (or raises); a CPU tensor runs the plain version in
``repro_torch.kernels.ref``.  Paths dispatch through ``ops.ssm_scan``,
which also honours ``ops.forced_path("ref")``.  Launches are counted in
``_build.launches["ssm_scan"]``.

For training, :func:`ssm_scan_train` is the same launch writing the state
as it enters each tile of :data:`STATE_EVERY` steps, and
:func:`ssm_scan_bwd` the gradient: one launch of ``csrc/ssm_scan_bwd.cu``
(counted in ``_build.launches["ssm_scan_bwd"]``), whose plain version is
``ref.ssm_scan_chunk_bwd_ref``.  Both serve ``ops.ssm_scan``'s autograd
Function on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ssm_scan_chunk_bwd_ref,
                                     ssm_scan_chunk_ref, ssm_scan_ref)

MAX_STATE = 64  # d_state a channel's two lanes hold in registers
STATE_EVERY = 16  # the kernels' tile (kSteps): the states training saves


def ssm_scan(dt, b_in, c_out, x_in, a_mat):
    """dt, x_in (B, S, di); b_in, c_out (B, S, ds); a_mat (di, ds) ->
    (y (B, S, di), h_final (B, di, ds)), from ``h0 = 0``."""
    if not dt.is_cuda:
        return ssm_scan_ref(dt, b_in, c_out, x_in, a_mat)
    return _launch(dt, b_in, c_out, x_in, a_mat, None, time_major=False)


def ssm_scan_chunk(dt, b_in, c_out, x_in, a_mat, h0):
    """dt, x_in (C, B, di); b_in, c_out (C, B, ds); a_mat (di, ds); h0
    (B, di, ds) -> (y (C, B, di), h_final (B, di, ds))."""
    if not dt.is_cuda:
        return ssm_scan_chunk_ref(dt, b_in, c_out, x_in, a_mat, h0)
    return _launch(dt, b_in, c_out, x_in, a_mat, h0, time_major=True)


def ssm_scan_train(dt, b_in, c_out, x_in, a_mat, h0=None, *,
                   time_major=False):
    """:func:`ssm_scan` (or, ``time_major``, :func:`ssm_scan_chunk` from
    ``h0``) on the card, also returning the state as it enters each tile
    of :data:`STATE_EVERY` steps: (y, h_final, h_tiles (B, ceil(S / 16),
    di, ds)), the states :func:`ssm_scan_bwd` takes."""
    if dt.is_cuda:
        return _launch(dt, b_in, c_out, x_in, a_mat, h0, time_major,
                       save_states=True)
    # the plain version: the plain scan a tile at a time
    tm = (lambda t: t) if time_major else (lambda t: t.transpose(0, 1))
    ins = [tm(t) for t in (dt, b_in, c_out, x_in)]
    h = (torch.zeros((ins[0].shape[1], *a_mat.shape), dtype=torch.float32)
         if h0 is None else h0.float())
    ys, tiles = [], []
    for t0 in range(0, ins[0].shape[0], STATE_EVERY):
        tiles.append(h)
        y, h = ssm_scan_chunk_ref(*(t[t0:t0 + STATE_EVERY] for t in ins),
                                  a_mat, h)
        ys.append(y)
    return tm(torch.cat(ys)).contiguous(), h, torch.stack(tiles, 1)


def _check(dt, b_in, c_out, x_in, a_mat, h0, time_major):
    """Raise ValueError unless the shapes agree; return (S, B, di, ds)."""
    shapes = [tuple(t.shape) for t in (dt, b_in, c_out, x_in, a_mat)]
    if dt.dim() != 3 or a_mat.dim() != 2:
        raise ValueError(f"ssm_scan shapes: {shapes}")
    s, bsz = dt.shape[:2] if time_major else dt.shape[1::-1]
    di, ds = a_mat.shape
    lead = dt.shape[:2]
    if (dt.shape[2] != di or x_in.shape != dt.shape
            or b_in.shape != (*lead, ds) or c_out.shape != (*lead, ds)
            or (h0 is not None and h0.shape != (bsz, di, ds))):
        raise ValueError(f"ssm_scan shapes disagree: dt, b, c, x, a {shapes}"
                         + ("" if h0 is None else f", h0 {tuple(h0.shape)}"))
    if ds > MAX_STATE:
        raise ValueError(f"ssm_scan takes d_state <= {MAX_STATE}, got {ds}")
    return s, bsz, di, ds


def _launch(dt, b_in, c_out, x_in, a_mat, h0, time_major, save_states=False):
    s, bsz, di, ds = _check(dt, b_in, c_out, x_in, a_mat, h0, time_major)
    operands = dict(dt=dt, b_in=b_in, c_out=c_out, x_in=x_in, a_mat=a_mat)
    if h0 is not None:
        operands["h0"] = h0
    stream = _build.check_operands("ssm_scan", **operands)
    y = torch.empty_like(dt)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=dt.device)
    n_tiles = -(-s // STATE_EVERY)
    tiles = (torch.empty((bsz, n_tiles, di, ds), dtype=torch.float32,
                         device=dt.device) if save_states else None)
    st, sb = _strides(dt, b_in, time_major)
    _build.launch("ssm_scan", dt.data_ptr(), b_in.data_ptr(), c_out.data_ptr(),
                  x_in.data_ptr(), a_mat.data_ptr(),
                  None if h0 is None else h0.data_ptr(), y.data_ptr(),
                  h.data_ptr(), None if tiles is None else tiles.data_ptr(),
                  n_tiles, bsz, s, di, ds, *st, *sb, stream)
    return (y, h, tiles) if save_states else (y, h)


def _strides(dt, b_in, time_major):
    """The (time, batch) strides of dt / x / y and of b / c."""
    st, sb = dt.stride()[:2], b_in.stride()[:2]
    return (st, sb) if time_major else (st[::-1], sb[::-1])


def ssm_scan_bwd(dt, b_in, c_out, x_in, a_mat, h_tiles, dy, dh, *,
                 time_major=False):
    """The scan's gradient: the forward's inputs, the states
    :func:`ssm_scan_train` saved, dy (the loss's gradient with respect to
    y, dt's shape) and dh (with respect to h_final, (B, di, ds)) ->
    (ddt, db, dc, dx, da, dh0), the gradients with respect to dt, b_in,
    c_out, x_in, a_mat and h0, float32.  Layouts as :func:`ssm_scan`, or
    time-major as :func:`ssm_scan_chunk`.  One launch of
    ``csrc/ssm_scan_bwd.cu`` (two grids: the walk, then the sums over
    channel blocks); on the CPU its plain version
    ``ref.ssm_scan_chunk_bwd_ref`` (which recomputes every state from
    ``h0 = h_tiles[:, 0]`` and does not read the others)."""
    if not dt.is_cuda:
        tm = (lambda t: t) if time_major else (lambda t: t.transpose(0, 1))
        out = ssm_scan_chunk_bwd_ref(*(tm(t) for t in (dt, b_in, c_out,
                                                        x_in)), a_mat,
                                     h_tiles[:, 0], tm(dy), dh)
        return (*(tm(t).contiguous() for t in out[:4]), *out[4:])
    s, bsz, di, ds = _check(dt, b_in, c_out, x_in, a_mat, None, time_major)
    n_tiles = -(-s // STATE_EVERY)
    if (dy.shape != dt.shape or dh.shape != (bsz, di, ds)
            or h_tiles.shape != (bsz, n_tiles, di, ds)):
        raise ValueError(
            f"ssm_scan_bwd shapes: dt {tuple(dt.shape)}, dy "
            f"{tuple(dy.shape)}, dh {tuple(dh.shape)}, h_tiles "
            f"{tuple(h_tiles.shape)}; a {tuple(a_mat.shape)}")
    stream = _build.check_operands(
        "ssm_scan_bwd", dt=dt, b_in=b_in, c_out=c_out, x_in=x_in,
        a_mat=a_mat, h_tiles=h_tiles, dy=dy, dh=dh)
    work = torch.empty((workspace_floats(bsz, s, di, ds),),
                       dtype=torch.float32, device=dt.device)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x_in)
    db, dc = torch.empty_like(b_in), torch.empty_like(c_out)
    da = torch.empty((di, ds), dtype=torch.float32, device=dt.device)
    dh0 = torch.empty((bsz, di, ds), dtype=torch.float32, device=dt.device)
    st, sb = _strides(dt, b_in, time_major)
    _build.launch("ssm_scan_bwd", *(t.data_ptr() for t in (
        dt, b_in, c_out, x_in, a_mat, h_tiles)), n_tiles,
        *(t.data_ptr() for t in (dy, dh, ddt, db, dc, dx, da, dh0, work)),
        bsz, s, di, ds, *st, *sb, stream)
    return ddt, db, dc, dx, da, dh0


def workspace_floats(bsz, s, di, ds) -> int:
    """The float32 scratch one :func:`ssm_scan_bwd` launch takes: every
    CTA's partial of dB and dC for each step, and dA's part of each batch
    (the kernel's second grid sums them)."""
    n = ctypes.c_int64()
    err = _build.function("ssm_scan_bwd", "ssm_scan_bwd_workspace_f32")(
        bsz, s, di, ds, ctypes.addressof(n))
    if err:
        raise ValueError(f"ssm_scan_bwd takes 1 <= S and 1 <= d_state <= "
                         f"{MAX_STATE}, got S={s}, d_state={ds}")
    return n.value
