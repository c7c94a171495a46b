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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssm_scan_chunk_ref, ssm_scan_ref

MAX_STATE = 64  # d_state a channel's two lanes hold in registers


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


def _launch(dt, b_in, c_out, x_in, a_mat, h0, time_major):
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
    operands = dict(dt=dt, b_in=b_in, c_out=c_out, x_in=x_in, a_mat=a_mat)
    if h0 is not None:
        operands["h0"] = h0
    stream = _build.check_operands("ssm_scan", **operands)
    y = torch.empty_like(dt)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=dt.device)
    # (time, batch) strides of dt / x / y and of b / c
    st, sb = dt.stride()[:2], b_in.stride()[:2]
    if not time_major:
        st, sb = st[::-1], sb[::-1]
    _build.launch("ssm_scan", dt.data_ptr(), b_in.data_ptr(), c_out.data_ptr(),
                  x_in.data_ptr(), a_mat.data_ptr(),
                  None if h0 is None else h0.data_ptr(), y.data_ptr(),
                  h.data_ptr(), bsz, s, di, ds, *st, *sb, stream)
    return y, h
