"""Mamba-1 selective-SSM block (falcon-mamba-7b; jamba's SSM layers).

Counterpart of ``repro/models/mamba.py``.  Prefill runs the causal
depthwise conv as the reference's sum of ``d_conv`` shifted products, then
the whole sequence's selective scan in one ``ops.ssm_scan`` call: on the
card one launch of the hand-written kernel (``kernels/csrc/ssm_scan.cu``),
under ``ops.forced_path("ref")`` or on the CPU its plain version.  The
reference's ``scan_chunk`` (timesteps unrolled per ``lax.scan`` step, and
``chunk = 1`` where it does not divide S) changes nothing in the math and
has no counterpart: the launch covers any S.  In training the same call
is differentiable: ``ops.ssm_scan`` is an autograd Function whose backward
is one launch of ``kernels/csrc/ssm_scan_bwd.cu``, so every gradient that
flows through the scan (``in_proj``'s x half, the conv, ``x_proj``,
``dt_w``, ``dt_b``, ``a_log``) reaches its parameter.  Decode keeps (conv
window, ssm state) and takes one step in plain torch.  The scan, its
state and its inputs are float32 whatever the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import PD, register


def mamba_defs(cfg):
    d = cfg.d_model
    di = cfg.d_inner
    s = cfg.ssm
    dtr = cfg.dt_rank
    return {
        "in_proj": PD((d, 2 * di), ("fsdp", "tp"), d),
        "conv_w": PD((s.d_conv, di), (None, "tp"), s.d_conv),
        "conv_b": PD((di,), ("tp",)),
        "x_proj": PD((di, dtr + 2 * s.d_state), ("tp", None), di),
        "dt_w": PD((dtr, di), (None, "tp"), dtr),
        "dt_b": PD((di,), ("tp",)),
        "a_log": PD((di, s.d_state), ("tp", None)),
        "d_skip": PD((di,), ("tp",)),
        "out_proj": PD((di, d), ("tp", "fsdp"), di),
    }


class Mamba(nn.Module):
    """One Mamba mixer; its parameters carry ``mamba_defs``' names and
    shapes, uninitialised until ``transformer.init_params`` or
    ``convert.params_from_jax`` fills them."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        register(self, mamba_defs(cfg), device=device, dtype=dtype)

    def _ssm_inputs(self, xc):
        """After the conv: (dt softplused, b_in, c_out), all float32."""
        cfg = self.cfg
        dtr, ds = cfg.dt_rank, cfg.ssm.d_state
        xdbc = xc @ self.x_proj.to(xc.dtype)
        dt_r, b_in, c_out = (xdbc[..., :dtr], xdbc[..., dtr:dtr + ds],
                             xdbc[..., dtr + ds:])
        dt = F.softplus(dt_r.float() @ self.dt_w.float() + self.dt_b)
        return dt, b_in.float(), c_out.float()

    def forward(self, x, state=None):
        """x: (B, S, D).  ``state=None``: the whole sequence (prefill);
        returns (out, (conv_buf (B, d_conv - 1, di), h (B, di, ds))).  With
        ``state=(conv_buf, h)``: one decode step (S == 1), returns (out,
        new_state)."""
        s = self.cfg.ssm
        di = self.cfg.d_inner
        cd = x.dtype
        bsz, seq, _ = x.shape
        xz = x @ self.in_proj.to(cd)
        x_in, z = xz[..., :di], xz[..., di:]
        a_mat = -torch.exp(self.a_log.float())  # (di, ds)

        if state is None:
            xpad = F.pad(x_in, (0, 0, s.d_conv - 1, 0))
            xc = xpad[:, :seq] * self.conv_w[0].to(cd)
            for i in range(1, s.d_conv):
                xc = xc + xpad[:, i:i + seq] * self.conv_w[i].to(cd)
            xc = F.silu(xc + self.conv_b.to(cd))
            dt, b_in, c_out = self._ssm_inputs(xc)
            # the kernel takes contiguous float32; the inputs are slices
            y, h_fin = ops.ssm_scan(dt.contiguous(), b_in.contiguous(),
                                    c_out.contiguous(),
                                    x_in.float().contiguous(), a_mat)
            y = y + x_in.float() * self.d_skip
            out = (y.to(cd) * F.silu(z)) @ self.out_proj.to(cd)
            conv_buf = (xpad[:, seq:] if s.d_conv > 1
                        else x_in.new_zeros((bsz, 0, di)))
            return out, (conv_buf.to(cd), h_fin)

        conv_buf, h = state
        if seq != 1:
            raise ValueError(f"a decode step takes one token, got {seq}")
        window = torch.cat([conv_buf, x_in.to(conv_buf.dtype)], dim=1)
        xc = (torch.einsum("btd,td->bd", window.to(cd), self.conv_w.to(cd))
              + self.conv_b.to(cd))
        dt, b_in, c_out = self._ssm_inputs(F.silu(xc)[:, None, :])
        dt_t, b_t, c_t = dt[:, 0], b_in[:, 0], c_out[:, 0]
        x_t = x_in[:, 0].float()
        da = torch.exp(dt_t[:, :, None] * a_mat[None])
        h = h * da + (dt_t * x_t)[:, :, None] * b_t[:, None, :]
        y = (h * c_t[:, None, :]).sum(-1) + x_t * self.d_skip
        out = (y[:, None, :].to(cd) * F.silu(z)) @ self.out_proj.to(cd)
        return out, (window[:, 1:, :], h)
