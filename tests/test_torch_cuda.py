"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.anticluster import anticluster
from repro_torch.core.objective import balance_ok
from repro_torch.kernels import bid_top2 as bid_mod
from repro_torch.kernels import gather as gather_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bid_top2_ref, gather_rows_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int_inputs(seed, m, k, d, G):
    gen = torch.Generator().manual_seed(seed)

    def r(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen).float()

    return r(-2, 3, (G, m, d)), r(-1, 2, (G, k, d)), r(-2, 3, (G, k))


@pytest.mark.cuda
@pytest.mark.parametrize("G,m,k,d", [(1, 256, 256, 22), (1, 256, 256, 32),
                                     (4, 256, 256, 32), (1, 37, 37, 5),
                                     (1, 64, 513, 200), (2, 9, 1, 7)])
def test_cuda_bid_top2_vs_plain(cuda, G, m, k, d):
    x, c, p = (t.to(cuda) for t in _int_inputs(G * m + k, m, k, d, G))
    n0 = bid_mod.launches
    got = bid_mod.bid_top2(x, c, p)
    assert bid_mod.launches == n0 + 1
    want = bid_top2_ref(x, c, p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    xf = x + torch.randn_like(x)
    got = bid_mod.bid_top2(xf, c, p)
    w1, wj, w2 = bid_top2_ref(xf, c, p)
    scale = w1.abs().max().item()
    torch.testing.assert_close(got[0], w1, rtol=1e-5, atol=1e-4 * scale)
    torch.testing.assert_close(got[2], w2, rtol=1e-5, atol=1e-4 * scale)
    clear = (w1 - w2) > 1e-4 * scale
    assert torch.equal(got[1][clear], wj[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [22, 32])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cuda_gather_rows_bitwise(cuda, d, idx_dtype):
    x = torch.randn(2537, d, device=cuda)
    idx = torch.randint(-50, 2600, (8192,), device=cuda, dtype=idx_dtype)
    n0 = gather_mod.launches
    got = gather_mod.gather_rows(x, idx)
    assert gather_mod.launches == n0 + 1
    assert torch.equal(got, gather_rows_ref(x, idx))
    with pytest.raises(ValueError):
        gather_mod.gather_rows(x.double(), idx)


@pytest.mark.cuda
def test_cuda_stream_path_launches_kernels_and_matches_plain(cuda):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4096, 22)).astype(np.float32))
    kw = dict(k=64, chunk_size=1024, solver="auction_fused", device=cuda)
    n0 = (bid_mod.launches, gather_mod.launches)
    res = anticluster(x.to(cuda), **kw)
    assert bid_mod.launches > n0[0] and gather_mod.launches > n0[1]
    with ops.forced_path("ref"):
        n1 = (bid_mod.launches, gather_mod.launches)
        plain = anticluster(x.to(cuda), **kw)
        assert (bid_mod.launches, gather_mod.launches) == n1
    for r in (res, plain):
        assert balance_ok(r.labels.cpu(), 64)
    assert torch.equal(anticluster(x.to(cuda), **kw).labels, res.labels)
