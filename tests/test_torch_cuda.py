"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Skips without one. Imports neither JAX nor the reference, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import partition as tpart
from repro_torch.kernels import ref as tref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def probe_case(seed, n, m, m_valid, zero_key, g=64):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(4 * m)[:m_valid].astype(np.int32) + 1
    if zero_key:
        keys[0] = 0                       # a real build row with key 0
    bk = np.zeros(m, np.int32)
    bk[:m_valid] = keys                   # padding rows keep key 0
    bc = np.zeros(m, np.int32)
    bc[:m_valid] = (np.arange(m_valid) * 7) % 1000
    bv = np.zeros(m, np.int32)
    bv[:m_valid] = 1
    pk = rng.integers(0, 8 * m, n).astype(np.int32)
    hit = rng.random(n) < 0.5
    pk = np.where(hit, bk[rng.integers(0, m_valid, n)], pk).astype(np.int32)
    q = n // 8
    pk[:q] = 0                            # probe zeros against padding
    pk[q: 2 * q] = pk[2 * q: 3 * q]       # duplicate probe keys
    v0 = rng.standard_normal(n).astype(np.float32)
    v1 = rng.standard_normal(n).astype(np.float32)
    return pk, v0, v1, bk, bc, bv, g


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1 << 20, 512), (1 << 20, 15),
                                 (1000003, 65), (100, 2)])
def test_cuda_k1_matches_plain(cuda_device, n, p):
    ids = torch.randint(0, p, (n,), dtype=torch.int32, device=cuda_device)
    got = tpart.partition_histogram(ids, p)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.partition_histogram_ref(ids, p))


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d", [(1 << 20, 15, 1), (3333, 65, 1),
                                   (2053, 9, 3), (1000, 1, 2)])
def test_cuda_k2_matches_plain(cuda_device, n, p, d):
    ids = torch.randint(0, p, (n,), dtype=torch.int32, device=cuda_device)
    rows = torch.randn((n, d), device=cuda_device)
    out, off = tpart.partition_scatter(rows, ids, p)
    r_out, r_off = tref.partition_scatter_ref(rows, ids, p)
    torch.cuda.synchronize()
    assert torch.equal(off, r_off)
    assert torch.equal(out.view(torch.int32), r_out.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,m,m_valid,zero_key", [
    (0, 1 << 16, 8192, 7692, False), (1, 4096, 16384, 16381, True),
    (2, 100, 8, 3, True)])
def test_cuda_k3_matches_plain(cuda_device, seed, n, m, m_valid, zero_key):
    args = [_t(a).to(cuda_device) for a in
            probe_case(seed, n, m, m_valid, zero_key)[:6]]
    grp, wgt = tpart.fused_probe(*args, 64)
    r_grp, r_wgt = tref.fused_probe_ref(*args, 64)
    torch.cuda.synchronize()
    assert torch.equal(grp, r_grp)
    assert torch.equal(wgt.view(torch.int32), r_wgt.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, 15])
def test_cuda_k1_k2_refuse_ids_out_of_range(cuda_device, bad):
    ids = torch.randint(0, 15, (5000,), dtype=torch.int32, device=cuda_device)
    ids[4321] = bad
    tpart.reset_launches()
    with pytest.raises(ValueError, match="partition ids"):
        tpart.partition_histogram(ids, 15)
    with pytest.raises(ValueError, match="partition ids"):
        tpart.partition_scatter(ids[:, None], ids, 15)
    assert tpart.LAUNCHES["partition_histogram"] == 0
    assert tpart.LAUNCHES["partition_scatter"] == 0
