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


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def colliding_keys(count, first=0):
    """``count`` distinct int32 keys whose multiply-shift hash under K3's
    multiplier has its top 16 bits all set, so that K3's table, whatever its
    size (at most 2^16 slots), puts them all in its last slot: one chain,
    which wraps around the table's end (``first`` skips that many keys)."""
    inv = pow(tpart.FUSED_HASH_MULT, -1, 1 << 32)
    return np.array([(0xFFFF0000 + first + i) * inv % (1 << 32)
                     for i in range(count)], np.uint32).view(np.int32)


def probe_case(seed, n, m, m_valid, zero_key, g=64, kind=None):
    """K3's inputs: M build rows, the first ``m_valid`` valid (distinct
    keys, padding rows with key 0), N probes of which about half hit, an
    eighth probe key 0 and an eighth repeat others. ``kind`` adds an edge:
    "duplicates" (some valid keys twice or three times, cats over the whole
    int32 range, so their sums wrap), "negative_cats" (down to INT32_MIN),
    "extreme_keys" (INT32_MIN, INT32_MAX, 0 and -1 as keys; padding rows
    with key INT32_MAX; the last eight probes at and beside them),
    "colliding" (every valid key, and the probes' misses, in one chain of
    K3's table) or "all_invalid"."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(4 * m)[:m_valid].astype(np.int32) + 1
    if zero_key:
        keys[0] = 0                       # a real build row with key 0
    if kind == "duplicates":
        keys[1::3] = keys[0::3][:len(keys[1::3])]
        keys[2::9] = keys[0::9][:len(keys[2::9])]
    elif kind == "extreme_keys":
        keys[:4] = (INT32_MIN, INT32_MAX, 0, -1)
    elif kind == "colliding":
        keys = colliding_keys(m_valid)
    bk = np.zeros(m, np.int32)
    bk[:m_valid] = keys                   # padding rows keep key 0
    if kind == "extreme_keys":
        bk[m_valid:] = INT32_MAX
    bc = np.zeros(m, np.int32)
    bc[:m_valid] = (np.arange(m_valid) * 7) % 1000
    if kind == "duplicates":
        bc[:m_valid] = rng.integers(INT32_MIN, INT32_MAX + 1, m_valid)
    elif kind == "negative_cats":
        bc[:m_valid] = -bc[:m_valid] - 1
        bc[0] = INT32_MIN
    bv = np.zeros(m, np.int32)
    bv[:m_valid] = 1
    if kind == "all_invalid":
        bv[:] = 0
    pk = rng.integers(0, 8 * m, n).astype(np.int32)
    if kind == "colliding":
        misses = colliding_keys(min(n, 4096), first=m_valid)
        pk = misses[rng.integers(0, len(misses), n)]
    hit = rng.random(n) < 0.5
    pk = np.where(hit, bk[rng.integers(0, m_valid, n)], pk).astype(np.int32)
    q = n // 8
    pk[:q] = 0                            # probe zeros against padding
    pk[q: 2 * q] = pk[2 * q: 3 * q]       # duplicate probe keys
    if kind == "extreme_keys":
        pk[-8:] = (INT32_MIN, INT32_MAX, 0, -1, INT32_MIN + 1, INT32_MAX - 1,
                   1, -2)
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


# (seed, N, M, valid rows, a real key 0, G, kind of probe_case)
K3_CASES = {
    "main_path": (0, 1 << 16, 8192, 7692, False, 64, None),
    "gate": (1, 4096, 16384, 16381, True, 64, None),
    "tiny": (2, 100, 8, 3, True, 64, None),
    "duplicates": (3, 1 << 16, 8192, 6000, True, 64, "duplicates"),
    "negative_cats": (4, 1 << 16, 8192, 7000, False, 64, "negative_cats"),
    "extreme_keys": (5, 50001, 4096, 4000, False, 64, "extreme_keys"),
    "colliding": (6, 8192, 2048, 2000, False, 64, "colliding"),
    "all_invalid": (7, 4096, 1024, 1000, False, 64, "all_invalid"),
    "m1": (8, 5000, 1, 1, True, 64, None),
    "n1": (9, 1, 8192, 8000, False, 64, None),
    "g1": (10, 4096, 512, 500, False, 1, None),
    "g7": (11, 4099, 512, 500, True, 7, "negative_cats"),
    "n2p20_at_gate": (12, 1 << 20, 16384, 16000, True, 64, None),
}


def _k3_held_to_plain(args, g):
    grp, wgt = tpart.fused_probe(*args, g)
    r_grp, r_wgt = tref.fused_probe_ref(*args, g)
    torch.cuda.synchronize()
    assert torch.equal(grp, r_grp)
    assert torch.equal(wgt.view(torch.int32), r_wgt.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_CASES))
def test_cuda_k3_matches_plain(cuda_device, case):
    seed, n, m, m_valid, zero_key, g, kind = K3_CASES[case]
    pk, v0, v1, bk, bc, bv, g = probe_case(seed, n, m, m_valid, zero_key, g,
                                           kind)
    _k3_held_to_plain([_t(a).to(cuda_device)
                       for a in (pk, v0, v1, bk, bc, bv)], g)


@pytest.mark.cuda
def test_cuda_k3_reads_unaligned_probe_columns(cuda_device):
    """Probe columns one element into their storage: not 16-byte aligned,
    so K3 reads them a row at a time."""
    pk, v0, v1, bk, bc, bv, g = probe_case(13, 30001, 4096, 4000, True)
    probe = [_t(np.concatenate([a[:1], a])).to(cuda_device)[1:]
             for a in (pk, v0, v1)]
    build = [_t(a).to(cuda_device) for a in (bk, bc, bv)]
    _k3_held_to_plain(probe + build, g)


@pytest.mark.cuda
def test_cuda_k3_makes_no_host_sync(cuda_device):
    """The K3 wrapper neither reads a device value nor waits for the card:
    a call under ``set_sync_debug_mode("error")`` raises on any sync."""
    pk, v0, v1, bk, bc, bv, g = probe_case(14, 4096, 512, 500, False, 7)
    args = [_t(a).to(cuda_device) for a in (pk, v0, v1, bk, bc, bv)]
    tpart.fused_probe(*args, g)           # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grp, wgt = tpart.fused_probe(*args, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    r_grp, r_wgt = tref.fused_probe_ref(*args, g)
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


# -- K1 and K2 at their edges: alignment, skew, the look-back, the scratch --


def _same_grouping(rows, ids, p):
    out, off = tpart.partition_scatter(rows, ids, p)
    r_out, r_off = tref.partition_scatter_ref(rows, ids, p)
    torch.cuda.synchronize()
    assert torch.equal(off, r_off)
    assert out.dtype == r_out.dtype and out.shape == r_out.shape
    assert torch.equal(out.view(torch.uint8), r_out.view(torch.uint8))


def _ids(seed, n, p, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, p, (n,), generator=g, dtype=torch.int32,
                         device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["waves_ragged", "one_bucket", "p1",
                                  "p_max"])
def test_cuda_k2_edges(cuda_device, case):
    """K2 at its edges: 2^23 + 777 rows (tiles in several waves of CTAs and
    many chunks of the first launch, a ragged last tile), every row in one
    bucket (the worst contention), one partition, and the most partitions
    K2 takes (the first launch counts in per-warp bins)."""
    n, p = {"waves_ragged": ((1 << 23) + 777, 9),
            "one_bucket": ((1 << 21) + 5, 9),
            "p1": (100003, 1),
            "p_max": (300007, tpart.MAX_SCATTER_PARTITIONS)}[case]
    ids = _ids(n, n, p, cuda_device)
    if case == "one_bucket":
        ids.fill_(4)
    rows = torch.arange(n, dtype=torch.int32, device=cuda_device)[:, None]
    _same_grouping(rows, ids, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width", [
    (torch.int32, 1), (torch.float32, 3), (torch.int32, 8),
    (torch.int64, 2), (torch.uint8, 3), (torch.float32, 250)],
    ids=["1_word", "3_words", "8_words", "16_bytes", "bytes", "gathered"])
def test_cuda_k2_row_widths(cuda_device, dtype, width):
    """Rows moved 16, 4 or 1 bytes at a time, staged in shared memory or
    copied from global memory in bucket order (1000-byte rows: 256 of them,
    the smallest tile, do not fit a CTA's 227 KB)."""
    n, p = 200003, 13
    g = torch.Generator(device=cuda_device)
    g.manual_seed(width)
    rows = torch.randint(0, 250, (n, width), generator=g,
                         device=cuda_device).to(dtype)
    _same_grouping(rows, _ids(width, n, p, cuda_device), p)


@pytest.mark.cuda
def test_cuda_k2_fifty_calls_on_one_stream(cuda_device):
    """50 calls in a row on one stream, over other sizes and partition
    counts, reuse the stream's scratch: each call leaves K1's accumulator
    and ticket at zero for the next, and rewrites the bases it reads."""
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for i in range(50):
        n, p = 5000 + 7919 * (i % 11), (3, 9, 65, 1)[i % 4]
        ids = _ids(i, n, p, cuda_device)
        rows = torch.arange(n, dtype=torch.int32, device=cuda_device)[:, None]
        results.append((rows, ids, p, tpart.partition_scatter(rows, ids, p)))
    torch.cuda.synchronize()
    for rows, ids, p, (out, off) in results:
        r_out, r_off = tref.partition_scatter_ref(rows, ids, p)
        assert torch.equal(off, r_off) and torch.equal(out, r_out)
    # keyed by the tensors' device (cuda:N)
    counters = tpart._COUNTERS.get(results[0][0].device, stream, 0)
    assert counters.numel() == tpart.MAX_HIST_PARTITIONS + 1
    assert not bool(counters.any())


@pytest.mark.cuda
def test_cuda_k2_two_streams_at_once(cuda_device):
    """Two streams grouping at once, each with its own scratch."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [(torch.arange(1 << 20, dtype=torch.int32,
                            device=cuda_device)[:, None],
               _ids(s, 1 << 20, 9 + 4 * s, cuda_device), 9 + 4 * s)
              for s in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(5):
        for s, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[s].append(tpart.partition_scatter(*inputs[s]))
    torch.cuda.synchronize()
    for scratch in (tpart._COUNTERS, tpart._BASES):
        keys = {k for k in scratch.keys()
                if k[1] in {st.cuda_stream for st in streams}}
        assert len(keys) == 2
    for s in range(2):
        r_out, r_off = tref.partition_scatter_ref(*inputs[s])
        for out, off in got[s]:
            assert torch.equal(off, r_off) and torch.equal(out, r_out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned_view", "one_bin", "p1",
                                  "p_max"])
def test_cuda_k1_edges(cuda_device, case):
    """K1 on a view that starts one id in (not 16-byte aligned, N not a
    multiple of 4), with every id in one bin, and at P = 1 and P =
    MAX_HIST_PARTITIONS."""
    p = {"unaligned_view": 512, "one_bin": 512, "p1": 1,
         "p_max": tpart.MAX_HIST_PARTITIONS}[case]
    base = _ids(p, (1 << 22) + 4, p, cuda_device)
    ids = base[1:-2] if case == "unaligned_view" else base
    if case == "unaligned_view":
        assert ids.data_ptr() % 16 and ids.shape[0] % 4
    if case == "one_bin":
        ids.fill_(p - 1)
    got = tpart.partition_histogram(ids, p)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.partition_histogram_ref(ids, p))


# -- attention kernels (K4, K5) -------------------------------------------------

# the reference's kernel tolerances (tests/test_kernels.py): the kernels keep
# the probabilities in fp32, the plain versions cast them to the value dtype
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(seed, shape, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,hd,causal", [
    (2, 128, 4, 128, True), (1, 77, 3, 128, True), (2, 1, 2, 64, True),
    (1, 200, 2, 64, False), (3, 33, 6, 8, True), (1, 1024, 2, 128, True)])
def test_cuda_k4_matches_plain(cuda_device, dtype, b, s, h, hd, causal):
    from repro_torch.kernels import attention as tattn
    q, k, v = _attn_inputs(s + hd, (b, s, h, hd), dtype, cuda_device)
    got = tattn.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, hd)
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err


@pytest.mark.cuda
def test_cuda_k4_reads_strided_inputs(cuda_device):
    """q, k, v as views of one (B, S, 3, H, hd) projection: no copy."""
    from repro_torch.kernels import attention as tattn
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 70, 3, 4, 64))
                           .astype(np.float32)).to(cuda_device)
    q, k, v = qkv.unbind(2)
    got = tattn.flash_attention(q, k, v)
    want = tref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTN_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,kh,g,hd,lengths", [
    (4, 1024, 8, 3, 128, (1, 1024, 517, 64)), (2, 96, 2, 3, 8, (1, 96)),
    (3, 256, 4, 1, 64, (200, 7, 256)), (1, 130, 2, 2, 128, (129,))])
def test_cuda_k5_matches_plain(cuda_device, dtype, b, s, kh, g, hd, lengths):
    from repro_torch.kernels import attention as tattn
    rng = np.random.default_rng(s + hd)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=cuda_device, dtype=dtype)

    q, kc, vc = t((b, kh * g, hd)), t((b, s, kh, hd)), t((b, s, kh, hd))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    got = tattn.decode_attention(q, kc, vc, length)
    want = tref.decode_attention_ref(q, kc, vc, length)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err


@pytest.mark.cuda
def test_cuda_k5_reads_a_layer_slice_of_the_cache(cuda_device):
    """The cache of one layer is a strided view of the stacked cache."""
    from repro_torch.kernels import attention as tattn
    rng = np.random.default_rng(9)
    cache = torch.from_numpy(rng.standard_normal((2, 3, 2, 80, 2, 64))
                             .astype(np.float32)).to(cuda_device)
    kc, vc = cache[0, 1], cache[1, 1]            # (B, S, K, hd) views
    q = torch.from_numpy(rng.standard_normal((2, 6, 64)).astype(
        np.float32)).to(cuda_device)
    length = torch.tensor([80, 33], dtype=torch.int32, device=cuda_device)
    got = tattn.decode_attention(q, kc, vc, length)
    want = tref.decode_attention_ref(q, kc, vc, length)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTN_TOL[torch.float32]


def _qkv_views(seed, b, s, h, kh, hd, dtype, device):
    """q (B, S, H, hd), k and v (B, S, K, hd) as head slices of one
    (B, S, H + 2K, hd) projection, as a fused qkv matmul gives them: none
    of the three is contiguous."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, s, h + 2 * kh, hd))
                           .astype(np.float32)).to(device=device,
                                                   dtype=dtype)
    return qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 477, 1024])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_k4_tensor_cores_match_plain(cuda_device, hd, s, causal, g):
    """K4's tensor-core route (bf16, hd 64 / 128) on strided q, k, v with
    K = H / G kv heads, at ragged S and at tile edges."""
    from repro_torch.kernels import attention as tattn
    b, kh = 2, 2
    q, k, v = _qkv_views(s * hd + g, b, s, kh * g, kh, hd, torch.bfloat16,
                         cuda_device)
    assert not (q.is_contiguous() or k.is_contiguous())
    tattn.SHAPES["flash_attention"].clear()
    got = tattn.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert [sh[-1] for sh in tattn.SHAPES["flash_attention"]] == ["tc"]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [2, 4, 5, 6])
def test_cuda_k4_tensor_cores_group_query_heads(cuda_device, g, causal):
    """A tensor-core CTA serves up to three query heads of one kv head
    (three when G is a multiple of 3, two when G is even, else one): every
    grouping of G query heads over K = 2 kv heads lands on the right
    heads."""
    from repro_torch.kernels import attention as tattn
    q, k, v = _qkv_views(100 + g, 2, 130, 2 * g, 2, 128, torch.bfloat16,
                         cuda_device)
    got = tattn.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.bfloat16, 32)])
def test_cuda_k4_cuda_core_route_reads_grouped_kv(cuda_device, dtype, hd):
    """fp32 and head dims off the tensor cores take the CUDA-core route,
    with the same GQA read."""
    from repro_torch.kernels import attention as tattn
    q, k, v = _qkv_views(hd, 2, 150, 6, 2, hd, dtype, cuda_device)
    tattn.SHAPES["flash_attention"].clear()
    got = tattn.flash_attention(q, k, v)
    want = tref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert [sh[-1] for sh in tattn.SHAPES["flash_attention"]] == ["simt"]
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]


@pytest.mark.cuda
def test_cuda_k4_refuses_heads_that_do_not_group(cuda_device):
    from repro_torch.kernels import attention as tattn
    q = torch.zeros((1, 4, 5, 64), dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    tattn.reset_launches()
    with pytest.raises(ValueError, match="do not group"):
        tattn.flash_attention(q, kv, kv)
    assert tattn.LAUNCHES["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layer_slice", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [100, 1024])
def test_cuda_k5_split_edges_match_plain(cuda_device, s, dtype,
                                         layer_slice):
    """K5's split and combine at lengths on the chunk edges, 0 (zeros) and
    S, on a contiguous cache and on one layer of a stacked cache."""
    from repro_torch.kernels import attention as tattn
    lengths = (0, 1, 63, 64, 65, s)
    b, kh, g, hd = len(lengths), 8, 3, 128
    rng = np.random.default_rng(s)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=cuda_device, dtype=dtype)

    if layer_slice:   # (k/v, layers, B, S, K, hd), layer 1
        cache = t((2, 3, b, s, kh, hd))
        kc, vc = cache[0, 1], cache[1, 1]
    else:
        kc, vc = t((b, s, kh, hd)), t((b, s, kh, hd))
    q = t((b, kh * g, hd))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    got = tattn.decode_attention(q, kc, vc, length)
    want = tref.decode_attention_ref(q, kc, vc, length)
    again = tattn.decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    assert not bool(got[0].any())
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err
    assert torch.equal(got, again)          # a fixed combine order


# -- the threads invoker: one CUDA stream per worker -------------------------------


def _invocation_seconds(device):
    """Run a heavy and a tiny invocation side by side on the threads
    invoker; the tiny one starts only after the heavy one has enqueued all
    its work. The stage runs twice and the second run is measured, so
    neither side pays the first use of cuBLAS or of a kernel module.
    Returns the measured run's ``{func: compute_seconds}``."""
    import threading

    from repro_torch.analytics.table import Table
    from repro_torch.core.controllers import GlobalController
    from repro_torch.runtime.invoker import Invocation, ThreadPoolInvoker
    from repro_torch.runtime.metrics import MetricsSink
    from repro_torch.runtime.store import ShuffleStore

    enqueued = {}

    def heavy(ctx):
        gen = torch.Generator(device=ctx.device).manual_seed(0)
        a = torch.randn((4096, 4096), generator=gen, device=ctx.device)
        b = torch.randn((4096, 4096), generator=gen, device=ctx.device) / 64
        for _ in range(60):                  # ~8 TFLOP of fp32 products
            a = a @ b
        enqueued[ctx.app].set()
        ctx.put("out", 0, Table({"x": a[0]}))

    def tiny(ctx):
        assert enqueued[ctx.app].wait(30)
        ctx.put("out", 1, Table({"x": torch.ones((4,), device=ctx.device)}))

    sink = MetricsSink()
    invoker = ThreadPoolInvoker(GlobalController({0: 1, 1: 1}),
                                ShuffleStore(), sink, device=device)
    invoker.registry = {"heavy": heavy, "tiny": tiny}
    for app in ("warm", "q"):
        enqueued[app] = threading.Event()
        invoker.run_stage([Invocation(f"{app}/s/0", app, "s", 0, "heavy", 0),
                           Invocation(f"{app}/s/1", app, "s", 1, "tiny", 1)])
    return {r.func: r.compute_seconds for r in sink.for_app("q")}


@pytest.mark.cuda
def test_cuda_threads_invoker_charges_no_other_workers_launches(cuda_device):
    """Each worker thread launches on its own stream, so the tiny
    invocation's wait for its own launches does not include the heavy
    one's matrix products, queued before them."""
    secs = _invocation_seconds(cuda_device)
    assert secs["heavy"] > 0.02, secs
    assert secs["tiny"] < 0.25 * secs["heavy"], secs


# -- the serving path at the smoke config -------------------------------------------


def _serve_smoke(device, model, cfg):
    from repro_torch.serving import Request, ServingEngine
    engine = ServingEngine(cfg, model, max_batch=2, max_seq=40,
                           slo_ms=1e9, device=device)
    rng = np.random.default_rng(0)
    for i in range(3):
        engine.submit(Request(i, rng.integers(0, cfg.vocab_size,
                                              5 + 4 * i).tolist(),
                              max_new_tokens=4))
    done = engine.run(max_steps=64)
    return {r.req_id: r.output for r in done}, engine.metrics


@pytest.mark.cuda
def test_cuda_engine_serves_through_k4_and_k5(cuda_device):
    """The smoke config in fp32 on the card gives the CPU engine's tokens,
    with one K4 launch per layer per prefill and one K5 launch per layer
    per decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as tattn
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              dtype="float32")
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    want, _ = _serve_smoke("cpu", model, cfg)
    tattn.reset_launches()
    got, metrics = _serve_smoke(cuda_device, model.to(cuda_device), cfg)
    assert got == want and len(got) == 3
    assert tattn.LAUNCHES == {
        "flash_attention": cfg.num_layers * metrics["prefills"],
        "flash_attention_bwd": 0,
        "decode_attention": cfg.num_layers * metrics["steps"]}


@pytest.mark.cuda
def test_cuda_threads_invoker_gives_each_of_40_workers_its_own_stream(
        cuda_device):
    """40 invocations that all run at once (each waits at a barrier for the
    other 39) see 40 distinct current streams. PyTorch's pool holds 32
    streams a priority, so handing those out would repeat one."""
    import threading

    from repro_torch.core.controllers import GlobalController
    from repro_torch.runtime.invoker import Invocation, ThreadPoolInvoker
    from repro_torch.runtime.metrics import MetricsSink
    from repro_torch.runtime.store import ShuffleStore

    n = 40
    barrier = threading.Barrier(n, timeout=60)
    seen = {}

    def probe(ctx):
        seen[ctx.index] = torch.cuda.current_stream(ctx.device).cuda_stream
        barrier.wait()

    invoker = ThreadPoolInvoker(GlobalController({0: n}), ShuffleStore(),
                                MetricsSink(), max_workers=n, batching=False,
                                device=cuda_device)
    invoker.registry = {"probe": probe}
    invoker.run_stage([Invocation(f"s/p/{i}", "s", "p", i, "probe", 0)
                       for i in range(n)])
    assert len(seen) == n
    assert len(set(seen.values())) == n, sorted(seen.values())
    # made non-blocking (cudaStreamNonBlocking), as PyTorch's pooled
    # streams are
    import ctypes

    from repro_torch.kernels.streams import _cudart
    flags = ctypes.c_uint()
    for handle in seen.values():
        assert _cudart().cudaStreamGetFlags(ctypes.c_void_p(handle),
                                            ctypes.byref(flags)) == 0
        assert flags.value == 1, handle
    assert torch.cuda.current_stream(cuda_device).cuda_stream \
        not in seen.values()


# -- the process worker plane and the simulator plane on the card ------------------


@pytest.mark.cuda
def test_cuda_process_backend_query_launches_k1_k2_in_workers(cuda_device):
    """A 2^18-row query on the process backend: each worker opens its own
    CUDA context and runs the shuffle's K1 and K2 there; the result equals
    the oracle and the host's own launch counters stay where they were."""
    from repro_torch.analytics.query import (QueryStrategy,
                                             execute_query_runtime,
                                             synth_query_tables)
    from repro_torch.core.controllers import GlobalController
    from repro_torch.runtime import Runtime

    fd, dd, ref = synth_query_tables(1 << 18, 1 << 14, seed=5,
                                     device=cuda_device)
    gc = GlobalController({n: 8 for n in range(4)})
    rt = Runtime(gc, invoker="process", max_workers=2, device=cuda_device)
    host = dict(tpart.LAUNCHES)
    try:
        got, _ = execute_query_runtime(fd, dd, QueryStrategy("static_merge"),
                                       runtime=rt, pipeline=True)
    finally:
        rt.invoker.shutdown()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-2)
    assert rt.invoker.worker_launches["partition_histogram"] > 0
    assert rt.invoker.worker_launches["partition_scatter"] > 0
    assert tpart.LAUNCHES == host
    assert sum(gc.used.values()) == 0


@pytest.mark.cuda
def test_cuda_shuffle_skew_feedback_matches_cpu(cuda_device):
    """The simulator's skew feedback on the card (its sketch through K1)
    equals the CPU's, histogram, bytes and hot keys."""
    from repro_torch.analytics.planner import shuffle_skew_feedback
    from repro_torch.analytics.query import synth_query_tables

    fd, _, _ = synth_query_tables(1 << 18, 1 << 12, zipf=1.5, seed=3,
                                  device="cpu")
    want = shuffle_skew_feedback(fd, 8, device="cpu")
    before = tpart.LAUNCHES["partition_histogram"]
    got = shuffle_skew_feedback(fd, 8, device=cuda_device)
    assert got == want and sum(want[0]) > 0 and want[2]
    assert tpart.LAUNCHES["partition_histogram"] > before


# -- the MoE dispatch on K2 -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,e,k,cap", [
    (4, 1024, 32, 8, 320),     # granite's prefill wave at max_seq 1024
    (4, 1, 32, 8, 4),          # granite's decode step
    (4, 300, 32, 8, 16),       # most assignments dropped
    (2, 77, 1000, 4, 12)])     # one row a K2 call
def test_cuda_moe_dispatch_on_k2_matches_plain(cuda_device, b, s, e, k, cap):
    """The dispatch bookkeeping through K2 is bit-exact against the
    per-row stable argsort, with one K2 launch a group of rows."""
    from repro_torch.models import moe as tmoe
    scores = torch.randn((b, s, e), device=cuda_device)
    top_i = torch.topk(scores, k, dim=-1).indices
    before = tpart.LAUNCHES["partition_scatter"]
    got = tmoe.dispatch(top_i, e, cap)
    per_call = (tpart.MAX_SCATTER_PARTITIONS - 1) // e
    assert tpart.LAUNCHES["partition_scatter"] - before == -(-b // per_call)
    want = tmoe.dispatch_plain(top_i, cap)
    for name, g, w in zip(tmoe.Dispatch._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
def test_cuda_engine_serves_granite_through_k2(cuda_device):
    """Granite's smoke config in fp32 on the card gives the CPU engine's
    tokens, with one K2 launch per MoE layer per prefill and per decode
    step, beside K4's and K5's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as tattn
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype="float32")
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    want, _ = _serve_smoke("cpu", model, cfg)
    tattn.reset_launches()
    tpart.reset_launches()
    got, metrics = _serve_smoke(cuda_device, model.to(cuda_device), cfg)
    assert got == want and len(got) == 3
    calls = metrics["prefills"] + metrics["steps"]
    assert tpart.LAUNCHES["partition_scatter"] == cfg.num_layers * calls
    assert tattn.LAUNCHES == {
        "flash_attention": cfg.num_layers * metrics["prefills"],
        "flash_attention_bwd": 0,
        "decode_attention": cfg.num_layers * metrics["steps"]}


# -- the recurrent models at the smoke config ------------------------------------

RECURRENT = ("jamba-v0.1-52b", "xlstm-1.3b")


def _fp32_smoke(arch, drop_free=False):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if drop_free and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_cuda_engine_serves_recurrent_models(cuda_device, arch):
    """jamba's and xlstm's smoke configs in fp32 on the card give the CPU
    engine's tokens, with K4 once an attention layer a prefill, K5 once an
    attention layer a decode step and K2 once a MoE layer in both: xlstm
    launches none of them."""
    from repro_torch.kernels import attention as tattn
    from repro_torch.models import init_lm

    cfg = _fp32_smoke(arch)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    want, _ = _serve_smoke("cpu", model, cfg)
    tattn.reset_launches()
    tpart.reset_launches()
    got, metrics = _serve_smoke(cuda_device, model.to(cuda_device), cfg)
    assert got == want and len(got) == 3
    attn = sum(cfg.block_kind(i).value == "attention"
               for i in range(cfg.num_layers))
    moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    assert (attn, moe) == ((2, 2) if arch == RECURRENT[0] else (0, 0))
    assert tattn.LAUNCHES == {
        "flash_attention": attn * metrics["prefills"],
        "flash_attention_bwd": 0,
        "decode_attention": attn * metrics["steps"]}
    assert tpart.LAUNCHES == {
        "partition_histogram": 0, "fused_probe": 0,
        "partition_scatter": moe * (metrics["prefills"] + metrics["steps"])}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_cuda_recurrent_prefill_then_decode_matches_forward(cuda_device,
                                                            arch):
    """On the card, a 12-token prefill and four teacher-forced decode steps
    give the logits of one forward over the 16 tokens (fp32, jamba's MoE
    drop-free)."""
    from repro_torch.models import (
        decode_step,
        forward,
        init_decode_state,
        init_lm,
        prefill_step,
    )

    cfg = _fp32_smoke(arch, drop_free=True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = init_lm(cfg, gen, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    want, _ = forward(model, {"tokens": toks}, ssm_chunk=16)
    st = init_decode_state(cfg, 2, 32, cuda_device)
    lg, st = prefill_step(model, st, {"tokens": toks[:, :12]}, ssm_chunk=12)
    got = [lg]
    for t in range(12, 16):
        lg, st = decode_step(model, st, toks[:, t:t + 1])
        got.append(lg)
    got = torch.cat(got, dim=1)[..., :cfg.vocab_size]
    torch.testing.assert_close(got, want[:, 11:, :cfg.vocab_size],
                               atol=1e-3, rtol=1e-3)


# -- K4b (K4's gradient) and training --------------------------------------------

# K4b against its plain version: max |err| over the plain gradient's largest
# magnitude (bf16 outputs round to 2^-8 of it; fp32 sums differ in order)
K4B_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _k4b_inputs(seed, b, s, h, kh, hd, dtype, device, causal):
    """Strided q, k, v (``_qkv_views``), a random d_out and the plain
    forward's output."""
    q, k, v = _qkv_views(seed, b, s, h, kh, hd, dtype, device)
    rng = np.random.default_rng(seed + 1)
    d_out = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).to(device=device, dtype=dtype)
    return q, k, v, tref.flash_attention_ref(q, k, v, causal=causal), d_out


def _grads_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= K4B_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("s", [64, 200, 1024])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
def test_cuda_k4b_matches_plain(cuda_device, hd, s, g, causal, dtype):
    """K4b on strided q, k, v with K = 2 kv heads of G query heads each,
    at a tile, a ragged S and S = 1024, against its plain version."""
    from repro_torch.kernels import attention as tattn
    args = _k4b_inputs(hd * s + g, 1, s, 2 * g, 2, hd, dtype, cuda_device,
                       causal)
    tattn.SHAPES["flash_attention_bwd"].clear()
    got = tattn.flash_attention_bwd(*args, causal=causal)
    want = tref.flash_attention_bwd_ref(*args, causal=causal)
    torch.cuda.synchronize()
    route = "tc" if dtype == torch.bfloat16 and hd in (64, 128) else "simt"
    assert tattn.SHAPES["flash_attention_bwd"] == {
        (1, s, 2 * g, 2, hd, str(dtype), causal, route)}
    _grads_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k4b_is_the_gradient_of_k4(cuda_device, dtype):
    """On CUDA tensors that ask for a gradient, ``flash_attention``'s
    backward is K4b (one launch beside K4's one), and its gradients are
    autograd's of the plain forward on the CPU."""
    from repro_torch.kernels import attention as tattn
    rng = np.random.default_rng(3)
    b, s, h, kh, hd = 2, 130, 6, 2, 128
    host = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]
    w = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32))

    def grads(device):
        qkv = [torch.from_numpy(a).to(device=device, dtype=dtype)
               .requires_grad_(True) for a in host]
        out = tattn.flash_attention(*qkv)
        (out.float() * w.to(device)).sum().backward()
        return [t.grad for t in qkv]

    want = [g.to(cuda_device) for g in grads("cpu")]
    tattn.reset_launches()
    got = grads(cuda_device)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 1,
                              "decode_attention": 0}
    _grads_close(got, want, dtype)


@pytest.mark.cuda
def test_cuda_k4b_launch_failure_raises(cuda_device):
    """A K4b launch that fails raises from the backward (no fall back to the
    plain version), and the C entry point refuses an unknown dtype."""
    from repro_torch.kernels import attention as tattn
    entry = tattn._fn("flash_attention_bwd", "fab_flash_attention_bwd")
    err = entry(*([None] * 9), 1, 64, 2, 2, 64, *([0] * 9), 1, 7, None, None,
                None)
    assert err != 0
    q = torch.randn((1, 64, 2, 64), device=cuda_device, requires_grad=True)
    out = tattn.flash_attention(q, q.detach(), q.detach())
    bound = tattn._BOUND["flash_attention_bwd"]
    bound["fab_flash_attention_bwd"] = lambda *args: err
    try:
        with pytest.raises(RuntimeError, match="flash_attention_bwd kernel "
                                               "failed"):
            out.sum().backward()
    finally:
        bound["fab_flash_attention_bwd"] = entry


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 200, 1024])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_k4b_tensor_cores_match_plain(cuda_device, hd, g, s, causal):
    """K4b's tensor-core route (bf16, hd 64 / 128) as the autograd backward
    calls it, with the log-sum-exp K4 wrote beside its output, on strided
    q, k, v with K = 2 kv heads of G query heads each, at a tile, a ragged
    S and S = 1024, against its plain version."""
    from repro_torch.kernels import attention as tattn
    q, k, v = _qkv_views(hd + 10 * s + g, 2, s, 2 * g, 2, hd, torch.bfloat16,
                         cuda_device)
    rng = np.random.default_rng(s + g)
    d_out = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(device=cuda_device, dtype=torch.bfloat16)
    out, lse = tattn.flash_attention_with_lse(q, k, v, causal)
    tattn.SHAPES["flash_attention_bwd"].clear()
    got = tattn.flash_attention_bwd(q, k, v, out, d_out, causal, lse)
    want = tref.flash_attention_bwd_ref(q, k, v, out, d_out, causal)
    torch.cuda.synchronize()
    assert [sh[-1] for sh in tattn.SHAPES["flash_attention_bwd"]] == ["tc"]
    _grads_close(got, want, torch.bfloat16)


# K4's lse against the plain log-sum-exp: both in fp32 from the same
# inputs, sums in another order and exp2 / log2 on the card (values near
# log S, so 1e-4 is some 100 ulp)
LSE_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 200])
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.float32, 128, "simt"), (torch.bfloat16, 32, "simt")])
def test_cuda_k4_writes_lse_on_both_routes(cuda_device, dtype, hd, route, s,
                                           causal):
    """Asked for it, each of K4's routes writes every row's log-sum-exp,
    equal to ``flash_attention_lse_ref``'s, and its output is bit-equal to
    the output of the call that writes none (serving's)."""
    from repro_torch.kernels import attention as tattn
    q, k, v = _qkv_views(hd + s, 2, s, 6, 2, hd, dtype, cuda_device)
    tattn.SHAPES["flash_attention"].clear()
    out, lse = tattn.flash_attention_with_lse(q, k, v, causal)
    plain_out = tattn.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_lse_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert {sh[-1] for sh in tattn.SHAPES["flash_attention"]} == {route}
    assert lse.dtype == torch.float32 and lse.shape == (2, 6, s)
    assert float((lse - want).abs().max()) <= LSE_TOL
    assert torch.equal(out, plain_out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 64)])
def test_cuda_k4b_gives_the_same_bits_run_to_run(cuda_device, dtype, hd):
    """K4b writes each gradient element once, with no atomics: two calls on
    the same inputs give bit-equal dq, dk and dv."""
    from repro_torch.kernels import attention as tattn
    q, k, v, _, d_out = _k4b_inputs(7, 2, 333, 6, 2, hd, dtype, cuda_device,
                                    True)
    out, lse = tattn.flash_attention_with_lse(q, k, v, True)
    first = tattn.flash_attention_bwd(q, k, v, out, d_out, True, lse)
    second = tattn.flash_attention_bwd(q, k, v, out, d_out, True, lse)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, b in zip(first, second):
        assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shape", "dtype", "device"])
def test_cuda_k4b_refuses_a_bad_lse(cuda_device, case):
    """An lse of the wrong shape, dtype or device raises before any
    launch."""
    from repro_torch.kernels import attention as tattn
    q, k, v, out, d_out = _k4b_inputs(8, 1, 64, 4, 2, 64, torch.bfloat16,
                                      cuda_device, True)
    lse = {"shape": torch.zeros((1, 64, 4), device=cuda_device),
           "dtype": torch.zeros((1, 4, 64), device=cuda_device,
                                dtype=torch.bfloat16),
           "device": torch.zeros((1, 4, 64))}[case]
    tattn.reset_launches()
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_attention_bwd(q, k, v, out, d_out, True, lse)
    assert tattn.LAUNCHES["flash_attention_bwd"] == 0


TRAIN_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
               "xlstm-1.3b", "internvl2-1b", "musicgen-medium")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """One train step of each family's smoke config in fp32 on the card
    (K4 twice an attention layer under ``remat="block"``, K4b once, K2
    twice a MoE layer) gives the CPU's gradients, loss and parameters."""
    import copy

    from repro_torch.core.config import (
        OptimizerConfig,
        ParallelConfig,
        ShapeConfig,
    )
    from repro_torch.data import SyntheticSource
    from repro_torch.kernels import attention as tattn
    from repro_torch.models import init_lm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.train_step import make_grad_fn

    cfg = _fp32_smoke(arch, drop_free=True)
    shape = ShapeConfig("t", 32, 2, "train")
    batch = SyntheticSource(cfg, shape, seed=0).batch(0)
    pc = ParallelConfig(remat="block")
    cpu = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    states = [init_train_state(cfg, m) for m in (cpu, card)]
    grad_fn = make_grad_fn(cfg, pc, ssm_chunk=8)
    loss_cpu, _, g_cpu = grad_fn(cpu, batch)
    tattn.reset_launches()
    tpart.reset_launches()
    loss_card, _, g_card = grad_fn(card, batch)
    torch.cuda.synchronize()
    attn = sum(cfg.block_kind(i).value == "attention"
               for i in range(cfg.num_layers))
    moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    assert tattn.LAUNCHES == {"flash_attention": 2 * attn,
                              "flash_attention_bwd": attn,
                              "decode_attention": 0}
    assert tpart.LAUNCHES["partition_scatter"] == 2 * moe
    assert float(loss_card) == pytest.approx(float(loss_cpu), rel=1e-5)
    for name, g in g_cpu.items():
        d = float((g_card[name].cpu() - g).norm() / g.norm())
        assert d <= 1e-4, (name, d)
    step = make_train_step(cfg, shape, OptimizerConfig(), pc, ssm_chunk=8)
    metrics = [step(st, batch)[1] for st in states]
    assert float(metrics[1]["loss"]) == pytest.approx(
        float(metrics[0]["loss"]), rel=1e-5)
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        np.testing.assert_allclose(q.detach().cpu().numpy(),
                                   p.detach().numpy(), atol=5e-3,
                                   err_msg=name)
