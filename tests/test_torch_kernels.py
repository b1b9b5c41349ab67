"""Partition kernels of the PyTorch port against the JAX reference.

The same seeded numpy inputs go through the reference (Pallas in interpret
mode where it still runs, its jnp reference and dispatch otherwise) and the
port's plain PyTorch versions, which are what the port's kernel wrappers
run for CPU tensors. Integers and float outputs are compared bit-exact.
The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import partition as jpart
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import partition as tpart
from repro_torch.kernels import streams as tstreams
from test_torch_cuda import INT32_MAX, INT32_MIN, probe_case


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _grouping_oracle(pids: np.ndarray, p: int):
    order = np.argsort(pids, kind="stable")
    counts = np.bincount(pids, minlength=p)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return order.astype(np.int32), offsets


# -- K1: histogram ----------------------------------------------------------------


@pytest.mark.parametrize("n,p,block", [(1024, 4, 256), (2048, 16, 512),
                                       (4096, 512, 1024), (3072, 65, 1024)])
def test_k1_plain_matches_pallas_and_bincount(n, p, block):
    pids = np.random.default_rng(n + p).integers(0, p, n).astype(np.int32)
    pallas = np.asarray(jnp.sum(jpart.partition_histogram(
        jnp.asarray(pids), p, block=block, interpret=True), axis=0))
    got = tpart.partition_histogram(_t(pids), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), pallas)
    np.testing.assert_array_equal(_np(got), np.bincount(pids, minlength=p))


@pytest.mark.parametrize("n,p", [(0, 4), (256, 1), (128, 8), (384, 6),
                                 (1000, 512)])
def test_k1_dispatch_matches_reference_dispatch(n, p):
    rng = np.random.default_rng(n + p)
    pids = rng.integers(0, p, size=n).astype(np.int32)
    if n and p == 8:
        pids[:] = 3                       # all rows in one bucket
    got = tops.partition_histogram(_t(pids), p)
    want = np.asarray(jops.partition_histogram(jnp.asarray(pids), p,
                                               force_kernel=False))
    assert got.dtype == torch.int32 and got.shape == (p,)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), np.bincount(pids, minlength=p))


# -- K2: stable scatter -----------------------------------------------------------


@pytest.mark.parametrize("n,p,d", [(0, 4, 3), (128, 1, 2), (256, 8, 2),
                                   (320, 5, 4), (3000, 65, 1)])
def test_k2_plain_matches_ref_and_numpy(n, p, d):
    rng = np.random.default_rng(n + p + d)
    pids = rng.integers(0, p, size=n).astype(np.int32)
    if n == 256:
        pids[:] = 7                       # all rows in one bucket
    rows = rng.standard_normal((n, d)).astype(np.float32)
    got, off = tops.partition_scatter(_t(rows), _t(pids), p)
    order = np.argsort(pids, kind="stable")
    counts = np.bincount(pids, minlength=p)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(_np(off), offsets)
    np.testing.assert_array_equal(_bits(_np(got)), _bits(rows[order]))
    if n:
        r_out, r_off = jref.partition_scatter_ref(jnp.asarray(rows),
                                                  jnp.asarray(pids), p)
        np.testing.assert_array_equal(_np(off), np.asarray(r_off))
        np.testing.assert_array_equal(_bits(_np(got)),
                                      _bits(np.asarray(r_out)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("p", [2, 8, 32])
def test_k2_is_stable_grouping(seed, p):
    """Output is a permutation, grouped by pid, original order within."""
    n = 512
    pids = np.random.default_rng(seed).integers(0, p, n).astype(np.int32)
    rows = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, 2)
    out, offsets = tpart.partition_scatter(rows, _t(pids), p)
    out_ids = _np(out[:, 0])
    assert sorted(out_ids) == list(range(n))
    np.testing.assert_array_equal(out_ids, _np(out[:, 1]))
    for part in range(p):
        lo = int(offsets[part])
        seg = out_ids[lo: lo + int((pids == part).sum())]
        np.testing.assert_array_equal(seg, np.nonzero(pids == part)[0])


@pytest.mark.parametrize("case", ["empty", "single_bucket",
                                  "all_rows_one_bucket", "non_pow2_buckets",
                                  "ragged_pad"])
def test_grouping_indices_matches_reference(case):
    if case == "empty":
        pids, p = np.zeros((0,), np.int32), 4
    elif case == "single_bucket":
        pids, p = np.zeros((96,), np.int32), 1
    elif case == "all_rows_one_bucket":
        pids, p = np.full((128,), 2, np.int32), 8
    elif case == "non_pow2_buckets":
        pids = np.random.default_rng(5).integers(0, 7, 200).astype(np.int32)
        p = 7
    else:
        pids = np.random.default_rng(6).integers(0, 64, 1500).astype(
            np.int32)
        p = 64
    order, offsets = tops.grouping_indices(_t(pids), p)
    j_order, j_off = jops.grouping_indices(jnp.asarray(pids), p,
                                           force_kernel=False)
    o_order, o_off = _grouping_oracle(pids, p)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    np.testing.assert_array_equal(_np(order), np.asarray(j_order))
    np.testing.assert_array_equal(_np(offsets), np.asarray(j_off))
    np.testing.assert_array_equal(_np(order), o_order)
    np.testing.assert_array_equal(_np(offsets), o_off)


def test_padding_and_shape_class_accounting_match_reference():
    tops.reset_padding_counters()
    jops.reset_padding_counters()
    for n in (5, 100, 1000, 1025):
        pids = np.random.default_rng(n).integers(0, 4, n).astype(np.int32)
        tops.grouping_indices(_t(pids), 4)
        jops.grouping_indices(jnp.asarray(pids), 4)
        assert tops._pad_len(n) == jops._pad_len(n)
    assert tops.padding_counters() == jops.padding_counters()
    assert {(8, 4), (128, 4), (1024, 4), (2048, 4)} <= tops._SHAPE_CLASSES
    for total, salt in ((0, 3), (10, 3), (1000, 7), (4097, 4)):
        assert tops.salted_ranges(total, salt) == \
            jops.salted_ranges(total, salt)


# -- K3: fused probe --------------------------------------------------------------


@pytest.mark.parametrize("seed,n,m,m_valid,zero_key", [
    (0, 256, 64, 64, False), (1, 512, 128, 100, False),
    (2, 512, 128, 100, True), (3, 1024, 1024, 1000, True),
    (4, 128, 8, 1, False)])
def test_k3_plain_matches_pallas_and_sorted_path(seed, n, m, m_valid,
                                                 zero_key):
    pk, v0, v1, bk, bc, bv, g = probe_case(seed, n, m, m_valid, zero_key)
    grp, wgt = tpart.fused_probe(*map(_t, (pk, v0, v1, bk, bc, bv)), g)
    assert grp.dtype == torch.int32 and wgt.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in (pk, v0, v1, bk, bc, bv)]
    p_grp, p_wgt = jpart.fused_probe(*jargs, g, interpret=True)
    s_grp, s_wgt = jops._fused_probe_padded(*jargs, g)
    for want_g, want_w in ((p_grp, p_wgt), (s_grp, s_wgt)):
        np.testing.assert_array_equal(_np(grp), np.asarray(want_g))
        np.testing.assert_array_equal(_bits(_np(wgt)),
                                      _bits(np.asarray(want_w)))
    t_grp, t_wgt = tops._fused_probe_padded(*map(_t, (pk, v0, v1, bk, bc,
                                                      bv)), g)
    np.testing.assert_array_equal(_np(t_grp), _np(grp))
    np.testing.assert_array_equal(_bits(_np(t_wgt)), _bits(_np(wgt)))


def _probe_oracle(pk, v0, v1, bk, bc, bv, g):
    """numpy: the int32-wrapped sum of the matching valid rows' cats as a
    floor mod of G, and v0 * v1 where one matched."""
    match = (pk[:, None] == bk[None, :]) & (bv[None, :] != 0)
    cat = (match * bc[None, :].astype(np.int64)).sum(axis=1)
    cat = (cat + 2**31) % 2**32 - 2**31
    return (np.mod(cat, g).astype(np.int32),
            np.where(match.any(axis=1), v0 * v1, np.float32(0.0)))


# (seed, N, M, valid rows, a real key 0, G, kind of probe_case): the card
# tests' edges at sizes the Pallas kernel runs in interpret mode
K3_EDGES = {
    "negative_cats": (20, 512, 256, 200, False, 64, "negative_cats"),
    "duplicates": (21, 512, 256, 200, True, 64, "duplicates"),
    "extreme_keys": (22, 512, 256, 200, False, 64, "extreme_keys"),
    "colliding": (23, 512, 256, 200, False, 64, "colliding"),
    "all_invalid": (24, 256, 64, 60, True, 64, "all_invalid"),
    "g1": (25, 512, 256, 200, True, 1, None),
    "g7": (26, 512, 256, 200, True, 7, "negative_cats"),
    "g7_duplicates": (27, 512, 256, 200, False, 7, "duplicates"),
    "m1": (28, 384, 1, 1, True, 64, None),
    "n1": (29, 1, 256, 200, False, 64, None),
}


@pytest.mark.parametrize("case", list(K3_EDGES))
def test_k3_edges_match_pallas_and_numpy(case):
    """The plain version (what K3 is held to on the card) against the
    Pallas kernel in interpret mode and a numpy oracle, at the edges of
    the contract: negative cats (a floor mod), duplicate valid keys (their
    cats summed, wrapping), extreme keys, G = 1 and 7."""
    seed, n, m, m_valid, zero_key, g, kind = K3_EDGES[case]
    args = probe_case(seed, n, m, m_valid, zero_key, g, kind)[:6]
    grp, wgt = tpart.fused_probe(*map(_t, args), g)
    p_grp, p_wgt = jpart.fused_probe(*map(jnp.asarray, args), g,
                                     interpret=True)
    o_grp, o_wgt = _probe_oracle(*args, g)
    for want_g, want_w in ((p_grp, p_wgt), (o_grp, o_wgt)):
        np.testing.assert_array_equal(_np(grp), np.asarray(want_g))
        np.testing.assert_array_equal(_bits(_np(wgt)),
                                      _bits(np.asarray(want_w)))


def test_k3_edge_cases_reach_their_edges():
    """The edge inputs hold what they are named for."""
    _, _, _, bk, bc, bv, _ = probe_case(*K3_EDGES["duplicates"])
    keys, counts = np.unique(bk[bv != 0], return_counts=True)
    assert counts.max() == 3 and (counts == 2).sum() > 10
    assert bc.min() < 0 and bc.max() > 2**30
    _, _, _, bk, bc, bv, _ = probe_case(*K3_EDGES["negative_cats"])
    assert bc[0] == INT32_MIN and (bc[bv != 0] < 0).all()
    pk, _, _, bk, _, bv, _ = probe_case(*K3_EDGES["extreme_keys"])
    assert {INT32_MIN, INT32_MAX, 0, -1} <= set(bk[bv != 0].tolist())
    assert {INT32_MIN, INT32_MAX, 0, -1} <= set(pk.tolist())
    pk, _, _, bk, _, bv, _ = probe_case(*K3_EDGES["colliding"])

    def top16(keys):      # the top 16 bits of the hash's product
        return ((keys.astype(np.uint32).astype(np.uint64)
                 * tpart.FUSED_HASH_MULT) % 2**32) >> 16

    assert (top16(bk[bv != 0]) == 0xFFFF).all()
    miss = pk[~np.isin(pk, bk)]
    assert len(miss) > 100 and (top16(miss) == 0xFFFF).all()


@pytest.mark.parametrize("n,m", [(300, 200), (64, 5), (40, 20000)])
def test_fused_probe_groups_matches_reference(n, m):
    """Both dispatch paths: K3 below the shared-memory gate, the sorted
    search above it (m = 20000 pads past FUSED_SMEM_ROWS), with the
    padding counted as the reference counts it."""
    rng = np.random.default_rng(n * m)
    bk = rng.permutation(3 * m)[:m].astype(np.int32)
    bc = (np.arange(m) % 50).astype(np.int32)
    pk = rng.integers(0, 3 * m, n).astype(np.int32)
    v0 = rng.standard_normal(n).astype(np.float32)
    v1 = rng.standard_normal(n).astype(np.float32)
    tops.reset_padding_counters()
    jops.reset_padding_counters()
    grp, wgt = tops.fused_probe_groups(*map(_t, (pk, v0, v1, bk, bc)), 64)
    j_grp, j_wgt = jops.fused_probe_groups(pk, v0, v1, bk, bc, 64)
    np.testing.assert_array_equal(_np(grp), j_grp)
    np.testing.assert_array_equal(_bits(_np(wgt)), _bits(j_wgt))
    assert tops.padding_counters() == jops.padding_counters()


@pytest.mark.parametrize("n,m,path", [(300, 200, "kernel"),
                                      (5000, 3000, "kernel"),
                                      (40, 20000, "sorted")])
def test_fused_probe_groups_gives_k3_the_real_rows(monkeypatch, n, m, path):
    """K3 gets the unpadded sides (the shape classes are only counted);
    negative cats come out as the reference's floor mod on both paths."""
    rng = np.random.default_rng(n + m)
    bk = rng.permutation(3 * m)[:m].astype(np.int32)
    bc = (rng.integers(-1000, 1000, m)).astype(np.int32)
    pk = rng.integers(0, 3 * m, n).astype(np.int32)
    v0 = rng.standard_normal(n).astype(np.float32)
    v1 = rng.standard_normal(n).astype(np.float32)
    seen, real = [], tpart.fused_probe

    def probe(*args):
        seen.append(tuple(int(a.shape[0]) for a in args[:6]))
        return real(*args)

    monkeypatch.setattr(tops._k, "fused_probe", probe)
    grp, wgt = tops.fused_probe_groups(*map(_t, (pk, v0, v1, bk, bc)), 7)
    j_grp, j_wgt = jops.fused_probe_groups(pk, v0, v1, bk, bc, 7)
    np.testing.assert_array_equal(_np(grp), j_grp)
    np.testing.assert_array_equal(_bits(_np(wgt)), _bits(j_wgt))
    assert seen == ([(n, n, n, m, m, m)] if path == "kernel" else [])


def test_fused_gate_is_derived_from_shared_memory():
    assert tops.FUSED_SMEM_ROWS == 16384
    assert tops.FUSED_SMEM_ROWS * tpart.FUSED_ROW_BYTES \
        <= tpart.SMEM_PER_BLOCK < 2 * tops.FUSED_SMEM_ROWS \
        * tpart.FUSED_ROW_BYTES


# -- hash, sketch, joins, aggregation ---------------------------------------------


def _hash_keys():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1,
                     65535, 65536, -65536, 0x7FFF0000, -0x7FFF0001],
                    np.int64)
    rand = rng.integers(-2**31, 2**31, 4000)
    return np.concatenate([edge, rand]).astype(np.int32)


@pytest.mark.parametrize("p", list(range(1, 65)) + [512])
def test_partition_ids_bit_identical(p):
    keys = _hash_keys()
    got = tops.partition_ids(_t(keys), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), np.asarray(jops.partition_ids(jnp.asarray(keys), p)))


@pytest.mark.parametrize("p", [1, 7, 64])
def test_partition_permutation_matches_reference(p):
    keys = _hash_keys()
    got = tops.partition_permutation(_t(keys), p)
    want = jops.partition_permutation(jnp.asarray(keys), p)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("bits", [1, 5, 9, 16, 24, 31])
def test_hash_bit_identical(bits):
    keys = _hash_keys()
    np.testing.assert_array_equal(
        _np(tops._hash(_t(keys), bits)),
        np.asarray(jops._hash(jnp.asarray(keys), bits)))


@pytest.mark.parametrize("case", ["uniform", "zipf", "hot", "one_key",
                                  "empty"])
def test_heavy_hitter_sketch_equal(case):
    rng = np.random.default_rng(11)
    if case == "uniform":
        keys = rng.integers(0, 5000, 3000)
    elif case == "zipf":
        keys = rng.zipf(1.5, 3000) % 10000
    elif case == "hot":
        keys = np.where(rng.random(3000) < 0.5, rng.integers(0, 3, 3000),
                        rng.integers(0, 2**31 - 1, 3000))
    elif case == "one_key":
        keys = np.full(500, -7)
    else:
        keys = np.zeros(0)
    keys = keys.astype(np.int32)
    assert tops.heavy_hitter_sketch(_t(keys)) == \
        jops.heavy_hitter_sketch(jnp.asarray(keys))


@pytest.mark.parametrize("nb,n", [(50, 400), (700, 3000), (1, 10)])
def test_joins_bit_identical(nb, n):
    rng = np.random.default_rng(nb)
    bk = rng.permutation(4 * nb)[:nb].astype(np.int32)
    pk = rng.integers(0, 4 * nb, n).astype(np.int32)
    slots = tops.build_hash_table(_t(bk))
    j_slots = jops.build_hash_table(jnp.asarray(bk))
    np.testing.assert_array_equal(_np(slots), np.asarray(j_slots))
    for got, want in (
            (tops.hash_join_indices(_t(pk), _t(bk), slots),
             jops.hash_join_indices(jnp.asarray(pk), jnp.asarray(bk),
                                    j_slots)),
            (tops.sort_merge_join_indices(_t(pk), _t(bk)),
             jops.sort_merge_join_indices(jnp.asarray(pk),
                                          jnp.asarray(bk)))):
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_segment_sum_close_to_reference():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(5000).astype(np.float32)
    ids = rng.integers(0, 64, 5000).astype(np.int32)
    np.testing.assert_allclose(
        _np(tops.segment_sum(_t(vals), _t(ids), 64)),
        np.asarray(jops.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                    64)), atol=1e-4)


# -- wrappers: routing ------------------------------------------------------------


def test_wrappers_refuse_other_devices_and_bad_inputs():
    meta = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpart.partition_histogram(meta, 4)
    with pytest.raises(ValueError):
        tpart.partition_histogram(torch.zeros(16, dtype=torch.int64), 4)
    with pytest.raises(ValueError):       # rows must be 2-D
        tpart.partition_scatter(torch.zeros(8),
                                torch.zeros(8, dtype=torch.int32), 2)
    with pytest.raises(ValueError):       # too many partitions for K2
        tpart.partition_scatter(torch.zeros((8, 1)),
                                torch.zeros(8, dtype=torch.int32), 4096)


@pytest.mark.parametrize("bad", [-1, 4, 1 << 30])
@pytest.mark.parametrize("kernel", ["histogram", "scatter"])
def test_wrappers_refuse_ids_out_of_range(kernel, bad):
    ids = torch.arange(32, dtype=torch.int32) % 4
    ids[17] = bad
    with pytest.raises(ValueError, match="partition ids"):
        if kernel == "histogram":
            tpart.partition_histogram(ids, 4)
        else:
            tpart.partition_scatter(ids[:, None], ids, 4)


def test_library_name_hashes_the_headers_beside_the_source(monkeypatch,
                                                          tmp_path):
    """A built library is named by its source and every ``csrc/*.cuh``
    (K4 and K4b share ``hopper.cuh``): an edited or added header names
    another library, so no stale one is loaded; nothing is compiled."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    first = build.library_path("k.cu")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert build.library_path("k.cu") == first
    (csrc / "h.cuh").write_text("// two\n")
    second = build.library_path("k.cu")
    assert second != first
    (csrc / "g.cuh").write_text("")
    assert build.library_path("k.cu") not in (first, second)
    (csrc / "g.cuh").unlink()
    (csrc / "h.cuh").write_text("// one\n")
    assert build.library_path("k.cu") == first
    assert not (tmp_path / "build").exists()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tpart.reset_launches()
    ids = torch.zeros(64, dtype=torch.int32)
    tpart.partition_histogram(ids, 4)
    tpart.partition_scatter(ids[:, None], ids, 4)
    tpart.fused_probe(ids, torch.ones(64), torch.ones(64), ids[:8],
                      ids[:8], ids[:8] + 1, 4)
    assert tpart.LAUNCHES == {"partition_histogram": 0,
                              "partition_scatter": 0, "fused_probe": 0}


# -- K1 and K2 at the card tests' edges, through the wrappers' CPU route ------


def _edge_ids(rng, n, p, kind):
    if kind == "one":
        return np.full(n, p - 1, np.int32)
    return rng.integers(0, p, n).astype(np.int32)


@pytest.mark.parametrize("case", ["unaligned_view", "one_bin", "p1",
                                  "p_max"])
def test_k1_edges_match_reference(case):
    """K1 on a view that starts one id in (N not a multiple of 4), with
    every id in one bin, and at P = 1 and P = MAX_HIST_PARTITIONS."""
    p = {"unaligned_view": 512, "one_bin": 512, "p1": 1,
         "p_max": tpart.MAX_HIST_PARTITIONS}[case]
    rng = np.random.default_rng(p)
    base = _edge_ids(rng, 40004, p, "one" if case == "one_bin" else "")
    ids = _t(base)[1:-2] if case == "unaligned_view" else _t(base)
    want = np.bincount(_np(ids), minlength=p)
    got = tpart.partition_histogram(ids, p)
    assert got.dtype == torch.int32 and got.shape == (p,)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jops.partition_histogram(
            jnp.asarray(_np(ids)), p, force_kernel=False)))


# name: (rows, partitions, dtype, row width, ids)
_K2_EDGES = {
    "waves_ragged": ((1 << 14) + 777, 9, np.int32, 1, "uniform"),
    "one_bucket": (4099, 9, np.int32, 1, "one"),
    "p1": (1003, 1, np.int32, 1, "uniform"),
    "p_max": (30007, tpart.MAX_SCATTER_PARTITIONS, np.int32, 1, "uniform"),
    "3_words": (2003, 13, np.float32, 3, "uniform"),
    "8_words": (2003, 13, np.int32, 8, "uniform"),
    "16_bytes": (2003, 13, np.int64, 2, "uniform"),
    "bytes": (2003, 13, np.uint8, 3, "uniform"),
    "gathered": (2003, 13, np.float32, 250, "uniform"),
}


@pytest.mark.parametrize("case", list(_K2_EDGES))
def test_k2_edges_match_reference(case):
    """K2 at the card tests' edges (a ragged last tile, one bucket, one and
    the most partitions, rows 1, 3 and 8 words, 16 bytes and 3 bytes wide,
    and 1000-byte rows) against the numpy oracle and, for 4-byte types,
    the JAX reference."""
    n, p, dtype, width, kind = _K2_EDGES[case]
    rng = np.random.default_rng(n + p + width)
    pids = _edge_ids(rng, n, p, kind)
    rows = rng.integers(0, 250, (n, width)).astype(dtype)
    got, off = tpart.partition_scatter(_t(rows), _t(pids), p)
    order, offsets = _grouping_oracle(pids, p)
    assert got.dtype == _t(rows).dtype and off.dtype == torch.int32
    np.testing.assert_array_equal(_np(off), offsets[:-1])
    np.testing.assert_array_equal(_np(got), rows[order])
    if rows.itemsize == 4:
        r_out, r_off = jref.partition_scatter_ref(jnp.asarray(rows),
                                                  jnp.asarray(pids), p)
        np.testing.assert_array_equal(_np(off), np.asarray(r_off))
        np.testing.assert_array_equal(_bits(_np(got)),
                                      _bits(np.asarray(r_out)))


# -- per-stream scratch (K1's and K2's counters and bases, K5's partials) -----


@pytest.mark.parametrize("dtype,zeroed", [(torch.int32, True),
                                          (torch.int32, False),
                                          (torch.float32, False)])
def test_stream_scratch_is_kept_per_device_and_stream(dtype, zeroed):
    """One buffer per (device, stream), kept while large enough, replaced
    by a larger one when a call needs more, made with zeros where the
    kernels expect zeros, and forgotten after a failed call."""
    scratch = tstreams.StreamScratch(dtype, zeroed=zeroed)
    dev = torch.device("cpu")
    a = scratch.get(dev, 11, 100)
    assert a.dtype == dtype and a.shape == (100,)
    assert scratch.get(dev, 11, 50) is a            # large enough: kept
    assert scratch.get(dev, 12, 50) is not a        # another stream
    if zeroed:
        assert not bool(a.any())
    grown = scratch.get(dev, 11, 1000)
    assert grown.shape == (1000,) and scratch.get(dev, 11, 10) is grown
    assert sorted(k[1] for k in scratch.keys()) == [11, 12]
    scratch.drop(dev, 11)
    assert scratch.get(dev, 11, 10) is not grown
    with scratch.lock:                               # held across a get
        assert scratch.get(dev, 12, 10).shape == (50,)


def test_partition_wrappers_keep_one_counter_block_per_stream():
    """K1's accumulator and ticket sit in one zeroed int32 buffer per
    stream, the ticket right after the MAX_HIST_PARTITIONS counters."""
    dev = torch.device("cpu")
    try:
        acc, ticket = tpart._counters(dev, 11)
        assert tpart._counters(dev, 11) == (acc, ticket)
        assert tpart._counters(dev, 12)[0] != acc
        assert ticket - acc == 4 * tpart.MAX_HIST_PARTITIONS
        buf = tpart._COUNTERS.get(dev, 11, 0)
        assert buf.shape == (tpart.MAX_HIST_PARTITIONS + 1,)
        assert not bool(buf.any())
    finally:
        tpart._COUNTERS.drop(dev, 11)
        tpart._COUNTERS.drop(dev, 12)
