"""The data plane's single kernel-dispatch point (analytics half).

Every primitive the analytics operators and the serverless function library
touch routes through here. The three partition primitives that the
reference runs as Pallas kernels go through the kernel wrappers of
``repro_torch.kernels.partition`` (CUDA on the card, the plain PyTorch
version for CPU tensors); hashing, joins and segment sums are plain tensor
operations on whatever device their inputs live on, as they are plain jnp
in the reference.

Shape classes: the partition-grouping entry point (``grouping_indices``)
pads its input to the next power of two, so partitions with different
post-filter row counts share a handful of shapes — the quantization the
skew and salting logic is bounded by (``shape_class_count``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import partition as _k

HASH_MULT = 0x9E3779B1   # Knuth multiplicative hash
EMPTY = -1
_MASK32 = 0xFFFFFFFF


# -- partitioning (the shuffle primitive) --------------------------------------


def _hash(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """``(uint32(key) * HASH_MULT mod 2^32) >> (32 - bits)`` as int32,
    bit-identical to the reference's uint32 arithmetic. Torch has no
    uint32 multiply with wraparound, so the product is split into 16-bit
    halves of the key: each partial product stays below 2^48 in int64."""
    k = keys.to(torch.int64) & _MASK32
    lo = (k & 0xFFFF) * HASH_MULT
    hi = ((k >> 16) * HASH_MULT) & 0xFFFF
    h = (lo + (hi << 16)) & _MASK32
    return (h >> (32 - bits)).to(torch.int32)


def _bits(num_partitions: int) -> int:
    return max(1, int(np.ceil(np.log2(num_partitions))))


def partition_ids(keys, num_partitions: int) -> torch.Tensor:
    """Radix/hash partition id per row (int32)."""
    keys = torch.as_tensor(keys)
    return _hash(keys, _bits(num_partitions)) % num_partitions


def partition_permutation(keys, num_partitions: int):
    """Stable permutation grouping rows by partition + per-partition counts
    (int32 ``order`` and ``counts``)."""
    pids = partition_ids(keys, num_partitions)
    order = torch.argsort(pids, stable=True).to(torch.int32)
    counts = torch.bincount(pids, minlength=num_partitions).to(torch.int32)
    return order, counts, pids


def partition_histogram(part_ids, num_partitions: int,
                        check_ids: bool = True) -> torch.Tensor:
    """Per-partition row counts through K1 (handles the empty input)."""
    part_ids = torch.as_tensor(part_ids).to(torch.int32).contiguous()
    if part_ids.shape[0] == 0:
        return torch.zeros((num_partitions,), dtype=torch.int32,
                           device=part_ids.device)
    return _k.partition_histogram(part_ids, num_partitions, check_ids)


def partition_scatter(rows, part_ids, num_partitions: int):
    """Stable grouping of 2-D rows by partition id through K2 ->
    ``(grouped, offsets)`` (handles the empty input)."""
    if int(rows.shape[0]) == 0:
        return rows, torch.zeros((num_partitions,), dtype=torch.int32,
                                 device=rows.device)
    return _k.partition_scatter(rows.contiguous(),
                                part_ids.to(torch.int32).contiguous(),
                                num_partitions)


def _pad_len(n: int) -> int:
    """Next power of two >= n (floor 8): the shape-class quantizer."""
    return max(8, 1 << int(np.ceil(np.log2(max(1, n)))))


# (padded_len, num_partitions) pairs already dispatched
_SHAPE_CLASSES: set[tuple[int, int]] = set()

# per-thread padded-vs-actual row tally for every shape-class dispatch; the
# invoker snapshots it around each function body so padding waste lands on
# the invocation record (-> profile_feedback "padding_overhead")
_padding_tls = threading.local()


def _note_padding(rows: int, padded: int) -> None:
    c = getattr(_padding_tls, "counts", None)
    if c is None:
        c = _padding_tls.counts = [0, 0]
    c[0] += int(rows)
    c[1] += int(padded)


def padding_counters() -> tuple[int, int]:
    """``(actual_rows, padded_rows)`` dispatched through shape-class-padded
    entry points by this thread since ``reset_padding_counters``."""
    c = getattr(_padding_tls, "counts", None)
    return (c[0], c[1]) if c else (0, 0)


def reset_padding_counters() -> None:
    _padding_tls.counts = [0, 0]


def grouping_indices(part_ids, num_partitions: int):
    """One-call shuffle grouping: ``(order, offsets)`` (both int32) for a
    partition-id vector, where ``order[offsets[p]:offsets[p+1]]`` are
    partition ``p``'s row indices in stable (original) order.

    K2 scatters the index column over ``num_partitions + 1`` buckets, the
    last one the sentinel of the power-of-two padding: the grouped column
    *is* the permutation (sentinel rows land last) and the per-bucket bases
    *are* the offsets vector ``[0, c0, c0+c1, ..., n]``.
    """
    from repro_torch.obs.tracer import get_tracer

    pids = torch.as_tensor(part_ids)
    n = int(pids.shape[0])
    dev = pids.device
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((num_partitions + 1,), dtype=torch.int32,
                            device=dev))
    n_pad = _pad_len(n)
    _note_padding(n, n_pad)
    _SHAPE_CLASSES.add((n_pad, num_partitions))
    with get_tracer().span("kernel/grouping", "kernel", rows=n,
                           shape_class=n_pad, buckets=num_partitions):
        pids = pids.to(torch.int32)
        if n_pad != n:
            pids = torch.cat([pids, torch.full((n_pad - n,), num_partitions,
                                               dtype=torch.int32,
                                               device=dev)])
        idx = torch.arange(n_pad, dtype=torch.int32, device=dev)[:, None]
        grouped, offsets = _k.partition_scatter(idx, pids.contiguous(),
                                                num_partitions + 1)
        return grouped[:n, 0], offsets


def shape_class_count() -> int:
    """Distinct (padded_len, num_partitions) shape classes dispatched so
    far — the growth figure the skew regression test bounds (salted
    sub-joins quantize their chunk sizes so a lopsided bucket adds at most
    two classes, not one per chunk)."""
    return len(_SHAPE_CLASSES)


# heavy-hitter sketch sizing: one hash-slot histogram per shuffle writer
HOT_SKETCH_SLOTS = 512
HOT_KEYS_K = 8


def heavy_hitter_sketch(keys, k: int = HOT_KEYS_K,
                        num_slots: int = HOT_SKETCH_SLOTS,
                        ) -> tuple[tuple[int, int], ...]:
    """Exact top-k heavy hitters of a key column, sketch-then-verify.

    Phase 1 hashes every key into ``num_slots`` counters through K1.
    Phase 2 takes the ``k`` heaviest slots as candidates and counts their
    actual keys exactly on the host (only the candidate slots' keys leave
    the device). Returns ``((key, count), ...)`` sorted by (-count, key) —
    the reference's tuples exactly.
    """
    keys = torch.as_tensor(keys)
    n = int(keys.shape[0])
    if n == 0:
        return ()
    k = max(1, int(k))
    keys = keys.to(torch.int32)
    slot_ids = partition_ids(keys, num_slots)
    # hashed slot ids lie in [0, num_slots) by construction
    hist = partition_histogram(slot_ids, num_slots,
                               check_ids=False).cpu().numpy()
    cand = np.argsort(-hist, kind="stable")[:k]
    cand = cand[hist[cand] > 0]
    if cand.size == 0:
        return ()
    mask = torch.isin(slot_ids, torch.as_tensor(cand.astype(np.int32),
                                                device=keys.device))
    sub = keys[mask].cpu().numpy()
    uniq, counts = np.unique(sub, return_counts=True)
    order = np.lexsort((uniq, -counts))[:k]
    return tuple((int(uniq[i]), int(counts[i])) for i in order)


def salted_ranges(total_rows: int, salt: int) -> tuple[tuple[int, int], ...]:
    """Row ranges splitting a heavy join bucket ``salt`` ways for the
    salted sub-joins. The chunk size is quantized UP to a power of two
    (``_pad_len``), so every full chunk is exactly one padded shape class
    and only the final remainder chunk can add a second. May return fewer
    than ``salt`` ranges after quantization."""
    total = int(total_rows)
    if total <= 0:
        return ()
    chunk = _pad_len(-(-total // max(1, int(salt))))
    return tuple((lo, min(lo + chunk, total))
                 for lo in range(0, total, chunk))


def grouping_cache_size() -> int:
    """Distinct (rows, buckets) shape classes launched through K2 (the
    reference counts jit-compiled executables of its grouping body; the
    port compiles nothing per shape, so it counts the shapes its kernel
    ran at). Zero when no card ran K2."""
    return len(_k.SHAPES["partition_scatter"])


# -- joins ---------------------------------------------------------------------


def sort_merge_join_indices(probe_keys, build_keys):
    """Sort-merge: sort build side, binary-merge probe side.

    Returns (idx_into_build int32, found bool) aligned with probe rows.
    """
    build_order = torch.argsort(build_keys, stable=True)
    sorted_build = build_keys[build_order]
    pos = torch.searchsorted(sorted_build, probe_keys)
    pos = pos.clamp(0, build_keys.shape[0] - 1)
    found = sorted_build[pos] == probe_keys
    idx = torch.where(found, build_order[pos], 0).to(torch.int32)
    return idx, found


def _hash_table_size(n: int) -> int:
    # load factor <= 0.25: linear-probing cluster lengths stay far below
    # the probe budget even for multi-million-row build sides
    return max(16, int(2 ** np.ceil(np.log2(4 * n))))


def build_hash_table(build_keys, max_probes: int = 16):
    """Open-addressing (linear probing) insert of unique build keys.

    Parallel insertion: each round, every unplaced key writes its row index
    to its current probe slot; scatter conflicts resolve to the largest row
    index (deterministic), losers advance to the next probe position.
    """
    dev = build_keys.device
    n = build_keys.shape[0]
    cap = _hash_table_size(n)
    bits = int(np.log2(cap))
    slots = torch.full((cap,), EMPTY, dtype=torch.int32, device=dev)
    h0 = _hash(build_keys, bits)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    placed = torch.zeros((n,), dtype=torch.bool, device=dev)
    for p in range(max_probes):
        pos = ((h0 + p) % cap).long()
        # only unplaced keys contending for currently-empty slots
        want = ~placed & (slots[pos] == EMPTY)
        cand = torch.where(want, rows, EMPTY)
        tgt = torch.where(want, pos, cap)      # park non-contenders off-table
        slots_ext = torch.cat([slots, torch.full((1,), EMPTY,
                                                 dtype=torch.int32,
                                                 device=dev)])
        slots_ext.scatter_reduce_(0, tgt, cand, reduce="amax")
        slots = slots_ext[:cap]
        placed = placed | (slots[pos] == rows)
    return slots


def hash_join_indices(probe_keys, build_keys, slots, max_probes: int = 16):
    """Probe the hash table. Returns (idx_into_build int32, found bool)."""
    cap = slots.shape[0]
    bits = int(np.log2(cap))
    h = _hash(probe_keys, bits)
    idx = torch.zeros_like(probe_keys, dtype=torch.int32)
    found = torch.zeros(probe_keys.shape, dtype=torch.bool,
                        device=probe_keys.device)
    for p in range(max_probes):
        pos = ((h + p) % cap).long()
        cand = slots[pos]
        hit = (cand != EMPTY) \
            & (build_keys[cand.clamp(min=0).long()] == probe_keys) & ~found
        idx = torch.where(hit, cand, idx)
        found = found | hit
    return idx, found


# -- fused partition+probe (the pipelined join's bucket primitive) -------------

FUSED_SMEM_ROWS = _k.FUSED_SMEM_ROWS


def _fused_probe_padded(pk, v0, v1, bk, bc, bv, num_groups: int):
    """The sorted-search path over shape-class-padded buckets too large for
    K3: sort the build side once, binary-search every probe key, mask
    invalid (padding) build rows through the sort so a sentinel collision
    can never fake a match."""
    big = 2**31 - 1
    keys = torch.where(bv != 0, bk, big)     # park padding rows at the end
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    scat = bc[order]
    svalid = bv[order]
    pos = torch.searchsorted(skeys, pk).clamp(0, skeys.shape[0] - 1)
    found = (skeys[pos] == pk) & (svalid[pos] != 0)
    cat = torch.where(found, scat[pos], 0)
    weight = torch.where(found, v0 * v1,
                         torch.zeros((), dtype=torch.float32,
                                     device=v0.device))
    return cat % num_groups, weight


def fused_probe_groups(probe_keys, v0, v1, build_keys, build_cat,
                       num_groups: int):
    """Fused partition+probe+weight for one shuffled join bucket.

    Returns ``(group, weight)`` tensors aligned with probe rows, where
    non-matching probe rows carry group 0 / weight 0 — bit-identical to the
    unfused ``join -> where(found) -> cat % G`` pipeline (build keys unique
    per the join contract). Probe and build sides are padded to
    power-of-two shape classes; K3 runs when the padded build side fits
    one block's shared memory (``FUSED_SMEM_ROWS``), the sorted-search
    path otherwise.
    """
    from repro_torch.obs.tracer import get_tracer

    dev = probe_keys.device
    n = int(probe_keys.shape[0])
    m = int(build_keys.shape[0])
    if n == 0 or m == 0:
        return (torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.float32, device=dev))
    n_pad, m_pad = _pad_len(n), _pad_len(m)
    _note_padding(n + m, n_pad + m_pad)
    kernel_ok = m_pad <= FUSED_SMEM_ROWS
    with get_tracer().span("kernel/fused_probe", "kernel", rows=n,
                           build_rows=m, shape_class=n_pad,
                           path="kernel" if kernel_ok else "sorted"):

        def pad(t, dtype, to):
            t = t.to(dtype)
            if to == t.shape[0]:
                return t.contiguous()
            return torch.cat([t, torch.zeros((to - t.shape[0],), dtype=dtype,
                                             device=dev)])

        pk = pad(probe_keys, torch.int32, n_pad)
        pv0 = pad(v0, torch.float32, n_pad)
        pv1 = pad(v1, torch.float32, n_pad)
        bk = pad(build_keys, torch.int32, m_pad)
        bc = pad(build_cat, torch.int32, m_pad)
        bv = pad(torch.ones((m,), dtype=torch.int32, device=dev),
                 torch.int32, m_pad)
        if kernel_ok:
            grp, wgt = _k.fused_probe(pk, pv0, pv1, bk, bc, bv, num_groups)
        else:
            grp, wgt = _fused_probe_padded(pk, pv0, pv1, bk, bc, bv,
                                           num_groups)
        return grp[:n], wgt[:n]


# -- aggregation ---------------------------------------------------------------


def segment_sum(values, segment_ids, num_segments: int):
    """Segment-sum values by id — the grouped-aggregation primitive."""
    out = torch.zeros((num_segments,), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, segment_ids.long(), values)
