"""The partitioned analytics function library.

Each entry is a stateless serverless function: it reads its inputs from the
shuffle store, computes with ``repro_torch.analytics.operators`` (which
routes through the kernel dispatch layer ``repro_torch.kernels.ops``) and
writes its outputs back — no state survives the invocation, so the invoker
may retry it after preemption. Registered names are what the executor puts
into ``Invocation.func``.

Where data lives: a function moves every table it computes on onto its
invocation's device (``ctx.device``) with ``on_device`` right after reading
it; outputs are published as device tensors, except ``shuffle_write``'s
buckets, which land on the host once as numpy views of the permuted buffer
(the host-resident bucket contract of the reference, so bucket byte
accounting is the same).

Stage-name and partition parameters arrive via ``ctx.params``:

    scan_filter      src, dst, partition [, filter_col, filter_gt]
    shuffle_write    src, dst, partition, num_buckets
    broadcast_write  src, dst, partition
    hash_join_partition / merge_join_partition
                     fact_stage, fact_partitions, dim_stage,
                     dim_partitions | "all", dst, partition, num_groups
    salted_join_partition
                     join params + fact_writers (one writer shard of a
                     heavy bucket) [, drop_keys]
    hot_filter_write src, src_partitions, keys, dst
    hot_join_partition
                     join params + keep_keys (heavy-hitter probe split)
    partial_aggregate  src, dst, partition, num_groups
    final_aggregate    src, dst, num_groups
    cpu_spin         dst, partition [, iters]
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.analytics import operators as ops
from repro_torch.analytics.table import Table, on_device, to_numpy
from repro_torch.kernels import ops as kops

FUNCTIONS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        FUNCTIONS[name] = fn
        return fn
    return deco


@register("cpu_spin")
def cpu_spin(ctx) -> None:
    """GIL-bound compute stage: a pure Python accumulation loop whose
    result is deterministic in ``(partition, iters)``."""
    p = ctx.params
    iters = int(p.get("iters", 100_000))
    x = int(p["partition"]) + 1
    acc = 0
    for i in range(iters):
        acc = (acc + x * i) % 1_000_003
    ctx.put(p["dst"], p["partition"],
            Table({"acc": torch.tensor([acc], dtype=torch.int32,
                                       device=ctx.device)}))


def _empty_joined(device) -> Table:
    return Table({"group": torch.zeros((0,), dtype=torch.int32,
                                       device=device),
                  "weight": torch.zeros((0,), dtype=torch.float32,
                                        device=device)})


def _keys(values, device) -> torch.Tensor:
    return torch.as_tensor([int(k) for k in values], dtype=torch.int32,
                           device=device)


@register("scan_filter")
def scan_filter(ctx) -> None:
    """Partition scan: read a base partition, drop filtered rows, rewrite.
    The runtime genuinely compacts: dropped rows never hit the store."""
    p = ctx.params
    t = ctx.get(p["src"], p["partition"])
    if t is None:
        return
    col = p.get("filter_col")
    if col is not None and t.num_rows:
        t = on_device(t, ctx.device)
        t = t.mask(t[col] > p.get("filter_gt", 0.0))
    ctx.put(p["dst"], p["partition"], t)


@register("shuffle_write")
def shuffle_write(ctx) -> None:
    """Hash-partition one input partition into the join's bucket space —
    the single-pass columnar path.

    K2 (through ``ops.grouping_indices``) yields the grouping permutation
    and every bucket's offset range; one gather per column permutes the
    partition; each non-empty bucket is then a zero-copy ``TableSlice`` of
    the permuted buffer, published together via ``ctx.put_many``. The store
    appends this writer's slices to whatever other map instances wrote for
    the same buckets — that append *is* the all-to-all shuffle.
    """
    p = ctx.params
    t = ctx.get(p["src"], p["partition"])
    if t is None or t.num_rows == 0:
        return
    t = on_device(t, ctx.device)
    nb = int(p["num_buckets"])
    pids = ops.partition_ids(t["key"], nb)
    order, offsets = ops.grouping_indices(pids, nb)
    # land the permuted buffer on the host ONCE (one transfer per column):
    # every bucket slice is then a zero-copy numpy view, and readers
    # concatenate views with a memcpy
    permuted = Table({k: to_numpy(v)
                      for k, v in t.take(order).columns.items()})
    bounds = to_numpy(offsets)
    # skew detection rides the grouping already paid for: the offset diffs
    # ARE the per-bucket row histogram, and the heavy-hitter sketch is one
    # fixed-shape hash-slot histogram (K1) plus an exact count of the
    # candidate slots' keys
    rows_hist = np.diff(bounds)
    row_nb = sum(int(np.prod(v.shape[1:])) * v.dtype.itemsize
                 for v in permuted.columns.values())
    ctx.stats["partition_rows"] = tuple(int(r) for r in rows_hist)
    ctx.stats["partition_bytes"] = tuple(int(r) * row_nb for r in rows_hist)
    ctx.stats["hot_keys"] = kops.heavy_hitter_sketch(t["key"])
    out = {r: permuted.slice(bounds[r], bounds[r + 1])
           for r in range(nb) if bounds[r + 1] > bounds[r]}
    ctx.put_many(p["dst"], out)


@register("broadcast_write")
def broadcast_write(ctx) -> None:
    """Publish a (small) build-side partition for broadcast consumption."""
    p = ctx.params
    t = ctx.get(p["src"], p["partition"])
    if t is not None:
        ctx.put(p["dst"], p["partition"], t)


PREFETCH_WINDOW = 2     # in-flight fetches per side (double buffering)


def _read_side(ctx, stage: str, parts, window: int = PREFETCH_WINDOW,
               writers=None):
    """Concatenate a join side's partitions in ONE multi-way concat per
    column. Under an active pipeline plan the reads are double-buffered;
    per-partition read order is exactly the barrier path's. A
    writer-restricted read (``writers``) skips the prefetch cache."""
    if parts == "all":
        return ctx.get_all(stage)
    parts = list(parts)
    pipelined = ctx.plan in ("pipelined", "fused") and len(parts) > 1 \
        and writers is None
    if pipelined:
        for part in parts[:window]:
            ctx.prefetch(stage, part)
    got = []
    for i, part in enumerate(parts):
        if pipelined and i + window < len(parts):
            ctx.prefetch(stage, parts[i + window])
        t = ctx.get(stage, part, writers=writers)
        if t is not None and t.num_rows:
            got.append(t)
    return Table.concat_all(got) if got else None


def _mitigation_view(fact, p, device):
    """Apply the skew plan's fact-side restrictions before joining:
    ``row_lo``/``row_hi`` select one salted sub-range of a heavy bucket,
    ``drop_keys`` removes the heavy-hitter keys a broadcast split routes
    elsewhere, ``keep_keys`` is the hot-probe side of the same split."""
    if fact is None or fact.num_rows == 0:
        return fact
    lo = p.get("row_lo")
    if lo is not None:
        lo, hi = int(lo), min(int(p["row_hi"]), fact.num_rows)
        if hi <= lo:
            return None
        fact = fact.slice(lo, hi).materialize()
    drop = p.get("drop_keys")
    if drop:
        fact = fact.mask(~torch.isin(fact["key"], _keys(drop, device)))
    keep_keys = p.get("keep_keys")
    if keep_keys:
        fact = fact.mask(torch.isin(fact["key"], _keys(keep_keys, device)))
    return fact


def _join_partition(ctx, method: str) -> None:
    p = ctx.params
    plan = ctx.plan
    if plan in ("pipelined", "fused"):
        # start the (small) build side streaming in while the fact side is
        # read — the cross-side half of the double buffering
        dim_parts = list(ctx.partitions(p["dim_stage"])
                         if p["dim_partitions"] == "all"
                         else p["dim_partitions"])
        if len(dim_parts) > 1:
            for part in dim_parts:
                ctx.prefetch(p["dim_stage"], part)
    fact = _read_side(ctx, p["fact_stage"], p["fact_partitions"],
                      writers=p.get("fact_writers"))
    dim = _read_side(ctx, p["dim_stage"], p["dim_partitions"])
    fact = _mitigation_view(on_device(fact, ctx.device), p, ctx.device)
    if fact is None or fact.num_rows == 0 or dim is None or dim.num_rows == 0:
        ctx.put(p["dst"], p["partition"], _empty_joined(ctx.device))
        return
    dim = on_device(dim, ctx.device)
    if plan == "fused":
        # one dispatch replaces join -> where(found) -> mod: same output
        # encoding (non-matching rows carry group 0 / weight 0)
        group, weight = kops.fused_probe_groups(
            fact["key"], fact["v0"], fact["v1"], dim["key"], dim["cat"],
            int(p["num_groups"]))
        ctx.put(p["dst"], p["partition"],
                Table({"group": group, "weight": weight}))
        return
    joined = ops.join(fact, dim, method=method)
    found = joined["found"]
    weight = torch.where(found, joined["v0"] * joined["v1"], 0.0)
    group = joined["cat"].to(torch.int32) % int(p["num_groups"])
    ctx.put(p["dst"], p["partition"],
            Table({"group": group, "weight": weight}))


@register("hash_join_partition")
def hash_join_partition(ctx) -> None:
    """Broadcast hash join: build over the dim side, probe the fact side."""
    _join_partition(ctx, "hash")


@register("merge_join_partition")
def merge_join_partition(ctx) -> None:
    """Shuffled sort-merge join over one co-partitioned bucket."""
    _join_partition(ctx, "merge")


@register("salted_join_partition")
def salted_join_partition(ctx) -> None:
    """One writer shard of a heavy shuffled bucket: sort-merge join of the
    ``fact_writers`` slices of the bucket against the bucket's dim side,
    writing straight into an extra ``joined`` partition."""
    _join_partition(ctx, "merge")


@register("hot_filter_write")
def hot_filter_write(ctx) -> None:
    """Broadcast split, build side: collect the heavy-hitter keys' dim rows
    from the scan output and publish them as one replicated build
    partition. Writes nothing when no dim row matches."""
    p = ctx.params
    keys = _keys(p["keys"], ctx.device)
    got = []
    for part in p["src_partitions"]:
        t = ctx.get(p["src"], part)
        if t is None or t.num_rows == 0:
            continue
        t = on_device(t, ctx.device)
        keep = torch.isin(t["key"], keys)
        if bool(keep.any()):
            got.append(t.mask(keep))
    if got:
        ctx.put(p["dst"], 0, Table.concat_all(got))


@register("hot_join_partition")
def hot_join_partition(ctx) -> None:
    """Broadcast split, probe side: hash-join one fact scan partition's
    heavy-hitter rows (``keep_keys``) against the replicated hot build
    side."""
    _join_partition(ctx, "hash")


@register("partial_aggregate")
def partial_aggregate(ctx) -> None:
    """Per-partition grouped partial sums — one segment-sum dispatch."""
    p = ctx.params
    g = int(p["num_groups"])
    t = ctx.get(p["src"], p["partition"])
    if t is None or t.num_rows == 0:
        vec = torch.zeros((g,), dtype=torch.float32, device=ctx.device)
    else:
        t = on_device(t, ctx.device)
        vec = ops.groupby_sum(t["group"], t["weight"], g)
    ctx.put(p["dst"], p["partition"], Table({"sum": vec}))


@register("final_aggregate")
def final_aggregate(ctx) -> None:
    """Fold every partial vector in one pass (float64 accumulation on the
    host for a deterministic, order-independent total)."""
    p = ctx.params
    g = int(p["num_groups"])
    vecs = [t["sum"] for t in (ctx.get(p["src"], part)
                               for part in ctx.partitions(p["src"]))
            if t is not None and t.num_rows]
    total = (np.stack([to_numpy(v).astype(np.float64) for v in vecs])
             .sum(axis=0) if vecs else np.zeros(g, dtype=np.float64))
    ctx.put(p["dst"], 0, Table({"sum": torch.as_tensor(
        total, dtype=torch.float32, device=ctx.device)}))
