"""Operator-rate calibration for the cost-model decision node.

Only ``calibrated_rates`` of the reference's simulator is ported so far:
the ``dynamic`` strategy's join node reads it when no rates are pinned in
``ctx.profile["rates"]``. ``ClusterSim``, ``make_cluster`` and the fault
models wait (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device

_RATE_CACHE: dict[str, float] = {}


def calibrated_rates(sample_rows: int = 1 << 18, force: bool = False,
                     device=None) -> dict:
    """Measure real bytes/s of the port's operators on ``device`` (the card
    unless ``"cpu"`` is passed), synchronizing the device around each
    timing. Cached per process."""
    if _RATE_CACHE and not force:
        return dict(_RATE_CACHE)
    from repro_torch.analytics import operators as ops

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    keys = torch.as_tensor(
        rng.integers(0, sample_rows, sample_rows).astype(np.int32),
        device=dev)
    bkeys = torch.as_tensor(
        rng.permutation(sample_rows)[: sample_rows // 4].astype(np.int32),
        device=dev)
    nbytes = sample_rows * 8.0

    def timeit(fn, *args):
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(*args)
        sync()
        return (time.perf_counter() - t0) / 3

    slots_tbl = ops.build_hash_table(bkeys)
    _RATE_CACHE.update({
        "scan": nbytes / timeit(
            lambda k: torch.where(k % 3 == 0, k, 0).sum(), keys),
        "sort": nbytes / timeit(lambda k: torch.sort(k), keys),
        "hash_build": (bkeys.shape[0] * 8.0) / timeit(
            ops.build_hash_table, bkeys),
        "hash_probe": nbytes / timeit(
            ops.hash_join_indices, keys, bkeys, slots_tbl),
        "merge_join": nbytes / timeit(
            ops.sort_merge_join_indices, keys, bkeys),
        "agg": nbytes / timeit(
            lambda k: ops.groupby_sum(
                k % 1024, torch.ones_like(k, dtype=torch.float32), 1024),
            keys),
    })
    return dict(_RATE_CACHE)
