"""Plain PyTorch versions of the partition kernels (the contracts).

Each function computes exactly what its CUDA kernel in ``partition.cu``
computes. The kernel wrappers (``repro_torch.kernels.partition``) take these
for CPU tensors only; ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""

from __future__ import annotations

import torch


def partition_histogram_ref(part_ids: torch.Tensor,
                            num_partitions: int) -> torch.Tensor:
    """K1: ``(N,)`` int32 ids -> ``(P,)`` int32 counts."""
    return torch.bincount(part_ids, minlength=num_partitions)[
        :num_partitions].to(torch.int32)


def partition_scatter_ref(rows: torch.Tensor, part_ids: torch.Tensor,
                          num_partitions: int):
    """K2: stable grouping of ``(N, D)`` rows by partition id.

    Returns ``(out_rows (N, D), offsets (P,) int32)`` where
    ``out_rows[offsets[p] : offsets[p] + counts[p]]`` are partition ``p``'s
    rows in original order.
    """
    order = torch.argsort(part_ids, stable=True)
    counts = partition_histogram_ref(part_ids, num_partitions)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return rows[order], offsets


# rows of the probe side per one-hot block: keeps the (rows, M) match
# matrix of the plain probe near 64 MB at the largest gated build side
_PROBE_CHUNK_ELEMS = 1 << 24


def fused_probe_ref(probe_keys, v0, v1, build_keys, build_cat, build_valid,
                    num_groups: int):
    """K3: one-hot equality probe of every probe key against the whole
    build side, masked by ``build_valid``. Returns ``(group, weight)``:
    ``cat % G`` and ``v0 * v1`` of the matching build row, or 0 and 0.0
    where no valid build row matches."""
    n, m = probe_keys.shape[0], build_keys.shape[0]
    step = max(1, _PROBE_CHUNK_ELEMS // max(1, m))
    valid = build_valid != 0
    groups, weights = [], []
    for lo in range(0, n, step):
        pk = probe_keys[lo:lo + step]
        mi = ((pk[:, None] == build_keys[None, :])
              & valid[None, :]).to(torch.int32)
        found = mi.sum(dim=1) > 0
        cat = (mi * build_cat[None, :]).sum(dim=1).to(torch.int32)
        groups.append(cat % num_groups)
        weights.append(torch.where(found, v0[lo:lo + step] * v1[lo:lo + step],
                                   torch.zeros((), dtype=torch.float32,
                                               device=v0.device)))
    if not groups:
        return (torch.zeros((0,), dtype=torch.int32, device=probe_keys.device),
                torch.zeros((0,), dtype=torch.float32, device=v0.device))
    return torch.cat(groups), torch.cat(weights)
