"""Table-level analytics operators — thin columnar shells over the kernel
dispatch layer (``repro_torch.kernels.ops``).

Two join implementations with genuinely different execution structure (the
paper's Fig. 3):

  * ``sort_merge_join_indices`` — sort the build side, merge the probe side
    via searchsorted (the shuffle-heavy plan: records with equal keys must
    be co-located).
  * ``hash_join_indices``       — build an open-addressing hash table over
    the (smaller) build side, probe with the (larger) probe side (the
    broadcast-heavy plan).

Join contract: the build side has unique keys (fact ⋈ dim); output is one row
per probe row with a ``found`` mask.
"""

from __future__ import annotations

import torch

from repro_torch.analytics.table import Table
from repro_torch.kernels.ops import (  # noqa: F401  (re-exported primitives)
    EMPTY,
    HASH_MULT,
    build_hash_table,
    grouping_indices,
    hash_join_indices,
    partition_ids,
    partition_permutation,
    segment_sum,
    sort_merge_join_indices,
)


def join(probe: Table, build: Table, key: str = "key",
         method: str = "hash", suffix: str = "_b") -> Table:
    """Inner-join (probe ⋈ build); returns probe columns + matched build
    columns + 'found' mask column."""
    pk, bk = probe[key], build[key]
    if method == "hash":
        slots = build_hash_table(bk)
        idx, found = hash_join_indices(pk, bk, slots)
    elif method == "merge":
        idx, found = sort_merge_join_indices(pk, bk)
    else:
        raise ValueError(method)
    idx = idx.long()
    cols = dict(probe.columns)
    for name, col in build.columns.items():
        if name == key:
            continue
        out_name = name + (suffix if name in cols else "")
        cols[out_name] = torch.where(
            found if col.dim() == 1 else found[:, None], col[idx], 0)
    cols["found"] = found
    return Table(cols)


def groupby_sum(group_ids, values, num_groups: int):
    """Segment-sum values by group id."""
    return segment_sum(values, group_ids, num_groups)


def filter_table(t: Table, keep) -> Table:
    """Static-shape filter: zero out dropped rows, keep a validity column."""
    cols = {k: torch.where(keep if v.dim() == 1 else keep[:, None], v, 0)
            for k, v in t.columns.items()}
    cols["valid"] = keep & t.columns.get("valid", torch.ones_like(keep))
    return Table(cols)
