"""Distributed tables for the serverless-analytics case study.

A ``Table`` is a dict of equal-length columns. A ``DistTable`` is a table
partitioned across cluster nodes (the paper's per-node data distribution),
carrying the per-node byte counts that decision nodes consume as
``data_dist`` (Fig. 6 input).

Where a column lives: a column is a ``torch.Tensor`` on the device that
computed it, except the shuffle store's bucket views, which are host numpy
arrays (``shuffle_write`` lands its permuted buffer on the host once, so
readers concatenate bucket views with a memcpy). A function that computes
on a table it read from the store first moves it onto its invocation's
device with ``on_device``; nothing else moves columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.decisions import DataDist, partition_skew
from repro_torch.device import resolve_device


def _row_bytes(columns: Mapping) -> int:
    return sum(int(np.prod(tuple(v.shape[1:]))) * v.dtype.itemsize
               for v in columns.values())


def to_numpy(v) -> np.ndarray:
    """One column as a host numpy array (a device tensor is copied back)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclass
class Table:
    columns: dict

    def __post_init__(self):
        lens = {k: v.shape[0] for k, v in self.columns.items()}
        assert len(set(lens.values())) <= 1, lens

    @property
    def num_rows(self) -> int:
        return int(next(iter(self.columns.values())).shape[0]) \
            if self.columns else 0

    @property
    def nbytes(self) -> int:
        return sum(int(np.prod(tuple(v.shape))) * v.dtype.itemsize
                   for v in self.columns.values())

    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def __getitem__(self, name: str):
        return self.columns[name]

    def take(self, idx) -> "Table":
        return Table({k: v.index_select(0, torch.as_tensor(idx,
                                                           device=v.device))
                      for k, v in self.columns.items()})

    def mask(self, keep) -> "Table":
        return self.take(torch.nonzero(keep).flatten())

    def concat(self, other: "Table") -> "Table":
        return Table.concat_all([self, other])

    @staticmethod
    def concat_all(parts: Sequence) -> "Table":
        """Multi-way concatenation: ONE concatenation per column.

        Accepts ``TableSlice`` views (materialized here) and falls back to
        the pairwise ``concat`` protocol for duck-typed stand-ins without
        ``columns``. Host-resident parts (the shuffle store's bucket views)
        concatenate with one numpy memcpy; any tensor part makes the result
        a tensor on that part's device.
        """
        parts = [p for p in parts]
        if not parts:
            raise ValueError("concat_all of no parts")
        if len(parts) == 1:
            p = parts[0]
            mat = getattr(p, "materialize", None)
            return mat() if mat is not None else p
        if all(hasattr(p, "columns") for p in parts):
            names = list(parts[0].columns)
            cols = {}
            for k in names:
                vals = [p.columns[k] for p in parts]
                if all(isinstance(v, np.ndarray) for v in vals):
                    cols[k] = np.concatenate(vals)
                else:
                    dev = next(v.device for v in vals
                               if isinstance(v, torch.Tensor))
                    cols[k] = torch.cat([torch.as_tensor(v, device=dev)
                                         for v in vals])
            return Table(cols)
        out = parts[0]
        for p in parts[1:]:
            out = out.concat(p)
        return out

    def slice(self, lo: int, hi: int) -> "TableSlice":
        """A row-range view sharing this table's column buffers."""
        return TableSlice(self.columns, int(lo), int(hi))


def on_device(table, device) -> Table:
    """``table`` (a ``Table`` or ``TableSlice``) with every column a tensor
    on ``device`` — the one place a function moves data it read from the
    store onto its invocation's device."""
    if table is None:
        return None
    return Table({k: torch.as_tensor(v, device=device)
                  for k, v in table.columns.items()})


class TableSlice:
    """A lazy row-range view of a parent table's columns.

    The single-pass shuffle writes every bucket of a partition from one
    permutation: each bucket is a ``TableSlice`` over the permuted parent
    columns, so publishing P buckets costs zero copies at write time. A
    column is materialized (one slice) only when a reader first touches it.
    ``nbytes`` and ``num_rows`` are computed from the range alone, so store
    byte accounting, quotas and tombstones see exactly the numbers a
    materialized copy would produce.
    """

    def __init__(self, parent_columns: Mapping, lo: int, hi: int):
        assert 0 <= lo <= hi
        # (columns, lo, hi) lives in ONE tuple so concurrent readers always
        # see a consistent snapshot — materialization republishes the tuple
        # with a single atomic rebind, never mutates it
        self._src: tuple = (dict(parent_columns), lo, hi)
        self.num_rows = hi - lo
        self._row_nbytes = _row_bytes(parent_columns)
        self._cache: dict | None = None

    @property
    def parent_columns(self) -> dict:
        return self._src[0]

    @property
    def lo(self) -> int:
        return self._src[1]

    @property
    def hi(self) -> int:
        return self._src[2]

    @property
    def nbytes(self) -> int:
        return self._row_nbytes * self.num_rows

    @property
    def columns(self) -> dict:
        cache = self._cache
        if cache is None:
            parent, lo, hi = self._src      # one consistent snapshot
            # a tensor range is copied out (as a jnp slice is) so that the
            # parent buffer is not pinned; host bucket views stay views
            cache = {k: v[lo:hi].clone() if isinstance(v, torch.Tensor)
                     else v[lo:hi] for k, v in parent.items()}
            self._cache = cache
            # materialized: drop the pin on the full-size parent buffer so
            # the slice's footprint matches the ``nbytes`` the store counts
            self._src = (cache, 0, self.num_rows)
        return cache

    def materialize(self) -> Table:
        return Table(dict(self.columns))

    def select(self, *names: str) -> "Table":
        return self.materialize().select(*names)

    def __getitem__(self, name: str):
        return self.columns[name]

    def take(self, idx) -> "Table":
        return self.materialize().take(idx)

    def mask(self, keep) -> "Table":
        return self.materialize().mask(keep)

    def concat(self, other) -> "Table":
        return Table.concat_all([self, other])


@dataclass
class DistTable:
    """A table partitioned over cluster nodes."""

    name: str
    partitions: dict[int, Table] = field(default_factory=dict)  # node -> part

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self.partitions.values())

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.partitions.values())

    def data_dist(self) -> DataDist:
        per_node = {n: p.nbytes for n, p in self.partitions.items()}
        skew = partition_skew(p.num_rows for p in self.partitions.values())
        return DataDist(self.name, per_node, rows=self.num_rows, skew=skew)

    def gather(self) -> Table:
        """All partitions as one table — one concatenation per column."""
        return Table.concat_all(
            [p for _, p in sorted(self.partitions.items())])


def from_numpy(columns: Mapping[str, np.ndarray], device=None) -> Table:
    """A port ``Table`` holding exactly the bytes of ``columns`` (e.g.
    ``np.asarray`` of each column of a reference table), on ``device``."""
    dev = resolve_device(device)
    return Table({k: torch.tensor(np.asarray(v), device=dev)
                  for k, v in columns.items()})


def dist_from_numpy(name: str, partitions: Mapping[int, Mapping],
                    device=None) -> DistTable:
    """The ``DistTable`` twin of ``from_numpy``: ``{node: columns}``."""
    return DistTable(name, {n: from_numpy(cols, device)
                            for n, cols in partitions.items()})


def synth_table(name: str, rows: int, key_space: int, seed: int = 0,
                distribution: str = "uniform", pareto_a: float = 1.2,
                value_cols: int = 2, unique_keys: bool = False,
                device=None) -> Table:
    """Synthetic table generator (uniform or Pareto-skewed keys). Drawn
    from ``np.random.default_rng`` exactly as the reference draws it, so a
    seed gives byte-identical columns in both packages."""
    rng = np.random.default_rng(seed)
    if unique_keys:
        assert rows <= key_space
        keys = rng.permutation(key_space)[:rows]
    elif distribution == "uniform":
        keys = rng.integers(0, key_space, size=rows)
    elif distribution == "pareto":
        raw = rng.pareto(pareto_a, size=rows)
        keys = np.minimum((raw / (raw.max() + 1e-9) * key_space),
                          key_space - 1).astype(np.int64)
    else:
        raise ValueError(distribution)
    cols = {"key": keys.astype(np.int32)}
    for i in range(value_cols):
        cols[f"v{i}"] = rng.standard_normal(rows, dtype=np.float32)
    return from_numpy(cols, device)


@dataclass
class PhantomTable:
    """Size-only stand-in for GB-scale simulator experiments (the paper's
    400 MB–6 GB tables): carries the data distribution without materializing
    arrays. Quacks like DistTable for planning purposes."""

    name: str
    bytes_per_node: Mapping[int, int]
    skew: float = 1.0

    @property
    def nbytes(self) -> int:
        return sum(self.bytes_per_node.values())

    def data_dist(self) -> DataDist:
        return DataDist(self.name, dict(self.bytes_per_node),
                        rows=self.nbytes // 8, skew=self.skew)


def phantom(name: str, total_bytes: int, nodes: Sequence[int],
            distribution: str = "uniform", pareto_a: float = 1.2,
            seed: int = 0) -> PhantomTable:
    nodes = list(nodes)
    if distribution == "uniform":
        share = np.full(len(nodes), 1.0 / len(nodes))
    elif distribution == "pareto":
        rng = np.random.default_rng(seed)
        raw = rng.pareto(pareto_a, size=len(nodes)) + 0.05
        share = raw / raw.sum()
    else:
        raise ValueError(distribution)
    per = {n: int(total_bytes * s) for n, s in zip(nodes, share)}
    skew = float(max(share) / (sum(share) / len(share)))
    return PhantomTable(name, per, skew)


def distribute(table: Table, nodes: Sequence[int], name: str,
               by: str = "round-robin", seed: int = 0) -> DistTable:
    n = table.num_rows
    order = np.arange(n)
    if by == "random":
        order = np.random.default_rng(seed).permutation(n)
    chunks = np.array_split(order, len(nodes))
    parts = {node: table.take(c) for node, c in zip(nodes, chunks)}
    return DistTable(name, parts)
