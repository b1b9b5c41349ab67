"""Per-invocation timing/bytes records + feedback into decision workflows.

Every function invocation — including preempted attempts — leaves an
``InvocationRecord``. The sink aggregates them per stage, formats the
operator dashboards the examples print, folds profile feedback into
``DecisionContext.profile`` (paper Fig. 5 step 4), and can replay the whole
trace into ``ClusterSim`` so the simulated benchmarks and the real data
plane share one plan.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Mapping

from repro_torch.core.decisions import merge_hot_keys, partition_skew


@dataclass
class InvocationRecord:
    name: str
    app: str
    stage: str
    func: str
    node: int
    attempt: int
    status: str          # "ok" | "preempted" | "starved" | "crashed" | "error"
    started: float
    finished: float
    bytes_in: int = 0
    bytes_out: int = 0
    # wall time the invocation spent against the shuffle store (reads +
    # writes, including emulated transfer); ``seconds - store_seconds`` is
    # its on-device compute — the split that lets decision nodes see *why*
    # a stage is slow (data movement vs work)
    store_seconds: float = 0.0
    reads_by_node: Mapping[int, int] = field(default_factory=dict)
    deps: tuple[str, ...] = ()
    priority: int = 0
    # (data_stage, partition) pairs the invocation wrote — the lineage
    # refinement that lets recovery replay only the lost partitions' actual
    # producers instead of every registered one
    writes: tuple = ()
    # shape-class padding tally across this invocation's kernel dispatches:
    # padded minus actual rows is wasted work the power-of-two quantizer
    # added (surfaced as ``padding_overhead`` in profile feedback)
    rows_actual: int = 0
    rows_padded: int = 0
    # free-form per-invocation observations the function body emitted via
    # ``ctx.stats`` (e.g. shuffle_write's per-bucket histogram and
    # heavy-hitter sketch — the skew node's observed distribution)
    stats: Mapping = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return max(0.0, self.finished - self.started)

    @property
    def compute_seconds(self) -> float:
        return max(0.0, self.seconds - self.store_seconds)


@dataclass
class StageMetrics:
    invocations: int = 0
    ok: int = 0
    preempted: int = 0
    crashed: int = 0
    starved: int = 0               # retry budget exhausted, no slot committed
    error: int = 0                 # function body / hook raised
    seconds: float = 0.0
    store_seconds: float = 0.0     # time against the store (transfer)
    compute_seconds: float = 0.0   # seconds - store_seconds, per record
    bytes_in: int = 0
    bytes_out: int = 0
    rows_actual: int = 0
    rows_padded: int = 0
    # per-bucket histograms summed elementwise over the stage's writers
    # (first ok record per invocation name — retries and speculation
    # duplicates never double-count), plus their heavy-hitter sketches
    partition_rows: tuple = ()
    partition_bytes: tuple = ()
    hot_sketches: tuple = ()

    @property
    def padding_overhead(self) -> float:
        """Fraction of kernel-dispatched rows that were padding
        (0.0 when nothing was padded or nothing was dispatched)."""
        if self.rows_padded <= self.rows_actual:
            return 0.0
        return (self.rows_padded - self.rows_actual) / self.rows_padded

    @property
    def max_partition_bytes(self) -> int:
        return max(self.partition_bytes, default=0)

    @property
    def mean_partition_bytes(self) -> float:
        if not self.partition_bytes:
            return 0.0
        return sum(self.partition_bytes) / len(self.partition_bytes)

    @property
    def partition_skew(self) -> float:
        """max/mean per-bucket rows — the lopsidedness figure the skew
        decision node thresholds on."""
        return partition_skew(self.partition_rows)

    @property
    def hot_keys(self) -> tuple:
        """Merged top-k heavy hitters across the stage's writers."""
        return merge_hot_keys(self.hot_sketches)


def _tuple_add(a: tuple, b) -> tuple:
    """Elementwise sum of two int tuples, right-padding the shorter with
    zeros (writers all emit ``num_buckets`` entries, but a stage mixing
    histogram and non-histogram records must still merge cleanly)."""
    a, b = tuple(a), tuple(b)
    if not b:
        return a
    if not a:
        return tuple(int(x) for x in b)
    if len(a) < len(b):
        a = a + (0,) * (len(b) - len(a))
    elif len(b) < len(a):
        b = b + (0,) * (len(a) - len(b))
    return tuple(int(x) + int(y) for x, y in zip(a, b))


class MetricsSink:
    """Thread-safe accumulator of invocation records."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records: list[InvocationRecord] = []
        self._listeners: list = []

    def subscribe(self, fn) -> None:
        """Call ``fn(record)`` after every appended record — the pipelined
        executor's partition-readiness signal (commits, not stage barriers,
        wake waiting consumers)."""
        with self._lock:
            self._listeners.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def record(self, rec: InvocationRecord) -> None:
        with self._lock:
            self.records.append(rec)
            listeners = list(self._listeners)
        for fn in listeners:       # outside the lock: listeners may re-enter
            fn(rec)

    def for_app(self, app: str) -> list[InvocationRecord]:
        with self._lock:
            return [r for r in self.records if r.app == app]

    def clear(self, app: str | None = None) -> int:
        """Drop records (one app's, or all) — the compaction hook that keeps
        a long-running/service-mode sink bounded. Returns the number
        dropped. Note that ``replay_into`` only covers records still held.
        """
        with self._lock:
            before = len(self.records)
            self.records = [] if app is None \
                else [r for r in self.records if r.app != app]
            return before - len(self.records)

    # -- aggregation -----------------------------------------------------------

    def by_stage(self, app: str | None = None) -> dict[str, StageMetrics]:
        out: dict[str, StageMetrics] = {}
        stat_seen: dict[str, set[str]] = {}
        with self._lock:
            records = list(self.records)
        for r in records:
            if app is not None and r.app != app:
                continue
            m = out.setdefault(r.stage, StageMetrics())
            m.invocations += 1
            m.ok += r.status == "ok"
            m.preempted += r.status == "preempted"
            m.crashed += r.status == "crashed"
            m.starved += r.status == "starved"
            m.error += r.status == "error"
            m.seconds += r.seconds
            m.store_seconds += r.store_seconds
            m.compute_seconds += r.compute_seconds
            m.bytes_in += r.bytes_in
            m.bytes_out += r.bytes_out
            m.rows_actual += r.rows_actual
            m.rows_padded += r.rows_padded
            if r.status == "ok" and r.stats:
                # only the first committed record per invocation name feeds
                # the stage histograms: a retried or speculated writer
                # recomputes the identical stats, and summing them twice
                # would fake skew the data doesn't have
                seen = stat_seen.setdefault(r.stage, set())
                if r.name not in seen:
                    seen.add(r.name)
                    m.partition_rows = _tuple_add(
                        m.partition_rows, r.stats.get("partition_rows", ()))
                    m.partition_bytes = _tuple_add(
                        m.partition_bytes, r.stats.get("partition_bytes", ()))
                    hot = tuple(r.stats.get("hot_keys", ()))
                    if hot:
                        m.hot_sketches = m.hot_sketches + (hot,)
        return out

    def stage_spans(self, app: str | None = None,
                    ) -> dict[str, tuple[float, float]]:
        """Wall-clock ``(first_start, last_finish)`` per stage — makes
        cross-stage overlap visible (the dependency-driven executor runs
        independent stages concurrently; under the barrier executor spans
        never intersect)."""
        out: dict[str, tuple[float, float]] = {}
        with self._lock:
            records = list(self.records)
        for r in records:
            if app is not None and r.app != app:
                continue
            lo, hi = out.get(r.stage, (r.started, r.finished))
            out[r.stage] = (min(lo, r.started), max(hi, r.finished))
        return out

    def profile_feedback(self, app: str, stage: str | None = None) -> dict:
        """Flat ``{"<stage>.<metric>": value}`` dict ready to merge into
        ``DecisionContext.profile`` via ``PrivateController.record_profile``.
        """
        out: dict[str, object] = {}
        for name, m in self.by_stage(app).items():
            if stage is not None and name != stage:
                continue
            out[f"{name}.seconds"] = m.seconds
            out[f"{name}.store_seconds"] = m.store_seconds
            out[f"{name}.compute_seconds"] = m.compute_seconds
            out[f"{name}.invocations"] = m.invocations
            out[f"{name}.bytes_in"] = m.bytes_in
            out[f"{name}.bytes_out"] = m.bytes_out
            out[f"{name}.preempted"] = m.preempted
            out[f"{name}.crashed"] = m.crashed
            out[f"{name}.starved"] = m.starved
            out[f"{name}.error"] = m.error
            out[f"{name}.padding_overhead"] = m.padding_overhead
            if m.partition_rows:
                out[f"{name}.partition_rows"] = m.partition_rows
                out[f"{name}.partition_bytes"] = m.partition_bytes
                out[f"{name}.partition_skew"] = m.partition_skew
                out[f"{name}.max_partition_bytes"] = m.max_partition_bytes
                out[f"{name}.mean_partition_bytes"] = m.mean_partition_bytes
                out[f"{name}.hot_keys"] = m.hot_keys
        return out

    def format_table(self, app: str) -> str:
        """Per-stage invocation/bytes dashboard (printed by the examples).

        Rows are sorted by each stage's first invocation start — the table
        reads in execution order, not dict-insertion order — and a TOTAL
        row closes it off.
        """
        lines = [f"{'stage':16s} {'inv':>4s} {'pre':>4s} {'stv':>4s} "
                 f"{'err':>4s} {'seconds':>9s} "
                 f"{'store_s':>9s} {'bytes_in':>10s} {'bytes_out':>10s} "
                 f"{'pad%':>5s} {'skew':>5s} {'hot':>4s}"]
        stages = self.by_stage(app)
        spans = self.stage_spans(app)
        total = StageMetrics()
        for name in sorted(stages,
                           key=lambda s: spans.get(s, (float("inf"), 0))[0]):
            m = stages[name]
            skew = f"{m.partition_skew:5.1f}" if m.partition_rows \
                else f"{'-':>5s}"
            lines.append(f"{name:16s} {m.invocations:4d} {m.preempted:4d} "
                         f"{m.starved:4d} {m.error:4d} "
                         f"{m.seconds:9.4f} {m.store_seconds:9.4f} "
                         f"{m.bytes_in:10d} {m.bytes_out:10d} "
                         f"{100 * m.padding_overhead:5.1f} "
                         f"{skew} {len(m.hot_keys):4d}")
            total.invocations += m.invocations
            total.preempted += m.preempted
            total.starved += m.starved
            total.error += m.error
            total.seconds += m.seconds
            total.store_seconds += m.store_seconds
            total.bytes_in += m.bytes_in
            total.bytes_out += m.bytes_out
            total.rows_actual += m.rows_actual
            total.rows_padded += m.rows_padded
            total.partition_rows = _tuple_add(total.partition_rows,
                                              m.partition_rows)
            total.partition_bytes = _tuple_add(total.partition_bytes,
                                               m.partition_bytes)
            total.hot_sketches = total.hot_sketches + m.hot_sketches
        m = total
        skew = f"{m.partition_skew:5.1f}" if m.partition_rows \
            else f"{'-':>5s}"
        lines.append(f"{'TOTAL':16s} {m.invocations:4d} {m.preempted:4d} "
                     f"{m.starved:4d} {m.error:4d} "
                     f"{m.seconds:9.4f} {m.store_seconds:9.4f} "
                     f"{m.bytes_in:10d} {m.bytes_out:10d} "
                     f"{100 * m.padding_overhead:5.1f} "
                     f"{skew} {len(m.hot_keys):4d}")
        return "\n".join(lines)

    # -- trace replay into the simulator ---------------------------------------

    def replay_into(self, sim, app: str | None = None,
                    rates: Mapping[str, float] | None = None) -> int:
        """Submit the successful invocation trace as SimTasks.

        The real runtime and the simulator then share one plan: same task
        names, dependency edges, placements and transfer volumes; durations
        come from calibrated per-operator rates applied to the *measured*
        bytes (or measured wall time when no rate covers the function).
        Returns the number of tasks submitted; caller runs ``sim.run()``.
        """
        from repro_torch.analytics.simulator import SimTask
        n = 0
        with self._lock:
            records = list(self.records)
        ok = {r.name for r in records if r.status == "ok"}
        for r in records:
            if r.status != "ok" or (app is not None and r.app != app):
                continue
            rate = (rates or {}).get(r.func)
            duration = (r.bytes_in / rate) if rate and r.bytes_in \
                else r.seconds
            sim.submit(SimTask(
                r.name, r.app, duration, node=r.node, priority=r.priority,
                deps=tuple(d for d in r.deps if d in ok),
                transfers={s: int(b) for s, b in r.reads_by_node.items()
                           if s != r.node}))
            n += 1
        return n
