"""Per-stage lineage + bounded recursive recovery planning.

Every physical stage the executor admits is recorded here: which decision
node produced it, which upstream stages it depends on, and — per invocation
— which *data* stage/partitions it writes (``params["dst"]`` up front,
refined by the partitions actually written once the invocation commits).
When a read hits a lost stage (``StageLostError``), ``recovery_plan``
computes the minimal bottom-up re-execution: the lost partitions' producer
invocations, plus — recursively — producers of any of *their* inputs that
are themselves gone (ephemeral GC, quota eviction, injected loss), stopping
at resident data. Re-executed invocations go back through the normal
invoker, so recovery honors slot fairness gates and store quotas exactly
like first-run work.

``expected_recovery`` is the simulator-side twin: it predicts the recovery
stage set from the *static* plan alone (residency derived from the
ephemeral-GC rule), which is what the simulator/runtime differential test
asserts against the runtime's actual recovery events.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from repro_torch.runtime.faults import RecoveryError

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.runtime.executor import RuntimeStage
    from repro_torch.runtime.invoker import Invocation
    from repro_torch.runtime.metrics import MetricsSink


@dataclass
class StageLineage:
    """What produced one physical stage (and thereby its data stage)."""

    name: str                          # RuntimeStage name, e.g. "shuffle_fact"
    app: str
    decision: str | None               # decision node that emitted the stage
    deps: tuple[str, ...]              # upstream RuntimeStage names
    invocations: list = field(default_factory=list)


@dataclass
class RecoveryEvent:
    """One healed loss: what was lost, what got recomputed."""

    app: str
    lost_stage: str                    # data stage name
    partitions: tuple[int, ...] | None
    recovered: tuple[str, ...]         # data stages recomputed, bottom-up
    invocations: int                   # producer invocations re-executed


def _inputs(inv: "Invocation") -> list[tuple[str, list[int] | None]]:
    """The data stages (and partitions; None = all) an invocation reads,
    parsed from the function library's parameter conventions."""
    p = inv.params
    out: list[tuple[str, list[int] | None]] = []
    if "src" in p:
        if "src_partitions" in p:
            # multi-partition readers (hot_filter_write):
            # "partition" is their *destination*, not a read
            out.append((p["src"], list(p["src_partitions"])))
        else:
            out.append((p["src"],
                        [p["partition"]] if "partition" in p else None))
    if "fact_stage" in p:
        fp = p.get("fact_partitions")
        out.append((p["fact_stage"], None if fp == "all" else list(fp)))
    if "dim_stage" in p:
        dp = p.get("dim_partitions")
        out.append((p["dim_stage"], None if dp == "all" else list(dp)))
    return out


class LineageLog:
    """Thread-safe record of which invocations produce which data stages."""

    def __init__(self):
        self._lock = threading.Lock()
        # (app, data_stage) -> producer invocations, in registration order
        self._producers: dict[tuple[str, str], list] = {}
        # (app, runtime_stage) -> StageLineage (docs, tests, dashboards)
        self.stages: dict[tuple[str, str], StageLineage] = {}

    def register_stage(self, st: "RuntimeStage") -> None:
        """Record a stage's producers. Re-registering a stage (the same app
        rerun on the same Runtime after a teardown) *replaces* its previous
        lineage — stale producers must not double recovery re-execution or
        inflate ``total_invocations``."""
        if not st.invocations:
            return
        app = st.invocations[0].app
        with self._lock:
            prev = self.stages.get((app, st.name))
            if prev is not None:
                stale = {iv.name for iv in prev.invocations}
                for key in [k for k in self._producers if k[0] == app]:
                    kept = [iv for iv in self._producers[key]
                            if iv.name not in stale]
                    if kept:
                        self._producers[key] = kept
                    else:
                        del self._producers[key]
            for inv in st.invocations:
                dst = inv.params.get("dst")
                if dst is None:
                    continue
                self._producers.setdefault((inv.app, dst), []).append(inv)
            self.stages[(app, st.name)] = StageLineage(
                st.name, app, getattr(st, "decision", None),
                tuple(st.deps), list(st.invocations))

    def producers(self, app: str, data_stage: str) -> list:
        with self._lock:
            return list(self._producers.get((app, data_stage), []))

    def total_invocations(self, app: str) -> int:
        with self._lock:
            return sum(len(sl.invocations) for (a, _), sl in
                       self.stages.items() if a == app)

    # -- recovery planning ---------------------------------------------------

    def _select(self, app: str, data_stage: str,
                parts: set[int] | None,
                writes: dict[str, set[tuple[str, int]]] | None) -> list:
        """Producer invocations of the lost partitions. With recorded writes
        the selection is partition-exact; without (invocation never ran, or
        no metrics) every producer is replayed — writer-label overwrite
        keeps that safe."""
        out = []
        for inv in self._producers.get((app, data_stage), []):
            if parts is not None and writes is not None:
                w = writes.get(inv.name)
                if w is not None and not any(
                        s == data_stage and p in parts for s, p in w):
                    continue
            out.append(inv)
        return out

    @staticmethod
    def _missing(app: str, data_stage: str, req: list[int] | None,
                 store) -> set[int] | None | str:
        """Which of the requested partitions are unavailable: a set (maybe
        empty), or ``"all"`` when the whole stage is gone."""
        written, lost = store.partition_state(app, data_stage)
        if lost == "all":
            return "all"
        if req is None:
            return set(lost)
        return {p for p in req if p in lost}

    def recovery_plan(self, app: str, data_stage: str,
                      partitions: Sequence[int] | None, store,
                      metrics: "MetricsSink | None" = None,
                      ) -> list[tuple[str, set[int] | None, list]] | None:
        """Bottom-up ``[(data_stage, partitions, invocations_to_rerun),
        ...]`` healing a loss of ``partitions`` (None = all) of
        ``data_stage``; ``None`` when the stage has no recorded lineage
        (e.g. seeded base inputs — only a whole-query rerun can restore
        those)."""
        writes = None
        if metrics is not None:
            writes = {}
            for r in metrics.records:
                if r.app == app and r.status == "ok" and r.writes:
                    writes[r.name] = set(r.writes)

        # pass 1: fixpoint of needed partitions per data stage
        need: dict[str, set[int] | None] = {
            data_stage: set(partitions) if partitions is not None else None}
        work = [data_stage]
        edges: dict[str, set[str]] = {}        # src -> consumers (in plan)
        seen_pairs: set[tuple[str, frozenset | None]] = set()
        while work:
            ds = work.pop()
            key = (ds, None if need[ds] is None else frozenset(need[ds]))
            if key in seen_pairs:
                continue
            seen_pairs.add(key)
            if (app, ds) not in self._producers:
                return None                    # no lineage: unrecoverable
            for inv in self._select(app, ds, need[ds], writes):
                for src, req in _inputs(inv):
                    miss = self._missing(app, src, req, store)
                    if miss != "all" and not miss:
                        continue
                    edges.setdefault(src, set()).add(ds)
                    prev = need.get(src, set())
                    new = None if (miss == "all" or prev is None) \
                        else prev | miss
                    if src not in need or new != prev:
                        need[src] = new
                        work.append(src)
            if len(seen_pairs) > 4 * max(1, len(self._producers)):
                raise RecoveryError(
                    f"recovery closure for {app!r}/{data_stage!r} did not "
                    f"converge (cyclic lineage?)")

        # pass 2: topological order, producers before consumers
        order: list[str] = []
        remaining = dict(need)
        while remaining:
            # a stage is ready once none of its still-unplaced inputs remain
            ready = [ds for ds in remaining
                     if not any(ds in cons and src in remaining
                                for src, cons in edges.items())]
            if not ready:
                raise RecoveryError(
                    f"cyclic recovery dependencies among {sorted(remaining)}")
            for ds in sorted(ready):
                order.append(ds)
                del remaining[ds]
        return [(ds, need[ds], self._select(app, ds, need[ds], writes))
                for ds in order]


class _StaticResidency:
    """Residency oracle for ``expected_recovery``: a data stage is gone iff
    the ephemeral-GC rule says a strict ancestor of the loss's consumer
    already reclaimed it (or it is the injected loss itself)."""

    def __init__(self, gone: dict[str, tuple[int, ...] | None]):
        self._gone = gone            # data stage -> lost partitions (None=all)

    def partition_state(self, app: str, stage: str):
        if stage in self._gone:
            parts = self._gone[stage]
            if parts is None:
                return set(), "all"
            return set(), set(parts)
        return {0}, set()            # resident (ids irrelevant: lost empty)


def expected_recovery(stages: Sequence["RuntimeStage"], lost_stage: str,
                      partitions: Sequence[int] | None = None,
                      ) -> list[str]:
    """Predict the recovery stage set for a loss of ``lost_stage`` from the
    static plan alone — no store, no execution.

    Residency is derived from the executor's GC rule: the consumer of the
    lost data stage only runs after its transitive dependencies finished,
    and a finishing stage reclaims its ``ephemeral_inputs``; so exactly the
    ephemeral inputs declared by strict ancestors of the consumer are gone
    at loss time, regardless of executor interleaving. This is the
    simulator-side twin of the runtime's actual recovery — the differential
    test asserts both compute the same set.
    """
    log = LineageLog()
    for st in stages:
        log.register_stage(st)
    if not stages or not stages[0].invocations:
        return []
    app = stages[0].invocations[0].app

    by_name = {st.name: st for st in stages}
    consumer = next(
        (st for st in stages
         if any(src == lost_stage
                for inv in st.invocations for src, _ in _inputs(inv))),
        None)
    ancestors: set[str] = set()
    frontier = list(consumer.deps) if consumer is not None else []
    while frontier:
        name = frontier.pop()
        if name in ancestors or name not in by_name:
            continue
        ancestors.add(name)
        frontier.extend(by_name[name].deps)

    gone: dict[str, tuple[int, ...] | None] = {}
    for st in stages:
        if st.name in ancestors:
            for ds in st.ephemeral_inputs:
                gone[ds] = None
    gone[lost_stage] = tuple(partitions) if partitions is not None else None

    plan = log.recovery_plan(app, lost_stage, partitions,
                             _StaticResidency(gone))
    if plan is None:
        raise RecoveryError(f"no lineage for {lost_stage!r} in static plan")
    return [ds for ds, _, _ in plan]
