"""Dependency-driven DAG executor: decision tuples -> real invocations.

``RuntimeStage`` is the materialized form of one decision-workflow stage: a
named group of invocations plus its upstream stage dependencies. The
executor launches any stage whose dependencies are satisfied — under a
parallel invoker independent stages (e.g. ``scan_fact`` and ``scan_dim``)
run concurrently — and interleaves decision evaluation with stage
completion: a ``planner`` callback is invoked as each stage finishes, folds
the measured metrics and observed output distributions back into its
decision-workflow context (paper Fig. 5 step 4), binds the next decisions,
and returns newly materialized stages to extend the DAG mid-query.
``barrier=True`` restores the legacy one-stage-at-a-time, list-order
execution (kept as the baseline for the executor benchmark).

``Runtime`` bundles the store + invoker + metrics behind one handle; several
applications (private controllers) can share it, contending for slots
through the one ``GlobalController`` — that is the paper's shared serverless
substrate.
"""

from __future__ import annotations

import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.analytics.table import to_numpy
from repro_torch.core.controllers import GlobalController, PrivateController
from repro_torch.core.decisions import DecisionContext, DecisionNode
from repro_torch.obs.audit import bound_app
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.faults import RecoveryError
from repro_torch.runtime.invoker import (
    InlineInvoker,
    Invocation,
    Invoker,
    ThreadPoolInvoker,
)
from repro_torch.runtime.lineage import LineageLog, RecoveryEvent
from repro_torch.runtime.metrics import MetricsSink, StageMetrics
from repro_torch.runtime.store import ShuffleStore, StageLostError


@dataclass
class RuntimeStage:
    """One stage of the physical plan: parallel invocations + stage deps."""

    name: str
    invocations: list[Invocation]
    deps: tuple[str, ...] = ()
    ephemeral_inputs: tuple[str, ...] = ()   # stages to GC once this finishes
    decision: str | None = None              # decision node that emitted it


class StagePlanner:
    """Protocol for planners that extend the DAG as stages complete.

    ``initial_stages`` materializes the stages known up front;
    ``on_stage_complete`` is called after each stage finishes (metrics
    recorded, ephemeral inputs not yet reclaimed) and returns further
    stages to schedule — typically by binding the next late-bound decisions
    of a ``WorkflowRun``. Return an empty list when nothing new unlocks.
    """

    def initial_stages(self) -> list[RuntimeStage]:  # pragma: no cover
        return []

    def on_stage_complete(self, stage: str, runtime: "Runtime",
                          pc: PrivateController | None = None,
                          ) -> list[RuntimeStage]:  # pragma: no cover
        return []


class DAGExecutor:
    """Dependency-driven stage scheduler over a pluggable invoker.

    Failure handling: every admitted stage is registered with the runtime's
    ``LineageLog``; when a read during a stage hits a lost shuffle stage
    (``StageLostError`` — evicted ephemeral data, quota pressure, injected
    fault), the executor asks the lineage for a bounded recovery plan and
    re-executes only the lost partitions' producer invocations (recursively,
    for producers whose own inputs are gone), then retries the stage's
    not-yet-committed invocations. Recovery runs through the normal invoker,
    so it honors slot-fairness gates and store quotas like first-run work.
    ``recovery`` picks the policy: ``"lineage"`` (default), ``"rerun"``
    (surface ``RecoveryError`` at the first loss — the caller reruns the
    query), or a ``DecisionNode`` (e.g. ``repro_torch.core.decisions.
    recovery_node``) deciding per-loss from the plan size.
    """

    def __init__(self, runtime: "Runtime", barrier: bool = False,
                 max_recoveries: int = 8,
                 recovery: str | DecisionNode = "lineage",
                 pipeline: bool = False):
        self.runtime = runtime
        self.barrier = barrier
        self.max_recoveries = max_recoveries
        self.recovery = recovery
        self.pipeline = pipeline
        self._recover_lock = threading.Lock()
        # pipelined mode: committed invocation names + a condition the
        # metrics listener notifies on every commit — partition-granularity
        # readiness (an invocation whose ``needs`` are all committed may
        # run before its producer *stage* has finished)
        self._ok: set[str] = set()
        self._ok_cond = threading.Condition()
        self._abort = threading.Event()

    def _on_record(self, rec) -> None:
        if rec.status != "ok":
            return
        with self._ok_cond:
            self._ok.add(rec.name)
            self._ok_cond.notify_all()

    def run(self, stages: Sequence[RuntimeStage],
            pc: PrivateController | None = None,
            planner: StagePlanner | None = None) -> dict[str, StageMetrics]:
        known: dict[str, RuntimeStage] = {}
        pending: dict[str, RuntimeStage] = {}   # insertion-ordered
        completed: set[str] = set()

        def admit(batch):
            batch = list(batch or ())
            for st in batch:
                if st.name in known:
                    raise ValueError(f"duplicate stage {st.name!r}")
                known[st.name] = st
                pending[st.name] = st
                self.runtime.lineage.register_stage(st)
            for st in batch:
                missing = [d for d in st.deps if d not in known]
                if missing:
                    raise ValueError(
                        f"stage {st.name!r} depends on unknown {missing}")

        admit(stages)
        if not known:
            return {}
        app = next(st.invocations[0].app for st in known.values()
                   if st.invocations)
        invoker = self.runtime.invoker
        metrics = self.runtime.metrics
        # root the query's span tree: when no scheduler anchored a
        # ("query", app) span (direct executor use), open one here so stage
        # spans always have a live cross-thread parent
        tr = get_tracer()
        own_root = None
        if tr.enabled and tr.anchored(("query", app)) is None:
            own_root = tr.start(f"query/{app}", "executor", trace=app,
                                parent=None)
            tr.anchor(("query", app), own_root)

        def dep_invs(st: RuntimeStage) -> tuple[str, ...]:
            return tuple(inv.name for d in st.deps
                         for inv in known[d].invocations)

        def finish(st: RuntimeStage) -> None:
            completed.add(st.name)
            if pc is not None:
                pc.record_profile(
                    **metrics.profile_feedback(app, stage=st.name))
            if planner is not None:
                admit(planner.on_stage_complete(st.name, self.runtime, pc))
            for src in st.ephemeral_inputs:
                # under a quota the stage is sealed (lazily evicted when the
                # app needs headroom); otherwise dropped immediately
                self.runtime.store.reclaim_stage(app, src)

        prev_honor = getattr(invoker, "honor_plan", False)
        if self.pipeline:
            metrics.subscribe(self._on_record)
            invoker.honor_plan = True
        try:
            if self.barrier or not getattr(invoker, "parallel", False):
                self._run_serial(pending, completed, invoker, dep_invs,
                                 finish)
            else:
                self._run_concurrent(pending, completed, invoker, dep_invs,
                                     finish)
        finally:
            if self.pipeline:
                invoker.honor_plan = prev_honor
                metrics.unsubscribe(self._on_record)
            if own_root is not None:
                tr.release_anchor(("query", app))
                tr.end(own_root, stages=len(known))
        return metrics.by_stage(app)

    def _run_serial(self, pending, completed, invoker, dep_invs, finish):
        """One stage at a time. ``barrier`` keeps strict admission order
        (the legacy executor); otherwise the first *ready* stage runs, so
        dynamically admitted stages interleave correctly."""
        while pending:
            if self.barrier:
                name = next(iter(pending))
                blocked = [d for d in pending[name].deps
                           if d not in completed]
                if blocked:
                    raise ValueError(
                        f"stage {name!r} blocked on incomplete {blocked} "
                        f"(barrier mode runs stages in admission order)")
            else:
                ready = [n for n, st in pending.items()
                         if all(d in completed for d in st.deps)]
                if not ready:
                    raise ValueError(
                        f"stages {sorted(pending)} blocked on unsatisfied "
                        f"dependencies")
                name = ready[0]
            st = pending.pop(name)
            self._run_stage_recovering(st, dep_invs(st))
            finish(st)

    def _run_concurrent(self, pending, completed, invoker, dep_invs, finish):
        """Every ready stage gets a driver thread; completions unlock
        dependents (and, via the planner, late-bound decisions) while
        sibling stages are still in flight."""
        max_drivers = max(2, int(getattr(invoker, "max_workers", 8)))
        with ThreadPoolExecutor(max_workers=max_drivers) as drivers:
            in_flight: dict = {}
            while pending or in_flight:
                ready = [n for n, st in pending.items()
                         if all(d in completed for d in st.deps)]
                if self.pipeline:
                    # partial readiness: a stage whose every invocation
                    # carries partition-granularity ``needs`` may launch
                    # while its producer stages are still in flight — its
                    # driver admits invocations wave-by-wave as their
                    # producers commit. Capacity-capped so a wave-waiting
                    # consumer can never occupy the driver slot its own
                    # producer is queued for.
                    active = {st.name for st in in_flight.values()}
                    for n, st in pending.items():
                        if (n in ready
                                or len(in_flight) + len(ready)
                                >= max_drivers - 1):
                            continue
                        if (st.invocations
                                and all(iv.needs for iv in st.invocations)
                                and all(d in completed or d in active
                                        for d in st.deps)):
                            ready.append(n)
                for name in ready:
                    st = pending.pop(name)
                    fut = drivers.submit(self._run_stage_recovering, st,
                                         dep_invs(st))
                    in_flight[fut] = st
                if not in_flight:
                    raise ValueError(
                        f"stages {sorted(pending)} blocked on unsatisfied "
                        f"dependencies")
                done, _ = wait(in_flight, return_when=FIRST_COMPLETED)
                for fut in done:
                    st = in_flight.pop(fut)
                    try:
                        fut.result()    # propagate the first failure
                    except BaseException:
                        # wake every wave-waiting driver before unwinding,
                        # or the pool shutdown would join them forever
                        self._abort.set()
                        with self._ok_cond:
                            self._ok_cond.notify_all()
                        raise
                    finish(st)

    # -- lineage-based recovery -----------------------------------------------

    def _run_stage_recovering(self, st: RuntimeStage,
                              deps: tuple[str, ...]) -> None:
        """Run one stage, healing lost-stage reads via lineage recompute.

        Each round retries only the stage's not-yet-committed invocations
        (writer-label overwrite makes duplicates safe anyway). A loss
        surfacing *during* recovery (a deeper input also gone, or a
        concurrent eviction) is replanned on the next round against the
        store's current state; ``max_recoveries`` bounds the rounds so an
        unrecoverable store can never wedge the executor.
        """
        invoker = self.runtime.invoker
        metrics = self.runtime.metrics
        # stage lifecycle span, anchored so invocation spans in invoker
        # worker threads parent to it; trace id = the app
        tr = get_tracer()
        app = st.invocations[0].app if st.invocations else None
        ssp = None
        if app is not None:
            ssp = tr.start(f"stage/{st.name}", "executor", trace=app,
                           parent=tr.anchored(("query", app)), stage=st.name,
                           deps=list(st.deps), decision=st.decision,
                           invocations=len(st.invocations))
            tr.anchor(("stage", app, st.name), ssp)
        # only records born in *this* run count as committed: a rerun of the
        # same app on the same Runtime must not skip invocations whose
        # previous-attempt outputs were torn down with the old store state
        first_record = len(metrics.records)
        todo = list(st.invocations)
        rounds = 0
        try:
            while True:
                try:
                    if todo:
                        if (self.pipeline
                                and all(iv.needs for iv in todo)):
                            self._run_stage_waves(todo, deps)
                        else:
                            invoker.run_stage(todo, deps=deps)
                    return
                except StageLostError as e:
                    rounds += 1
                    if rounds > self.max_recoveries:
                        raise RecoveryError(
                            f"stage {st.name!r}: recovery budget "
                            f"({self.max_recoveries}) exhausted healing "
                            f"{e.stage!r}") from e
                    try:
                        self._recover(e)
                    except StageLostError:
                        # deeper loss mid-recovery: replan next round against
                        # the store's current state
                        pass
                    ok = {r.name for r in metrics.records[first_record:]
                          if r.stage == st.name and r.status == "ok"}
                    todo = [iv for iv in st.invocations
                            if iv.name not in ok] or list(st.invocations)
        finally:
            if app is not None:
                tr.release_anchor(("stage", app, st.name))
                tr.end(ssp, recovery_rounds=rounds)

    def _run_stage_waves(self, todo: list[Invocation],
                         deps: tuple[str, ...]) -> None:
        """Admit a stage's invocations in waves as their producers commit.

        Every invocation in ``todo`` carries ``needs`` (producer invocation
        names); a wave is the subset whose needs are all committed. The
        commit listener wakes the wait, so a join partition starts the
        moment its input buckets are published — no stage barrier. The
        timeout re-check and the abort event keep a wave from outliving a
        failed producer stage.
        """
        invoker = self.runtime.invoker
        remaining = list(todo)
        while remaining:
            with self._ok_cond:
                while True:
                    if self._abort.is_set():
                        raise RecoveryError(
                            "pipelined stage abandoned: an upstream stage "
                            "failed while invocations awaited their "
                            "producers")
                    wave = [iv for iv in remaining
                            if set(iv.needs) <= self._ok]
                    if wave:
                        break
                    self._ok_cond.wait(timeout=0.1)
            launched = {iv.name for iv in wave}
            remaining = [iv for iv in remaining if iv.name not in launched]
            invoker.run_stage(wave, deps=deps)

    def _recover(self, err: StageLostError) -> None:
        """Re-execute the lost partitions' producers, bottom-up."""
        store = self.runtime.store
        lineage = self.runtime.lineage
        with self._recover_lock:
            lost_now = store.lost_partitions(err.app, err.stage)
            if not lost_now or (err.partitions is not None and
                                not lost_now & set(err.partitions)):
                return          # a concurrent driver already healed this
            # heal every partition of the stage that is currently lost, not
            # just the one read that tripped — a whole-stage loss read
            # partition-by-partition must cost one recovery round, not one
            # per partition (which would burn max_recoveries spuriously)
            target = sorted(lost_now)
            plan = lineage.recovery_plan(err.app, err.stage, target,
                                         store, metrics=self.runtime.metrics)
            if plan is None:
                raise RecoveryError(
                    f"{err.app!r}/{err.stage!r} lost but has no lineage "
                    f"(base input?): only a whole-query rerun can restore "
                    f"it") from err
            n_invs = sum(len(invs) for _, _, invs in plan)
            if self._recovery_choice(err, n_invs) == "rerun":
                raise RecoveryError(
                    f"{err.app!r}/{err.stage!r}: recovery policy chose "
                    f"whole-query rerun over recomputing {n_invs} "
                    f"invocations") from err
            tr = get_tracer()
            with tr.span(f"recovery/{err.stage}", "executor", trace=err.app,
                         parent=tr.anchored(("query", err.app)),
                         lost_stage=err.stage, partitions=list(target),
                         reexec_invocations=n_invs):
                for data_stage, parts, invs in plan:
                    if invs:
                        self.runtime.invoker.run_stage(invs, deps=())
                    # producers re-ran: any still-absent healed partition is
                    # genuinely empty, not missing — but only the partitions
                    # this plan covered
                    store.clear_lost(err.app, data_stage,
                                     None if parts is None else sorted(parts))
            self.runtime.recoveries.append(RecoveryEvent(
                err.app, err.stage, tuple(target),
                tuple(ds for ds, _, _ in plan), n_invs))

    def _recovery_choice(self, err: StageLostError, n_invs: int) -> str:
        if isinstance(self.recovery, DecisionNode):
            ctx = DecisionContext(
                node_status=self.runtime.gc.node_status(),
                profile={
                    "recovery.lost_stage": err.stage,
                    "recovery.reexec_invocations": n_invs,
                    "recovery.total_invocations":
                        self.runtime.lineage.total_invocations(err.app),
                })
            with bound_app(err.app):
                decision = self.recovery.decide(ctx)
            return "rerun" if decision.func == "rerun" else "recompute"
        return "rerun" if self.recovery == "rerun" else "recompute"


class Runtime:
    """The executable serverless substrate: store + invoker + metrics.

    ``invoker`` may be an ``Invoker`` instance or one of the backend names
    ``"inline"`` / ``"threads"`` / ``"process"`` (long-lived worker
    subprocesses — see ``repro_torch.runtime.workers``).

    ``device`` is where function bodies compute: the card unless the caller
    passes ``"cpu"``; an ``Invoker`` instance brings its own.
    """

    def __init__(self, gc: GlobalController,
                 invoker: Invoker | str = "inline",
                 store: ShuffleStore | None = None,
                 metrics: MetricsSink | None = None, max_workers: int = 8,
                 net_bw: float | None = None, disaggregated: bool = False,
                 batching: bool = True, storage="memory",
                 spill_backends=None, device=None):
        self.gc = gc
        # ``storage`` picks the store's primary backend (name or
        # StorageBackend instance); ``spill_backends`` adds colder tiers
        # the tiering decision may demote sealed stages into. Both are
        # ignored when an explicit ``store`` is supplied.
        self.store = store or ShuffleStore(net_bw=net_bw,
                                           disaggregated=disaggregated,
                                           backend=storage,
                                           spill_backends=spill_backends)
        self.metrics = metrics or MetricsSink()
        if isinstance(invoker, str):
            if invoker == "inline":
                invoker = InlineInvoker(gc, self.store, self.metrics,
                                        batching=batching, device=device)
            elif invoker == "threads":
                invoker = ThreadPoolInvoker(gc, self.store, self.metrics,
                                            max_workers=max_workers,
                                            batching=batching, device=device)
            elif invoker == "process":
                # imported lazily: the worker plane pulls multiprocessing
                # machinery most runtimes never need
                from repro_torch.runtime.workers import ProcessPoolInvoker
                invoker = ProcessPoolInvoker(gc, self.store, self.metrics,
                                             max_workers=max_workers,
                                             batching=batching,
                                             device=device)
            else:
                raise ValueError(f"unknown invoker backend {invoker!r}")
        elif device is not None and \
                torch.device(device) != invoker.device:
            raise ValueError(
                f"device {device!r} differs from the invoker's "
                f"{invoker.device}")
        self.invoker = invoker
        self.device = invoker.device
        self.lineage = LineageLog()
        self.recoveries: list[RecoveryEvent] = []

    def seed(self, app: str, stage: str, partitions,
             tier: str | None = None) -> list[tuple[int, int]]:
        """Load base data (``{node: table}`` or ``[(node, table), ...]`` for
        several partitions per node) into the store; ``tier`` seeds
        straight into a cold backend (the Lambada cold-data scenario).
        Returns the ``[(partition, home_node), ...]`` layout the planner
        places against.
        """
        return self.store.ingest(app, stage, partitions, tier=tier)

    def execute(self, stages: Sequence[RuntimeStage],
                pc: PrivateController | None = None,
                planner: StagePlanner | None = None,
                barrier: bool = False, max_recoveries: int = 8,
                recovery: str | DecisionNode = "lineage",
                pipeline: bool = False) -> dict[str, StageMetrics]:
        return DAGExecutor(self, barrier=barrier,
                           max_recoveries=max_recoveries,
                           recovery=recovery,
                           pipeline=pipeline).run(stages, pc=pc,
                                                  planner=planner)

    def result(self, app: str, stage: str = "result", column: str = "sum",
               ) -> np.ndarray:
        t = self.store.get(app, stage, 0, node=-1, account=False)
        if t is None:
            raise KeyError(f"no result blob for app {app!r}")
        return to_numpy(t[column])

    def release(self, app: str) -> int:
        """Tear down an application's ephemeral state; returns bytes freed."""
        return self.store.clear_app(app)

    def replay_into(self, sim, app: str | None = None,
                    rates: Mapping[str, float] | None = None) -> int:
        """Feed the invocation trace to a ``ClusterSim`` (one shared plan)."""
        return self.metrics.replay_into(sim, app=app, rates=rates)
