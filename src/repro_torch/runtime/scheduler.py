"""Multi-query scheduler: fair-share admission over the shared substrate.

The paper's second headline claim is *fine-grained resource sharing across
diverse applications*: many queries contending for one pool of function
slots (``GlobalController``) and one ephemeral shuffle store. This module
makes that concurrency a first-class citizen. A ``QueryScheduler`` admits N
queries — each with its **own** ``DecisionWorkflow`` and DAG executor run —
against one shared ``Runtime``, under a pluggable policy:

* ``fifo``       — queries run one at a time in arrival order (the
                   baseline a naive job queue gives you),
* ``priority``   — one at a time, highest priority first (strict,
                   non-preemptive across queries),
* ``fair_share`` — all queries run concurrently; a ``FairShareGate``
                   rations the *function slots* by weighted max-min
                   fairness, so a heavy low-priority query cannot crowd
                   out a light high-priority one, yet idle entitlement is
                   work-conservingly redistributed.

Invocations still claim real slots through the controller, so priorities
keep their Omega-style preemption semantics underneath the gate; the gate
only decides *who may ask next*. Per-job store quotas (``QueryJob.quota``)
bound each tenant's live shuffle footprint through the store's
eviction/backpressure machinery.

Every query runs where the shared runtime runs (``Runtime.device``: the
card unless the runtime was built with ``device="cpu"``): the scheduler
prepares each plan against that runtime and never moves data itself.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.decisions import worker_pool_target
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.invoker import Invocation, SlotGate

POLICIES = ("fifo", "priority", "fair_share")


def default_weight(priority: int) -> float:
    """Default priority→fair-share-weight mapping, shared by ``QueryJob``
    and the gate's auto-registration of unmanaged apps."""
    return 1.0 + max(0, priority)


class GateTimeoutError(RuntimeError):
    """A fair-share gate acquisition did not succeed within the timeout."""


@dataclass
class QueryJob:
    """One query submitted to the scheduler.

    ``weight`` is the fair-share weight over function slots; by default it
    tracks priority (``1 + max(0, priority)``) so higher-priority tenants
    hold proportionally more slots. ``quota`` caps the app's live bytes in
    the shared shuffle store (see ``ShuffleStore.set_quota``).
    """

    app: str
    fact: Any                      # DistTable
    dim: Any                       # DistTable
    strategy: Any                  # QueryStrategy | strategy name
    priority: int = 0
    weight: float | None = None
    num_groups: int = 64
    quota: int | None = None
    workflow: Any = None           # optional pre-built DecisionWorkflow

    def fair_weight(self) -> float:
        return self.weight if self.weight is not None \
            else default_weight(self.priority)


@dataclass
class QueryResult:
    """Outcome + closed-loop timing of one scheduled query."""

    app: str
    priority: int = 0
    sums: Any = None
    error: BaseException | None = None
    submitted: float = 0.0         # monotonic, at submit()
    started: float = 0.0           # admission (execution begin)
    finished: float = 0.0
    decisions: list = field(default_factory=list)   # (stage, Decision) seq
    recoveries: list = field(default_factory=list)  # RecoveryEvents healed
    stages: dict = field(default_factory=dict)      # {stage: StageMetrics}

    @property
    def ok(self) -> bool:
        return self.error is None and self.finished > 0

    @property
    def latency(self) -> float:
        """Closed-loop latency: submission -> completion (includes queueing)."""
        return self.finished - self.submitted

    @property
    def queue_wait(self) -> float:
        return self.started - self.submitted

    @property
    def run_seconds(self) -> float:
        return self.finished - self.started


class FairShareGate(SlotGate):
    """Weighted max-min fair rationing of function slots across apps.

    Each registered app is entitled to ``weight / Σ weights × total_slots``
    slots (floored, min 1 — so every admitted query keeps making progress).
    An app under its entitlement may always take a slot; an app at or over
    it may take one only work-conservingly: when free slots remain *and* no
    other app with blocked demand is still under-served. Invokers hold a
    gate token exactly while they hold the controller claim, and give it
    back while blocked on the controller's release event, so the gate never
    deadlocks against per-node contention.
    """

    def __init__(self, total_slots: int, timeout: float = 60.0):
        self._cond = threading.Condition()
        self.total = int(total_slots)
        self.timeout = timeout
        self.weights: dict[str, float] = {}
        self.in_use: dict[str, int] = {}
        self._waiting: dict[str, int] = {}

    # -- membership ----------------------------------------------------------

    def register(self, app: str, weight: float = 1.0) -> None:
        with self._cond:
            self.weights[app] = max(1e-6, float(weight))
            self.in_use.setdefault(app, 0)
            self._waiting.setdefault(app, 0)
            self._cond.notify_all()

    def unregister(self, app: str) -> None:
        """Drop a finished app; its entitlement redistributes immediately."""
        with self._cond:
            self.weights.pop(app, None)
            self.in_use.pop(app, None)
            self._waiting.pop(app, None)
            self._cond.notify_all()

    # -- arithmetic (caller holds the condition) -----------------------------

    def entitlement(self, app: str) -> int:
        total_w = sum(self.weights.values())
        if not total_w or app not in self.weights:
            return self.total
        return max(1, int(self.weights[app] / total_w * self.total))

    def _may_take(self, app: str) -> bool:
        if sum(self.in_use.values()) >= self.total:
            return False
        if self.in_use.get(app, 0) < self.entitlement(app):
            return True
        # over entitlement: only while no under-served app has blocked demand
        for other, n_wait in self._waiting.items():
            if other == app or not n_wait:
                continue
            if self.in_use.get(other, 0) < self.entitlement(other):
                return False
        return True

    # -- SlotGate ------------------------------------------------------------

    def acquire(self, inv: Invocation) -> None:
        app = inv.app
        deadline = time.monotonic() + self.timeout
        with self._cond:
            if app not in self.weights:   # unmanaged app: default weight
                self.register(app, default_weight(inv.priority))
            self._waiting[app] += 1
            try:
                while not self._may_take(app):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise GateTimeoutError(
                            f"{inv.name}: no fair-share slot for {app!r} "
                            f"within {self.timeout}s "
                            f"(in_use={dict(self.in_use)})")
                    self._cond.wait(remaining)
                self.in_use[app] = self.in_use.get(app, 0) + 1
            finally:
                self._waiting[app] -= 1
                # this app's demand being served (or withdrawn) can make
                # work-conserving admission legal for an over-entitled
                # waiter — wake them to re-check
                self._cond.notify_all()

    def release(self, inv: Invocation) -> None:
        with self._cond:
            if self.in_use.get(inv.app, 0) > 0:
                self.in_use[inv.app] -= 1
            self._cond.notify_all()


class QueryScheduler:
    """Admits and drives N concurrent queries over one shared ``Runtime``.

    Usage::

        sched = QueryScheduler(runtime, policy="fair_share")
        sched.submit(QueryJob("etl_hi", fact, dim, "dynamic", priority=10))
        sched.submit(QueryJob("adhoc_lo", fact2, dim2, "static_hash"))
        results = sched.run()          # {app: QueryResult}

    ``fifo``/``priority`` admit one query at a time (``max_concurrent``
    widens the window while preserving admission order); ``fair_share``
    admits every query and installs a ``FairShareGate`` on the runtime's
    invoker. ``release_stores=True`` tears down each app's shuffle state as
    its result is captured (long workload mixes stay bounded).
    """

    def __init__(self, runtime, policy: str = "fair_share",
                 max_concurrent: int | None = None,
                 gate_timeout: float = 60.0, release_stores: bool = False,
                 recovery="lineage", max_recoveries: int = 8,
                 compact_metrics: bool = False):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; pick from {POLICIES}")
        self.runtime = runtime
        self.policy = policy
        self.max_concurrent = max_concurrent
        self.release_stores = release_stores
        # service-mode compaction: snapshot each query's per-stage metrics
        # into its QueryResult, then drop the raw records from the shared
        # sink so a long workload mix stays bounded
        self.compact_metrics = compact_metrics
        # failure-handling policy shared by every admitted query: lineage
        # recompute (default), whole-query rerun, or a recovery DecisionNode
        self.recovery = recovery
        self.max_recoveries = max_recoveries
        self.jobs: list[QueryJob] = []
        self.results: dict[str, QueryResult] = {}
        self.gate: FairShareGate | None = None
        if policy == "fair_share":
            total = sum(runtime.gc.total.values())
            self.gate = FairShareGate(total, timeout=gate_timeout)

    # -- submission ----------------------------------------------------------

    def submit(self, job: QueryJob) -> QueryResult:
        if job.app in self.results:
            raise ValueError(f"duplicate app {job.app!r}")
        self.jobs.append(job)
        res = QueryResult(job.app, priority=job.priority,
                          submitted=time.monotonic())
        self.results[job.app] = res
        return res

    # -- execution -----------------------------------------------------------

    def _ordered(self) -> list[QueryJob]:
        if self.policy == "priority":
            # stable: ties keep arrival order
            return sorted(self.jobs, key=lambda j: -j.priority)
        return list(self.jobs)

    def _window(self) -> int:
        if self.max_concurrent is not None:
            return max(1, self.max_concurrent)
        return len(self.jobs) if self.policy == "fair_share" else 1

    def run(self) -> dict[str, QueryResult]:
        """Drive every submitted query to completion; returns the results.

        Admission order and window follow the policy; each admitted query
        runs its own ``AdaptiveQueryPlan`` through the shared runtime's DAG
        executor in a dedicated driver thread, on the runtime's device.
        """
        prev_gate = self.runtime.invoker.gate
        if self.gate is not None:
            self.runtime.invoker.gate = self.gate
        self._grow_for_queue()
        try:
            window = threading.BoundedSemaphore(self._window())
            threads = []
            for job in self._ordered():
                window.acquire()       # blocks: strict admission order
                t = threading.Thread(target=self._run_job,
                                     args=(job, window),
                                     name=f"query-{job.app}")
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
        finally:
            if self.gate is not None:
                self.runtime.invoker.gate = prev_gate
        return dict(self.results)

    # admission-time demand estimate: each admitted query immediately fans
    # out a scan wave at least this many invocations wide
    QUEUE_TASKS_PER_QUERY = 4

    def _grow_for_queue(self) -> None:
        """Queue-depth elasticity — the scheduler's half of the elastic
        control loop (the planner's ``elastic`` decision node is the
        per-stage half). Before the drivers start, a process-backed
        invoker is pre-grown for the admission backlog, so the first scan
        waves lease warm workers instead of paying one cold start each on
        the queries' critical paths. Sized by the shared
        ``worker_pool_target`` rule; backends without a pool are left
        alone. Scale-in is not forced here: the pool's idle reaper (and
        the per-stage elastic decision) shrink it once the burst drains.
        """
        resize = getattr(self.runtime.invoker, "resize", None)
        pool_size = getattr(self.runtime.invoker, "pool_size", None)
        if not (callable(resize) and callable(pool_size)) or not self.jobs:
            return
        depth = min(self._window(), len(self.jobs))
        target = worker_pool_target(
            depth * self.QUEUE_TASKS_PER_QUERY, pool_size(),
            tasks_per_worker=self.QUEUE_TASKS_PER_QUERY)
        if target > pool_size():
            resize(target)

    def _run_job(self, job: QueryJob, window: threading.Semaphore) -> None:
        from repro_torch.analytics.query import (QueryStrategy,
                                                 prepare_query_plan)

        res = self.results[job.app]
        strategy = job.strategy if not isinstance(job.strategy, str) \
            else QueryStrategy(job.strategy)
        if job.quota is not None:
            self.runtime.store.set_quota(job.app, job.quota)
        if self.gate is not None:
            self.gate.register(job.app, job.fair_weight())
        res.started = time.monotonic()
        # query root span: every stage/invocation/store span of this app
        # parents (transitively) to it via the ("query", app) anchor; the
        # admission wait (submit -> driver start) is recorded retroactively
        tr = get_tracer()
        root = tr.start(f"query/{job.app}", "scheduler", trace=job.app,
                        parent=None, policy=self.policy,
                        priority=job.priority)
        tr.anchor(("query", job.app), root)
        admit_wait = res.started - res.submitted
        if admit_wait > 1e-4:
            now = time.perf_counter()
            tr.record("admission_wait", "wait", now - admit_wait, end=now,
                      trace=job.app, parent=root, policy=self.policy)
        try:
            plan, pc = prepare_query_plan(
                self.runtime, job.fact, job.dim, strategy, app=job.app,
                priority=job.priority, num_groups=job.num_groups,
                workflow=job.workflow)
            self.runtime.execute(plan.initial_stages(), pc=pc, planner=plan,
                                 recovery=self.recovery,
                                 max_recoveries=self.max_recoveries)
            res.sums = self.runtime.result(job.app)
            res.decisions = list(plan.run.sequence)
        except BaseException as e:  # noqa: BLE001 - surfaced via QueryResult
            res.error = e
        finally:
            res.recoveries = [ev for ev in self.runtime.recoveries
                              if ev.app == job.app]
            res.finished = time.monotonic()
            res.stages = self.runtime.metrics.by_stage(job.app)
            if self.compact_metrics:
                self.runtime.metrics.clear(job.app)
            tr.release_anchor(("query", job.app))
            tr.end(root, status="error" if res.error is not None else "ok")
            if self.gate is not None:
                self.gate.unregister(job.app)
            if job.quota is not None:
                # parity with the quota-less path once the query is done:
                # sealed (consumed-ephemeral) stages are garbage, and the
                # quota must not bind a future app reusing the name
                self.runtime.store.drop_sealed(job.app)
                self.runtime.store.set_quota(job.app, None)
            if self.release_stores:
                self.runtime.release(job.app)
            window.release()

    # -- workload summaries --------------------------------------------------

    def makespan(self) -> float:
        done = [r for r in self.results.values() if r.finished]
        if not done:
            return 0.0
        return max(r.finished for r in done) - \
            min(r.submitted for r in done)

    def latencies(self, min_priority: int | None = None) -> list[float]:
        return sorted(r.latency for r in self.results.values()
                      if r.ok and (min_priority is None
                                   or r.priority >= min_priority))
