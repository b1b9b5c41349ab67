"""Pluggable function-invocation backends.

An ``Invocation`` names a registered function, the node it should run on and
its priority. The invoker is the runtime half of the paper's substrate: for
every invocation it claims one function slot through the real
``GlobalController`` (Omega-style optimistic commit), runs the function in a
stateless ``FnContext`` over the shuffle store, and releases the slot. If a
higher-priority application preempted the claim while the function ran, the
result is discarded and the invocation retried — safe precisely because
functions are stateless and every write lands in the store under the
invocation's own writer label (retry overwrites, never duplicates).

Batched map invocations: invocations carrying ``batchable=True`` (the
planner sets it on map-shaped stages — scans, shuffle writes, broadcast
writes, partial aggregates) that share a (stage, function, node) are
**coalesced** into one batched call: one slot claim serves the whole group,
whose members run back-to-back with their own ``FnContext``, metrics record
and fault-injection hooks — so a 32-partition scan is a handful of claims
and dispatches, not 32 interpreter round trips, while the control plane
(decision sequences, per-stage record counts, lineage, fault match counts)
sees exactly what unbatched execution would produce. A batch that crashes
or loses its claim demotes the unfinished members to individual execution
with the full per-invocation retry machinery. ``batching=False`` disables
coalescing entirely (the differential baseline).

Two backends:

* ``InlineInvoker``     — sequential, deterministic (tests, oracles).
* ``ThreadPoolInvoker`` — real parallelism across function slots (batches
  from one stage run concurrently, one worker per group).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.controllers import GlobalController
from repro_torch.device import resolve_device
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.faults import InjectedCrashError
from repro_torch.runtime.metrics import InvocationRecord, MetricsSink
from repro_torch.runtime.store import PrefetchHandle, ShuffleStore


def _padding_snapshot() -> tuple[int, int]:
    from repro_torch.kernels.ops import padding_counters
    return padding_counters()


class SlotGate:
    """Admission control over slot claims, consulted before the controller.

    A scheduler policy (e.g. the reference's weighted fair share gate)
    installs a gate on the shared invoker; ``acquire`` blocks until the
    invocation's application may take one more function slot, ``release``
    returns the token. The default gate admits everything. A batched call
    holds exactly one token — it occupies one function slot.
    """

    def acquire(self, inv: "Invocation") -> None:  # pragma: no cover
        return None

    def release(self, inv: "Invocation") -> None:  # pragma: no cover
        return None


@dataclass(frozen=True)
class Invocation:
    """One stateless function instance of a stage.

    ``batchable`` marks map-shaped invocations (per-partition, no cross-
    partition reads) the invoker may coalesce with same-stage same-function
    same-node siblings into one slot claim; correctness never depends on it
    — it is purely a dispatch-overhead knob.
    """

    name: str                      # e.g. "query/join/3"
    app: str
    stage: str
    index: int
    func: str                      # key into the function registry
    node: int
    priority: int = 0
    params: Mapping[str, Any] = field(default_factory=dict)
    batchable: bool = False
    # producer invocation names whose commits make THIS invocation's inputs
    # complete — partition-granularity readiness for the pipelined executor
    # (empty: only whole-stage dependencies gate it, the barrier semantics)
    needs: tuple = ()


class FnContext:
    """What a function instance sees: namespaced store access + its params.

    All store traffic flows through here so the invoker can attribute
    bytes-in/out (and per-source read volumes) to the invocation —
    and so the time an invocation spends against the store
    (``store_seconds``) is split from its on-device compute in the
    invocation record (the compute-vs-transfer breakdown decision nodes
    read out of ``profile_feedback``).
    """

    def __init__(self, store: ShuffleStore, inv: Invocation,
                 honor_plan: bool = False, *, device):
        self._store = store
        # the device this invocation computes on: functions move what they
        # read onto it (``analytics.table.on_device``) before computing
        self.device = torch.device(device)
        self.app = inv.app
        self.node = inv.node
        self.index = inv.index
        self.params = dict(inv.params)
        self.writer = inv.name
        self.honor_plan = honor_plan
        self.bytes_in = 0
        self.bytes_out = 0
        self.store_seconds = 0.0
        self.rows_actual = 0
        self.rows_padded = 0
        # free-form per-invocation observations a function body emits for
        # profile_feedback (e.g. shuffle_write's per-bucket histogram and
        # heavy-hitter sketch); values must be picklable — the process
        # backend marshals them home with the worker metrics
        self.stats: dict[str, Any] = {}
        self.reads_by_node: dict[int, int] = {}
        self.writes: list[tuple[str, int]] = []   # lineage: (stage, part)
        self._prefetched: dict[tuple[str, int], PrefetchHandle] = {}
        self._pf_lock = threading.Lock()

    @property
    def plan(self) -> str:
        """The pipeline decision's mode for this invocation ("barrier" /
        "pipelined" / "fused") — reads as "barrier" unless the executor was
        launched with pipelining enabled, so the data-plane fast paths stay
        inert when the knob is off (the invisibility baseline)."""
        if not self.honor_plan:
            return "barrier"
        return str(self.params.get("plan", "barrier"))

    def prefetch(self, stage: str, partition: int) -> None:
        """Start fetching ``(stage, partition)`` on a background thread.

        A later ``get`` of the same key joins the handle and charges ONLY
        the blocked remainder to ``store_seconds`` — overlap between the
        fetch and the caller's compute is the pipelining win. Read-source
        and byte accounting happen exactly once (in the worker, merged at
        join time), so store traffic totals are identical to an unprefetched
        read; the store-side fault hook (``on_get``) fires from the worker
        with the same per-(app, stage) ordering a direct read would produce.
        Duplicate prefetches of a live key are no-ops.
        """
        key = (stage, int(partition))
        with self._pf_lock:
            if key in self._prefetched:
                return
            tr = get_tracer()
            parent = tr.current()     # the invocation span of the issuer
            store, app, node = self._store, self.app, self.node
            # a device concat inside the read is enqueued on the prefetching
            # invocation's stream, ordered before its own use of the result
            stream = torch.cuda.current_stream(self.device) \
                if self.device.type == "cuda" else None

            def fetch():
                # the fetch runs on a background thread whose span stack is
                # empty: adopt the issuing invocation's span so the store's
                # own get spans parent to it instead of landing orphaned
                with tr.adopt(parent), torch.cuda.stream(stream):
                    sources = store.read_sources(app, stage, key[1], node)
                    t0 = time.perf_counter()
                    try:
                        t = store.get(app, stage, key[1], node)
                    finally:
                        tr.record(f"prefetch/{stage}/{key[1]}", "store", t0,
                                  trace=app, node=node, parent=parent,
                                  kind="prefetch")
                    return t, sources

            self._prefetched[key] = PrefetchHandle(fetch)

    def get(self, stage: str, partition: int, writers=None):
        # a writer-restricted read never consults the prefetch cache: a
        # prefetched handle holds the FULL partition, not the caller's shard
        with self._pf_lock:
            handle = None if writers is not None else \
                self._prefetched.pop((stage, int(partition)), None)
        if handle is not None:
            t0 = time.perf_counter()
            try:
                t, sources = handle.join()
            finally:
                # only the blocked tail counts: the overlapped fetch time
                # is exactly what pipelining saved
                self.store_seconds += time.perf_counter() - t0
            for src, b in sources.items():
                self.reads_by_node[src] = self.reads_by_node.get(src, 0) + b
            if t is not None:
                self.bytes_in += int(t.nbytes)
            return t
        for src, b in self._store.read_sources(
                self.app, stage, partition, self.node,
                writers=writers).items():
            self.reads_by_node[src] = self.reads_by_node.get(src, 0) + b
        t0 = time.perf_counter()
        try:
            t = self._store.get(self.app, stage, partition, self.node,
                                writers=writers)
        finally:
            self.store_seconds += time.perf_counter() - t0
        if t is not None:
            self.bytes_in += int(t.nbytes)
        return t

    def get_all(self, stage: str):
        from repro_torch.analytics.table import Table
        got = [t for t in (self.get(stage, p)
                           for p in self.partitions(stage))
               if t is not None and t.num_rows]
        return Table.concat_all(got) if got else None

    @staticmethod
    def _force(table) -> None:
        # Externalizing state means materializing it: wait for the device
        # work that produced the columns (for a TableSlice, its shared
        # *parent* buffer — no copy) so each invocation pays for its own
        # compute before the blob is published (otherwise CUDA's async
        # launches defer whole-query work into whichever downstream reader
        # first forces a value, scrambling per-stage metrics and stage
        # overlap alike). This wait is charged to compute, not store time.
        # It is a CUDA event recorded on the current stream after the
        # invocation's last launch; under the threads invoker that is the
        # worker's own stream, so the wait covers this invocation's
        # launches and not other workers'.
        cols = getattr(table, "parent_columns", None)
        if cols is None:
            cols = getattr(table, "columns", None)
        devs = {v.device for v in (cols or {}).values()
                if isinstance(v, torch.Tensor) and v.is_cuda}
        for dev in devs:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()

    def put(self, stage: str, partition: int, table) -> None:
        self._force(table)
        t0 = time.perf_counter()
        try:
            self.bytes_out += self._store.put(
                self.app, stage, partition, table, self.node,
                writer=self.writer)
        finally:
            self.store_seconds += time.perf_counter() - t0
        self.writes.append((stage, partition))

    def put_many(self, stage: str, tables: Mapping[int, Any]) -> None:
        """Publish many partitions in one store round trip (the columnar
        shuffle path: every bucket a slice of one parent buffer)."""
        if not tables:
            return
        for table in tables.values():
            self._force(table)
        t0 = time.perf_counter()
        try:
            self.bytes_out += self._store.put_many(
                self.app, stage, tables, self.node, writer=self.writer)
        finally:
            self.store_seconds += time.perf_counter() - t0
        self.writes.extend((stage, int(p)) for p in sorted(tables))

    def partitions(self, stage: str) -> list[int]:
        return self._store.partitions(self.app, stage)


class InvocationError(RuntimeError):
    pass


class Invoker:
    """Shared claim/execute/release machinery; subclasses pick concurrency.

    ``intercept`` is a fault-injection hook (tests, chaos drills): it runs
    after the slot claim commits and before the function body, i.e. while the
    claim is live and preemptible.

    ``parallel`` advertises whether ``run_stage`` may be driven for several
    stages concurrently — the dependency-driven executor overlaps
    independent stages only on parallel backends.

    A failed claim blocks on the controller's release event (bounded per
    attempt by ``starve_wait``, default ``RELEASE_WAIT``) instead of busy
    spinning, so a starved invocation wakes the moment a slot frees and
    ``max_attempts`` bounds only genuinely stuck claims. ``gate`` is an
    optional ``SlotGate`` a scheduler installs to ration slots across
    applications; the gate token is held exactly while the claim is.

    ``batching`` enables coalescing of ``batchable`` invocations into
    per-(stage, function, node) groups of at most ``max_batch`` members;
    every member keeps its own metrics record and injector hook calls, so
    batching is invisible to the control plane.

    ``device`` is where function bodies compute: the card unless the caller
    passes ``"cpu"`` (``repro_torch.device.resolve_device``).
    """

    parallel = False
    RELEASE_WAIT = 0.1      # max seconds blocked per attempt on the event

    def __init__(self, gc: GlobalController, store: ShuffleStore,
                 metrics: MetricsSink | None = None, max_attempts: int = 5,
                 starve_wait: float = 0.0,
                 intercept: Callable[[Invocation, int], None] | None = None,
                 gate: SlotGate | None = None, injector=None,
                 batching: bool = True, max_batch: int = 16, device=None):
        self.gc = gc
        self.device = resolve_device(device)
        self.store = store
        self.metrics = metrics or MetricsSink()
        self.max_attempts = max_attempts
        self.starve_wait = starve_wait
        self.intercept = intercept
        self.gate = gate
        self.injector = injector
        self.batching = batching
        self.max_batch = max_batch
        # set by the executor for pipelined runs: function bodies then honor
        # the planner's per-invocation "plan" parameter (prefetch / fused
        # kernel); off by default so direct invoker use stays barrier-exact
        self.honor_plan = False
        self.registry: Mapping[str, Callable[[FnContext], Any]] | None = None

    def _resolve(self, name: str) -> Callable[[FnContext], Any]:
        if self.registry is None:
            from repro_torch.runtime.functions import FUNCTIONS
            self.registry = FUNCTIONS
        try:
            return self.registry[name]
        except KeyError:
            raise InvocationError(f"unregistered function {name!r}") from None

    # -- grouping -------------------------------------------------------------

    def _groups(self, invocations: Sequence[Invocation],
                ) -> list[list[Invocation]]:
        """Coalesce batchable invocations sharing (stage, func, node, app,
        priority) into groups of at most ``max_batch``, preserving
        first-appearance order; everything else stays a singleton.

        A non-batchable invocation is a sequencing point: it CLOSES every
        open group, so a later same-key batchable invocation can never be
        pulled back across it (a group held open across arbitrarily many
        interleaved non-batchable invocations would let a late member
        execute at the group's first-appearance position, an unbounded
        submission-vs-execution reorder). Residual reordering — a batchable
        invocation coalescing backwards past *batchable* siblings of other
        keys — is bounded per group by ``max_batch`` members and only ever
        occurs among map-shaped instances of one ``run_stage`` call, which
        carry no mutual ordering semantics.
        """
        groups: list[list[Invocation]] = []
        open_group: dict[tuple, int] = {}
        for inv in invocations:
            if not (self.batching and inv.batchable):
                open_group.clear()
                groups.append([inv])
                continue
            key = (inv.stage, inv.func, inv.node, inv.app, inv.priority)
            at = open_group.get(key)
            if at is not None and len(groups[at]) < self.max_batch:
                groups[at].append(inv)
            else:
                open_group[key] = len(groups)
                groups.append([inv])
        return groups

    # -- function-body execution hook -----------------------------------------

    def _invoke_body(self, fn: Callable[[FnContext], Any], inv: Invocation,
                     attempt: int) -> FnContext:
        """Run one function body and return its populated ``FnContext`` —
        the single extension point a worker-plane backend overrides.

        The default executes ``fn`` in-process. A worker-plane backend
        (the reference's ``ProcessPoolInvoker``, not yet ported) ships the
        invocation to a worker subprocess instead and raises
        ``InjectedCrashError`` subclasses (e.g. ``WorkerKilledError``) to
        surface a dead worker as a crashed attempt.
        """
        ctx = FnContext(self.store, inv, honor_plan=self.honor_plan,
                        device=self.device)
        pad0 = _padding_snapshot()
        fn(ctx)
        pad1 = _padding_snapshot()
        ctx.rows_actual = pad1[0] - pad0[0]
        ctx.rows_padded = pad1[1] - pad0[1]
        return ctx

    def _execute_group(self, group: list[Invocation],
                       deps: tuple[str, ...]) -> None:
        if len(group) == 1:
            self._execute_one(group[0], deps)
        else:
            self._execute_batch(group, deps)

    # -- single-invocation path -----------------------------------------------

    def _execute_one(self, inv: Invocation, deps: tuple[str, ...],
                     first_attempt: int = 0) -> None:
        """Claim → run → release for one invocation. ``first_attempt``
        offsets the attempt numbering for members demoted out of a crashed
        or preempted batch, so retry attempts (and the fault plan's
        ``attempt`` matching) continue where the batch left off — against
        the same total ``max_attempts`` budget, so an invocation that
        crashes on every attempt exhausts identically batched or not.

        The whole claim/execute/retry loop runs under one ``invoker`` span
        (parented to the executor's anchored stage span); each attempt adds
        a child attempt span, each blocked acquisition a child ``wait``
        span, and store traffic inside the function body nests via the
        thread-local span stack.
        """
        tr = get_tracer()
        if not tr.enabled:
            return self._execute_one_traced(inv, deps, first_attempt, tr,
                                            None)
        parent = tr.anchored(("stage", inv.app, inv.stage))
        kw = {} if parent is None else {"parent": parent}
        with tr.span(inv.name, "invoker", trace=inv.app, node=inv.node,
                     stage=inv.stage, func=inv.func, kind="invocation",
                     **kw) as sp:
            return self._execute_one_traced(inv, deps, first_attempt, tr, sp)

    def _execute_one_traced(self, inv: Invocation, deps: tuple[str, ...],
                            first_attempt: int, tr, sp) -> None:
        fn = self._resolve(inv.func)
        wait = self.starve_wait if self.starve_wait > 0 else self.RELEASE_WAIT
        for attempt in range(first_attempt, self.max_attempts):
            if self.gate is not None:
                tg = time.perf_counter()
                self.gate.acquire(inv)
                if sp is not None and time.perf_counter() - tg > 1e-4:
                    tr.record("gate_wait", "wait", tg, trace=inv.app,
                              node=inv.node, parent=sp, attempt=attempt)
            claim = None
            try:
                # Sample the node's release epoch *before* the attempt: if
                # the claim fails and a slot frees in between,
                # wait_for_release returns immediately — no lost wakeup.
                epoch = self.gc.release_epoch(inv.node)
                claim = self.gc.try_commit(inv.app, inv.priority, [inv.node],
                                           tag=inv.name)
            finally:
                # no claim taken (conflict, unknown node, a listener raising
                # mid-commit): the gate token must not leak
                if claim is None and self.gate is not None:
                    self.gate.release(inv)
            if claim is None:
                # every slot on the node is held by >=-priority work: block
                # until a claim on *this* node releases (unrelated nodes'
                # churn must not burn the retry budget), then retry
                tw = time.perf_counter()
                self.gc.wait_for_release(epoch, timeout=wait, node=inv.node)
                if sp is not None:
                    tr.record("slot_wait", "wait", tw, trace=inv.app,
                              node=inv.node, parent=sp, attempt=attempt)
                continue
            tr.count(f"slots/node{inv.node}", 1, delta=True)
            crashed = None
            # timed from claim commit: injected latency (stragglers) is part
            # of the invocation's observed duration, which is what the
            # speculation policy and the tail benchmarks reason about
            t0 = time.perf_counter()
            try:
                try:
                    if self.intercept is not None:
                        self.intercept(inv, attempt)
                    if self.injector is not None:
                        self.injector.before_body(inv, attempt)
                    ctx = self._invoke_body(fn, inv, attempt)
                    if self.injector is not None:
                        self.injector.after_body(inv, attempt)
                except InjectedCrashError as e:
                    # an injected function crash: release the slot, record
                    # the death, and retry on the next attempt (stateless
                    # functions + writer-label overwrite make a
                    # crash-after-write retry safe — it replaces, never
                    # duplicates)
                    crashed = e
                    self.gc.finish(claim)
                    tr.count(f"slots/node{inv.node}", -1, delta=True)
                except BaseException:
                    # any other failure while the claim is live — the
                    # registered function itself raising, the intercept
                    # hook, a StageLostError from the store — must release
                    # the slot, not leak it (a leaked slot deadlocks
                    # FairShareGate accounting)
                    self.gc.finish(claim)
                    tr.count(f"slots/node{inv.node}", -1, delta=True)
                    self.metrics.record(InvocationRecord(
                        inv.name, inv.app, inv.stage, inv.func, inv.node,
                        attempt, "error", t0, time.perf_counter(), deps=deps,
                        priority=inv.priority))
                    if sp is not None:
                        sp.attrs.update(status="error", attempts=attempt + 1)
                        tr.record(f"attempt/{attempt}", "invoker", t0,
                                  trace=inv.app, node=inv.node, parent=sp,
                                  kind="attempt", status="error")
                    raise
                if crashed is None:
                    t1 = time.perf_counter()
                    committed = self.gc.finish(claim)
                    tr.count(f"slots/node{inv.node}", -1, delta=True)
            finally:
                if self.gate is not None:
                    self.gate.release(inv)
            if crashed is not None:
                self.metrics.record(InvocationRecord(
                    inv.name, inv.app, inv.stage, inv.func, inv.node,
                    attempt, "crashed", t0, time.perf_counter(), deps=deps,
                    priority=inv.priority))
                if sp is not None:
                    tr.record(f"attempt/{attempt}", "invoker", t0,
                              trace=inv.app, node=inv.node, parent=sp,
                              kind="attempt", status="crashed")
                continue
            status = "ok" if committed else "preempted"
            self.metrics.record(InvocationRecord(
                inv.name, inv.app, inv.stage, inv.func, inv.node, attempt,
                status, t0, t1,
                bytes_in=ctx.bytes_in, bytes_out=ctx.bytes_out,
                store_seconds=ctx.store_seconds,
                reads_by_node=dict(ctx.reads_by_node), deps=deps,
                priority=inv.priority, writes=tuple(ctx.writes),
                rows_actual=ctx.rows_actual, rows_padded=ctx.rows_padded,
                stats=dict(ctx.stats)))
            if sp is not None:
                sp.attrs.update(status=status, attempts=attempt + 1)
                tr.record(f"attempt/{attempt}", "invoker", t0, end=t1,
                          trace=inv.app, node=inv.node, parent=sp,
                          kind="attempt", status=status)
            if committed:
                return
        self.metrics.record(InvocationRecord(
            inv.name, inv.app, inv.stage, inv.func, inv.node,
            self.max_attempts, "starved",
            time.perf_counter(), time.perf_counter(), deps=deps,
            priority=inv.priority))
        if sp is not None:
            sp.attrs.update(status="starved", attempts=self.max_attempts)
        raise InvocationError(
            f"{inv.name}: no slot committed after {self.max_attempts} "
            f"attempts (preempted/starved by higher-priority claims, or "
            f"repeatedly crashed)")

    # -- batched path ---------------------------------------------------------

    def _record_member(self, inv: Invocation, attempt: int, status: str,
                       t0: float, t1: float, deps: tuple[str, ...],
                       ctx: FnContext | None = None) -> None:
        self.metrics.record(InvocationRecord(
            inv.name, inv.app, inv.stage, inv.func, inv.node, attempt,
            status, t0, t1,
            bytes_in=ctx.bytes_in if ctx else 0,
            bytes_out=ctx.bytes_out if ctx else 0,
            store_seconds=ctx.store_seconds if ctx else 0.0,
            reads_by_node=dict(ctx.reads_by_node) if ctx else {},
            deps=deps, priority=inv.priority,
            writes=tuple(ctx.writes) if ctx else (),
            rows_actual=ctx.rows_actual if ctx else 0,
            rows_padded=ctx.rows_padded if ctx else 0,
            stats=dict(ctx.stats) if ctx else {}))

    def _execute_batch(self, invs: list[Invocation],
                       deps: tuple[str, ...]) -> None:
        """One slot claim serves the whole group; members run back-to-back
        under it, each with its own ``FnContext``, intercept/injector hook
        calls and metrics record (timed per member) — so match counts,
        lineage writes and per-partition metrics are exactly what
        invocation-at-a-time execution would produce.

        Failure demotion: a member crash releases the claim, records the
        crash, and re-executes the crashed member (next attempt number) and
        the never-started members (same attempt number) *individually* —
        the full per-invocation retry machinery. A claim preempted
        mid-batch discards and individually retries every member. Any
        other exception (a lost shuffle stage, the function raising)
        records completed members, releases the slot and propagates, which
        is what the executor's recovery loop expects.
        """
        tr = get_tracer()
        first = invs[0]
        if not tr.enabled:
            retry = self._execute_batch_traced(invs, deps, tr, None)
        else:
            parent = tr.anchored(("stage", first.app, first.stage))
            kw = {} if parent is None else {"parent": parent}
            with tr.span(f"batch/{first.stage}@{first.node}", "invoker",
                         trace=first.app, node=first.node, stage=first.stage,
                         func=first.func, kind="batch", members=len(invs),
                         **kw) as sp:
                if sp is not None:
                    sp.attrs["demoted"] = 0
                retry = self._execute_batch_traced(invs, deps, tr, sp)
                if sp is not None:
                    sp.attrs["demoted"] = len(retry)
        # demotion runs *outside* the batch span: the demoted members are no
        # longer under the batch claim and open their own invocation spans
        for inv, first_attempt in retry:
            self._execute_one(inv, deps, first_attempt=first_attempt)

    def _execute_batch_traced(self, invs: list[Invocation],
                              deps: tuple[str, ...], tr, sp,
                              ) -> list[tuple[Invocation, int]]:
        """The batch claim loop; returns the members to demote (empty when
        the whole batch committed)."""
        first = invs[0]
        # resolve before any claim: an unregistered function must raise
        # while no slot is held (all members share func by the grouping key)
        fn = self._resolve(first.func)
        wait = self.starve_wait if self.starve_wait > 0 else self.RELEASE_WAIT
        for attempt in range(self.max_attempts):
            if self.gate is not None:
                tg = time.perf_counter()
                self.gate.acquire(first)
                if sp is not None and time.perf_counter() - tg > 1e-4:
                    tr.record("gate_wait", "wait", tg, trace=first.app,
                              node=first.node, parent=sp, attempt=attempt)
            claim = None
            try:
                epoch = self.gc.release_epoch(first.node)
                claim = self.gc.try_commit(first.app, first.priority,
                                           [first.node],
                                           tag=f"{first.stage}*{len(invs)}")
            finally:
                if claim is None and self.gate is not None:
                    self.gate.release(first)
            if claim is None:
                tw = time.perf_counter()
                self.gc.wait_for_release(epoch, timeout=wait,
                                         node=first.node)
                if sp is not None:
                    tr.record("slot_wait", "wait", tw, trace=first.app,
                              node=first.node, parent=sp, attempt=attempt)
                continue
            tr.count(f"slots/node{first.node}", 1, delta=True)
            done: list[tuple[Invocation, FnContext, float, float]] = []
            member_spans: list = []
            crashed_at: int | None = None
            claim_alive = True
            try:
                for k, inv in enumerate(invs):
                    with tr.span(inv.name, "invoker", trace=inv.app,
                                 node=inv.node, parent=sp, stage=inv.stage,
                                 func=inv.func, kind="invocation",
                                 attempt=attempt) as msp:
                        t0 = time.perf_counter()
                        try:
                            if self.intercept is not None:
                                self.intercept(inv, attempt)
                            if self.injector is not None:
                                self.injector.before_body(inv, attempt)
                            ctx = self._invoke_body(fn, inv, attempt)
                            if self.injector is not None:
                                self.injector.after_body(inv, attempt)
                        except InjectedCrashError:
                            crashed_at = k
                            claim_alive = self.gc.finish(claim)
                            tr.count(f"slots/node{first.node}", -1,
                                     delta=True)
                            self._record_member(inv, attempt, "crashed", t0,
                                                time.perf_counter(), deps)
                            if msp is not None:
                                msp.attrs["status"] = "crashed"
                            break
                        except BaseException:
                            claim_alive = self.gc.finish(claim)
                            tr.count(f"slots/node{first.node}", -1,
                                     delta=True)
                            for v, vctx, v0, v1 in done:
                                self._record_member(
                                    v, attempt,
                                    "ok" if claim_alive else "preempted",
                                    v0, v1, deps, vctx)
                            for vsp in member_spans:
                                vsp.attrs["status"] = \
                                    "ok" if claim_alive else "preempted"
                            self._record_member(inv, attempt, "error", t0,
                                                time.perf_counter(), deps)
                            if msp is not None:
                                msp.attrs["status"] = "error"
                            raise
                        done.append((inv, ctx, t0, time.perf_counter()))
                        if msp is not None:
                            member_spans.append(msp)
                if crashed_at is None:
                    claim_alive = self.gc.finish(claim)
                    tr.count(f"slots/node{first.node}", -1, delta=True)
            finally:
                if self.gate is not None:
                    self.gate.release(first)
            status = "ok" if claim_alive else "preempted"
            for v, vctx, v0, v1 in done:
                self._record_member(v, attempt, status, v0, v1, deps, vctx)
            for vsp in member_spans:
                vsp.attrs["status"] = status
            if sp is not None:
                sp.attrs.update(status=status, attempts=attempt + 1)
            if crashed_at is None and claim_alive:
                return []
            # demote: crashed member + never-started members individually;
            # a dead claim additionally discards-and-retries the completed
            # members (their rewrites overwrite under the writer label)
            retry: list[tuple[Invocation, int]] = []
            if not claim_alive:
                retry += [(v, attempt + 1) for v, _, _, _ in done]
            if crashed_at is not None:
                retry.append((invs[crashed_at], attempt + 1))
                retry += [(iv, attempt) for iv in invs[crashed_at + 1:]]
            return retry
        # batch claim starved after the full max_attempts budget: surface
        # it exactly as the per-invocation path would — a fresh individual
        # retry round would double the budget (and the starvation-detection
        # latency) relative to unbatched execution
        now = time.perf_counter()
        for inv in invs:
            self.metrics.record(InvocationRecord(
                inv.name, inv.app, inv.stage, inv.func, inv.node,
                self.max_attempts, "starved", now, now, deps=deps,
                priority=inv.priority))
        raise InvocationError(
            f"{first.name} (+{len(invs) - 1} batched siblings): no slot "
            f"committed after {self.max_attempts} attempts "
            f"(preempted/starved by higher-priority claims)")

    def run_stage(self, invocations: Sequence[Invocation],
                  deps: tuple[str, ...] = ()) -> None:
        raise NotImplementedError


class InlineInvoker(Invoker):
    """Sequential execution in the caller's thread — deterministic."""

    def run_stage(self, invocations: Sequence[Invocation],
                  deps: tuple[str, ...] = ()) -> None:
        for group in self._groups(invocations):
            self._execute_group(group, deps)


class ThreadPoolInvoker(Invoker):
    """Real parallelism: one worker per in-flight batch or function instance.

    On the card every worker computes on a CUDA stream of its own, so its
    invocations' launches, and the wait that ``FnContext._force`` charges
    to them, are not queued behind other workers'. A worker borrows its
    stream for each call from ``kernels.streams.WORKER_STREAMS``, which
    lends a stream to one borrower at a time and makes another when none
    is free, so no two workers running at once share a stream, whatever
    ``max_workers`` is (PyTorch's own pool has 32 streams, so past 32
    workers two would share one). Before it starts, a worker's stream
    waits for the work the submitting thread had enqueued on its current
    stream (the stage's input tables), and that stream waits for the
    worker's when it is done.

    With a ``speculation`` policy installed (``SpeculationPolicy``,
    ``repro_torch.runtime.faults``) the invoker polls in-flight invocations and
    feeds their elapsed times to the policy's failure-feedback decision
    node; stragglers get a backup launched on another node, first
    completion wins (both copies write under the same writer label, so the
    loser's identical output overwrites harmlessly), and ``run_stage``
    returns without waiting for the losers. ``drain()`` joins any such
    still-running losers — call it before asserting slot-leak invariants.
    Speculative stages run invocation-at-a-time (first-completion-wins
    needs per-member claims), so speculation and batching never mix within
    a stage.
    """

    parallel = True

    def __init__(self, gc: GlobalController, store: ShuffleStore,
                 metrics: MetricsSink | None = None, max_workers: int = 8,
                 max_attempts: int = 200, starve_wait: float = 0.0,
                 intercept: Callable[[Invocation, int], None] | None = None,
                 gate: SlotGate | None = None, injector=None,
                 speculation=None, batching: bool = True,
                 max_batch: int = 16, device=None):
        super().__init__(gc, store, metrics, max_attempts=max_attempts,
                         starve_wait=starve_wait, intercept=intercept,
                         gate=gate, injector=injector, batching=batching,
                         max_batch=max_batch, device=device)
        self.max_workers = max_workers
        self.speculation = speculation
        self.speculations: list[tuple[str, int, int, float]] = []
        self._pools: list[ThreadPoolExecutor] = []

    def _caller_stream(self):
        return torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

    def _on_own_stream(self, caller, fn, *args):
        """``fn(*args)`` on a stream this worker holds alone for the call,
        after the work the submitting thread had enqueued on ``caller``;
        what the submitter enqueues afterwards waits for the worker's
        launches in turn."""
        if caller is None:
            return fn(*args)
        from repro_torch.kernels.streams import WORKER_STREAMS
        stream = WORKER_STREAMS.take(self.device)
        try:
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                return fn(*args)
        finally:
            caller.wait_stream(stream)
            WORKER_STREAMS.give(stream)

    def run_stage(self, invocations: Sequence[Invocation],
                  deps: tuple[str, ...] = ()) -> None:
        if not invocations:
            return
        if self.speculation is not None and len(invocations) > 1:
            self._run_stage_speculative(list(invocations), deps)
            return
        groups = self._groups(invocations)
        caller = self._caller_stream()
        with ThreadPoolExecutor(
                max_workers=min(self.max_workers, len(groups))) as pool:
            futures = [pool.submit(self._on_own_stream, caller,
                                   self._execute_group, group, deps)
                       for group in groups]
            for f in futures:
                f.result()    # propagate the first failure

    def _run_stage_speculative(self, invocations: list[Invocation],
                               deps: tuple[str, ...]) -> None:
        spec = self.speculation
        n = len(invocations)
        pool = ThreadPoolExecutor(
            max_workers=min(2 * self.max_workers, 2 * n))
        self._pools.append(pool)
        tr = get_tracer()
        stage_span = tr.anchored(
            ("stage", invocations[0].app, invocations[0].stage))
        caller = self._caller_stream()

        def run_one(inv):
            # pool threads have empty span stacks and losers may outlive
            # the executor's stage anchor (drain() joins them after
            # run_stage returns): adopt the stage span captured at submit
            # time so invocation and store spans stay parented either way
            with tr.adopt(stage_span):
                self._on_own_stream(caller, self._execute_one, inv, deps)

        futs: dict = {}                       # future -> index
        copies = [1] * n                      # in-flight copies per index
        started = []
        for i, inv in enumerate(invocations):
            started.append(time.perf_counter())
            futs[pool.submit(run_one, inv)] = i
        finished: set[int] = set()
        backed: set[int] = set()
        done_s: list[float] = []
        errors: dict[int, BaseException] = {}
        try:
            while len(finished) < n:
                if not futs:
                    raise next(iter(errors.values()))
                done, _ = wait(set(futs), timeout=spec.interval,
                               return_when=FIRST_COMPLETED)
                now = time.perf_counter()
                for f in done:
                    i = futs.pop(f)
                    copies[i] -= 1
                    exc = f.exception()
                    if exc is None:
                        if i not in finished:
                            finished.add(i)
                            done_s.append(now - started[i])
                    else:
                        errors.setdefault(i, exc)
                        if i not in finished and copies[i] == 0:
                            raise exc   # no surviving copy: the stage fails
                status = None
                for i, inv in enumerate(invocations):
                    if i in finished or i in backed:
                        continue
                    if status is None:
                        status = self.gc.node_status()
                    node = spec.backup_node(inv, now - started[i], done_s,
                                            status)
                    if node is None:
                        continue
                    backed.add(i)
                    self.speculations.append(
                        (inv.name, inv.node, node, now - started[i]))
                    tr.record(f"speculate/{inv.name}", "invoker", now,
                              end=now, trace=inv.app, node=node,
                              parent=tr.anchored(
                                  ("stage", inv.app, inv.stage)),
                              kind="speculation", from_node=inv.node,
                              to_node=node, elapsed=now - started[i])
                    backup = replace(inv, node=node)
                    futs[pool.submit(run_one, backup)] = i
                    copies[i] += 1
        finally:
            # first-completion-wins: do NOT wait for losing copies — they
            # finish in the background (drain() joins them)
            pool.shutdown(wait=False)

    def drain(self) -> None:
        """Join speculation losers still running in the background."""
        for pool in self._pools:
            pool.shutdown(wait=True)
        self._pools.clear()
