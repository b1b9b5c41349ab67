"""Discrete-event cluster simulator for the serverless control plane.

Reproduces the paper's evaluation environment (6–20 node clusters of
c5.2xlarge-like machines: 8 function slots/node, ~1.25 GB/s NIC) without the
EC2 cluster: *compute* rates are calibrated from real timings of the port's
operators in ``repro_torch.analytics.operators`` on the card
(``calibrated_rates``); *network* transfers occupy source
and destination NICs (so hash-join broadcast saturates senders as the cluster
grows — Fig. 4c — and mis-placed functions pay remote-read costs — Fig. 4e).

Slot accounting goes through the real ``GlobalController`` (Omega-style
commits + priority preemption), so Fig. 8's fine-grained sharing runs the
actual control plane, not a model of it. Task DAGs for the paper's query
come from the same decision workflow that drives the serverless runtime
(``repro_torch.analytics.planner``), so simulated and real plans materialize
identical decision sequences.

The event engine is pure Python over the control plane's controllers, a
copy of the reference's: the same submitted tasks give the same event times
and makespan, bit for bit. Only ``calibrated_rates`` touches tensors.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.controllers import Claim, ConflictError, GlobalController
from repro_torch.device import resolve_device

DEFAULT_NET_BW = 1.25e9        # bytes/s per node NIC (10 Gbps)
DEFAULT_SLOTS = 8              # vCPUs per c5.2xlarge


@dataclass
class SimTask:
    name: str
    app: str
    duration: float                         # compute seconds (one slot)
    node: int | None = None                 # None = any node (flexible)
    deps: tuple[str, ...] = ()
    priority: int = 0
    # bytes to pull from each source node before compute starts
    transfers: Mapping[int, int] = field(default_factory=dict)
    started: float = -1.0
    finished: float = -1.0


@dataclass
class Timeline:
    samples: list = field(default_factory=list)   # (t, used, total)

    def record(self, t: float, used: int, total: int):
        self.samples.append((t, used, total))

    def allocation_rate(self, t0: float = 0.0, t1: float | None = None):
        """Time-weighted mean used/total over [t0, t1]."""
        if not self.samples:
            return 0.0
        pts = sorted(self.samples)
        t1 = t1 if t1 is not None else pts[-1][0]
        area = 0.0
        for (ta, ua, tot), (tb, _, _) in zip(pts, pts[1:] + [(t1, 0, 1)]):
            lo, hi = max(ta, t0), min(tb, t1)
            if hi > lo and tot:
                area += (hi - lo) * ua / tot
        return area / max(t1 - t0, 1e-9)


class ClusterSim:
    """Event-driven simulator; one slot per task, NICs serialize transfers.

    Failure models (mirroring ``repro_torch.runtime.faults``): ``straggle`` adds
    per-node latency to tasks started there — either ``{node: delay}``
    (every task on the node, unbounded) or scoped entries ``(node, delay,
    task_family | None, times | None)`` matching the runtime injector's
    stage filter and firing bound; overlapping entries combine by max, as
    in ``FaultInjector.before_body``. ``crash_plan`` maps task names to a
    number of failures — a crashed task occupies its slot for the full
    duration, then releases it and re-enters the ready set (the runtime
    invoker's crash-retry, priced in sim time). ``reexecutions`` counts the
    extra runs.

    Cold-start economics (twin of the ``repro_torch.runtime.workers`` pool,
    active when ``provision_s > 0``): each task start consumes a warm
    worker — LIFO, reaped after ``idle_reap_s`` idle — or pays a
    ``provision_s`` cold start before compute begins. ``prewarm`` (the
    elasticity decision's grow path) provisions workers up front and bills
    their cold starts immediately. ``fn_seconds`` is the per-app
    function-seconds cost proxy matching ``WorkerPool.
    cost_function_seconds``: busy compute + provision charges, with NIC
    transfer time excluded (the store bills that separately).
    """

    def __init__(self, gc: GlobalController, net_bw: float = DEFAULT_NET_BW,
                 straggle=None, crash_plan: Mapping[str, int] | None = None,
                 provision_s: float = 0.0, warm_pool: int = 0,
                 idle_reap_s: float | None = None,
                 storage_spec: Mapping[str, Mapping] | None = None,
                 store_quotas: Mapping[str, int] | None = None):
        self.gc = gc
        self.net_bw = net_bw
        # storage-tier twin: mirrors ShuffleStore.storage_spec() and the
        # per-app quotas so the tiering decision binds identically to the
        # runtime plane (empty = a store without spill backends)
        self.storage_spec = dict(storage_spec or {})
        self.store_quotas = dict(store_quotas or {})
        if isinstance(straggle, Mapping):
            entries = [(n, d, None, None) for n, d in straggle.items()]
        else:
            entries = [tuple(e) for e in (straggle or ())]
        # mutable: the last slot counts remaining firings (None = unbounded)
        self._stragglers = [[n, d, fam, times]
                            for n, d, fam, times in entries]
        self.crash_plan = dict(crash_plan or {})
        self.reexecutions = 0
        self.tasks: dict[str, SimTask] = {}
        self.done: set[str] = set()
        self.now = 0.0
        self.nic_free_send = {n: 0.0 for n in gc.total}
        self.nic_free_recv = {n: 0.0 for n in gc.total}
        self.timeline = Timeline()
        self.app_finish: dict[str, float] = {}
        self.app_cost: dict[str, float] = {}
        self._events: list = []
        self._counter = itertools.count()
        self._running: dict[str, Claim] = {}
        # -- cold-start / warm-pool model (inert when provision_s == 0) ----
        self.provision_s = float(provision_s)
        self.idle_reap_s = idle_reap_s
        self._warm: list[float] = [0.0] * int(warm_pool)   # idle-since times
        self.pool = int(warm_pool)        # provisioned workers (warm + busy)
        self.cold_starts = 0
        self.warm_hits = 0
        self.reaped = 0
        self.fn_seconds: dict[str, float] = {}

    # -- submission ----------------------------------------------------------

    def submit(self, task: SimTask):
        assert task.name not in self.tasks
        self.tasks[task.name] = task

    def submit_all(self, tasks: Iterable[SimTask]):
        for t in tasks:
            self.submit(t)

    # -- cold-start / warm-pool model ------------------------------------------

    def pool_size(self) -> int:
        """Provisioned workers (warm + busy) — the elastic node's input."""
        return self.pool

    def prewarm(self, target: int, app: str = "query"):
        """Grow the pool to ``target`` ahead of demand (elastic "grow"):
        each new worker's provision charge is billed to ``app`` now, so the
        fan-out that follows leases warm. Shrinking just lowers the idle
        floor — the reaper retires the surplus as it expires. Inert when
        cold starts aren't modeled (``provision_s<=0``): the pool must then
        stay at 0 so ``pool_size()`` matches a pool-less runtime invoker
        and shared-workflow decision sequences agree across planes."""
        if self.provision_s <= 0:
            return
        grow = int(target) - self.pool
        for _ in range(max(0, grow)):
            self.pool += 1
            self.cold_starts += 1
            self._warm.append(self.now)
            if self.provision_s > 0:
                self.fn_seconds[app] = \
                    self.fn_seconds.get(app, 0.0) + self.provision_s

    def _reap_idle(self):
        if self.idle_reap_s is None:
            return
        while self._warm and self.now - self._warm[0] > self.idle_reap_s:
            self._warm.pop(0)
            self.pool -= 1
            self.reaped += 1

    def _lease_worker(self, app: str) -> float:
        """Lease a warm worker (0 extra latency) or cold-start one
        (``provision_s`` latency, billed to ``app``). Inert when the model
        is disabled."""
        if self.provision_s <= 0:
            return 0.0
        self._reap_idle()
        if self._warm:
            self._warm.pop()          # LIFO: most-recently-idle first
            self.warm_hits += 1
            return 0.0
        self.pool += 1
        self.cold_starts += 1
        self.fn_seconds[app] = \
            self.fn_seconds.get(app, 0.0) + self.provision_s
        return self.provision_s

    def _return_worker(self):
        if self.provision_s <= 0:
            return
        self._warm.append(self.now)
        self._reap_idle()

    # -- engine ----------------------------------------------------------------

    def _ready(self, task: SimTask) -> bool:
        return task.started < 0 and all(d in self.done for d in task.deps)

    def _transfer_time(self, task: SimTask, dst: int) -> float:
        """Serialize on src-send and dst-recv NICs; returns completion time."""
        start = self.now
        end = start
        for src, nbytes in sorted(task.transfers.items()):
            if src == dst or nbytes <= 0:
                continue
            t0 = max(self.nic_free_send[src], self.nic_free_recv[dst], start)
            dt = nbytes / self.net_bw
            self.nic_free_send[src] = t0 + dt
            self.nic_free_recv[dst] = t0 + dt
            end = max(end, t0 + dt)
        return end

    def _try_start(self):
        # priority-ordered ready tasks (the global controller arbitrates)
        ready = sorted(
            (t for t in self.tasks.values() if self._ready(t)),
            key=lambda t: (-t.priority, t.name))
        for task in ready:
            status = self.gc.node_status()
            if task.node is not None:
                candidates = [task.node]
            else:  # flexible: most-free node first (backfill)
                candidates = sorted(
                    status.free_slots, key=lambda n: -status.free_slots[n])
            for node in candidates:
                if status.free_slots.get(node, 0) <= 0:
                    continue
                try:
                    claim = self.gc.commit(task.app, task.priority, [node],
                                           tag=task.name)
                except ConflictError:
                    continue
                ready_at = self._transfer_time(task, node)
                ready_at += self._lease_worker(task.app)
                task.started = self.now
                finish = ready_at + task.duration + \
                    self._straggle_delay(task.name, node)
                self._running[task.name] = claim
                heapq.heappush(self._events,
                               (finish, next(self._counter), task.name))
                self.app_cost[task.app] = self.app_cost.get(task.app, 0.0) \
                    + (finish - self.now)
                self.fn_seconds[task.app] = \
                    self.fn_seconds.get(task.app, 0.0) + (finish - ready_at)
                break
        self._sample()

    def _straggle_delay(self, name: str, node: int) -> float:
        """Injected latency for one task start: scoped entries match the
        task's family (``app/<family>/i``), decrement their firing budget,
        and combine by max — the runtime injector's semantics."""
        family = name.split("/")[1] if name.count("/") >= 2 else None
        delay = 0.0
        for entry in self._stragglers:
            s_node, s_delay, s_fam, s_times = entry
            if s_node != node:
                continue
            if s_fam is not None and s_fam != family:
                continue
            if s_times is not None:
                if s_times <= 0:
                    continue
                entry[3] = s_times - 1
            delay = max(delay, s_delay)
        return delay

    def _sample(self):
        used = sum(self.gc.used.values())
        total = sum(self.gc.total.values())
        self.timeline.record(self.now, used, total)

    def run(self, until: float | None = None) -> dict:
        self._try_start()
        while self._events:
            t, _, name = heapq.heappop(self._events)
            if until is not None and t > until:
                self.now = until
                break
            self.now = t
            task = self.tasks[name]
            if self.crash_plan.get(name, 0) > 0:
                # injected crash: the run burned its slot-time but commits
                # nothing; the task re-enters the ready set (crash-retry)
                self.crash_plan[name] -= 1
                self.reexecutions += 1
                task.started = -1.0
                self.gc.release(self._running.pop(name))
                if self.provision_s > 0:
                    self.pool -= 1    # crashed worker died with its task
                self._try_start()
                continue
            task.finished = t
            self.done.add(name)
            self.gc.release(self._running.pop(name))
            self._return_worker()
            self.app_finish[task.app] = max(
                self.app_finish.get(task.app, 0.0), t)
            self._try_start()
        self._sample()
        return {
            "completion": dict(self.app_finish),
            "cost_slot_seconds": dict(self.app_cost),
            "cost_function_seconds": dict(self.fn_seconds),
            "allocation": self.timeline,
        }


def make_cluster(num_nodes: int, slots: int = DEFAULT_SLOTS,
                 net_bw: float = DEFAULT_NET_BW, straggle=None,
                 crash_plan: Mapping[str, int] | None = None,
                 provision_s: float = 0.0, warm_pool: int = 0,
                 idle_reap_s: float | None = None,
                 ) -> tuple[GlobalController, ClusterSim]:
    gc = GlobalController({n: slots for n in range(num_nodes)})
    return gc, ClusterSim(gc, net_bw, straggle=straggle,
                          crash_plan=crash_plan, provision_s=provision_s,
                          warm_pool=warm_pool, idle_reap_s=idle_reap_s)


# Runtime physical stage -> simulator task family (the sim plans the query
# as map/join/agg phases; exchange stages have no separate sim task).
_SIM_STAGE_MAP = {"scan_fact": "map1", "scan_dim": "map2", "join": "join",
                  "final_agg": "agg"}


def sim_fault_models(plan, app: str = "query") -> tuple[list, dict]:
    """Map a ``repro_torch.runtime.faults.FaultPlan`` onto the simulator's
    failure models: ``(straggle_entries, crash_plan)`` for ``ClusterSim``.

    Straggler entries keep the plan's stage scope (mapped to the sim task
    family) and firing bound; stage-scoped stragglers and crashes naming a
    runtime stage without a simulator task family (the exchange writes,
    ``partial_agg``) are dropped — the sim folds those phases into its
    join/agg tasks. A crash with ``index=None`` (any instance) pins to
    instance 0 — the sim replays a *specific* schedule, not a matcher.
    Stage *loss* is not a timing model at all: its simulator-side twin is
    the static recovery prediction (``repro_torch.runtime.lineage.
    expected_recovery``), which the differential test checks against the
    runtime's actual recovery events.
    """
    straggle = [(s.node, s.delay,
                 _SIM_STAGE_MAP.get(s.stage) if s.stage else None, s.times)
                for s in plan.stragglers
                if s.stage is None or s.stage in _SIM_STAGE_MAP]
    crash: dict[str, int] = {}
    for c in plan.crashes:
        fam = _SIM_STAGE_MAP.get(c.stage)
        if fam is None:
            continue
        idx = c.index if c.index is not None else 0
        name = f"{app}/{fam}/{idx}" if fam != "agg" else f"{app}/agg"
        crash[name] = crash.get(name, 0) + c.times
    return straggle, crash


# -- calibration ------------------------------------------------------------------


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
