"""Decentralized, extensible control plane (paper §5.2).

``GlobalController`` owns the full resource view (device/function slots per
node, grouped into pods) and offers it to per-application
``PrivateController``s. Private controllers make application-level decisions
(via their decision workflows) against an *optimistic* shared-state view and
then try to **commit** slot claims — the Omega model [Schwarzkopf EuroSys'13]
the paper adopts. On conflict, the global controller resolves by priority:
higher-priority claims evict lower-priority, delay-tolerant ones (XFaaS-style
background functions).

These controllers are deliberately runtime-agnostic: the analytics simulator,
the serving engine and the training supervisor all drive them.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Sequence

from repro_torch.device import H100_SXM

from .decisions import (
    DataDist,
    Decision,
    DecisionContext,
    DecisionWorkflow,
    NodeStatus,
)


@dataclass(frozen=True)
class Claim:
    """A committed (or pending) slot reservation."""

    claim_id: int
    app: str
    priority: int
    placement: tuple[int, ...]            # node id per instance
    tag: str = ""                         # e.g. stage name

    def slots_per_node(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for node in self.placement:
            out[node] = out.get(node, 0) + 1
        return out


class ConflictError(RuntimeError):
    def __init__(self, msg: str, shortfall: Mapping[int, int]):
        super().__init__(msg)
        self.shortfall = dict(shortfall)


@dataclass
class Preemption:
    victim: Claim
    by: str


class GlobalController:
    """Coordinates resource allocation across applications (paper §5.2).

    Maintains the comprehensive resource view and commits claims with
    priority-based conflict resolution. Thread-safe: serving/training/
    background drivers may commit concurrently.
    """

    def __init__(self, slots_per_node: Mapping[int, int],
                 pods: Mapping[int, Sequence[int]] | None = None,
                 link_bw: float = H100_SXM.link_bw,
                 intra_bw: float = H100_SXM.hbm_bw):
        self._lock = threading.RLock()
        self.total = dict(slots_per_node)
        self.used: dict[int, int] = {n: 0 for n in self.total}
        self.pods = {k: tuple(v) for k, v in (pods or {0: tuple(self.total)}).items()}
        self.link_bw = link_bw
        self.intra_bw = intra_bw
        self.claims: dict[int, Claim] = {}
        self.preemptions: list[Preemption] = []
        self._ids = itertools.count(1)
        self._listeners: list[Callable[[str, Claim], None]] = []
        # Release-event machinery for starved claimants: every slot release
        # bumps the released nodes' epochs (and a global one) and wakes
        # waiters, so a failed try_commit can block until capacity may have
        # freed on *its* node instead of busy-spinning — and without burning
        # retry attempts on unrelated nodes' churn.
        self._release_cond = threading.Condition(self._lock)
        self._release_epoch = 0
        self._node_release_epoch: dict[int, int] = {n: 0 for n in self.total}

    # -- resource view offered to private controllers (all or parts) --------

    def node_status(self, visible_nodes: Iterable[int] | None = None) -> NodeStatus:
        with self._lock:
            nodes = list(visible_nodes) if visible_nodes is not None \
                else list(self.total)
            return NodeStatus(
                total_slots={n: self.total[n] for n in nodes},
                free_slots={n: self.total[n] - self.used[n] for n in nodes},
                link_bw=self.link_bw,
                intra_bw=self.intra_bw,
                pods=self.pods,
            )

    def utilization(self) -> float:
        with self._lock:
            total = sum(self.total.values())
            return (sum(self.used.values()) / total) if total else 0.0

    def subscribe(self, fn: Callable[[str, Claim], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, event: str, claim: Claim) -> None:
        # Called with the controller lock *released* (listeners may block or
        # re-enter the controller); snapshot under the lock so a listener
        # subscribing mid-notify can't mutate the list being iterated.
        with self._lock:
            listeners = tuple(self._listeners)
        for fn in listeners:
            fn(event, claim)

    # -- Omega-style optimistic commit --------------------------------------

    def commit(self, app: str, priority: int, placement: Sequence[int],
               tag: str = "") -> Claim:
        """Atomically commit a claim; may preempt lower-priority claims.

        Raises ConflictError when demand cannot be satisfied even after
        preempting every lower-priority claim on the contended nodes.
        """
        evicted: list[Claim] = []
        claim: Claim | None = None
        try:
            with self._lock:
                demand: dict[int, int] = {}
                for node in placement:
                    if node not in self.total:
                        raise KeyError(f"unknown node {node}")
                    demand[node] = demand.get(node, 0) + 1

                shortfall = {
                    n: need - (self.total[n] - self.used[n])
                    for n, need in demand.items()
                    if need > self.total[n] - self.used[n]
                }
                if shortfall:
                    evicted = self._preempt_for(shortfall, priority, app)
                    shortfall = {
                        n: need - (self.total[n] - self.used[n])
                        for n, need in demand.items()
                        if need > self.total[n] - self.used[n]
                    }
                    if shortfall:
                        raise ConflictError(
                            f"claim by {app} (prio {priority}) unsatisfiable",
                            shortfall,
                        )

                claim = Claim(next(self._ids), app, priority,
                              tuple(placement), tag)
                for node, need in demand.items():
                    self.used[node] += need
                self.claims[claim.claim_id] = claim
        finally:
            # Notifications fire outside the lock: a blocking or re-entrant
            # listener must not stall every other thread's slot traffic. A
            # *raising* listener must not leak the booked claim either — the
            # caller gets the exception instead of the claim handle, so the
            # booking is rolled back before propagating.
            try:
                for victim in evicted:
                    self._notify("release", victim)
                if claim is not None:
                    self._notify("commit", claim)
            except BaseException:
                if claim is not None:
                    with self._lock:
                        self._release_locked(claim)
                raise
        return claim

    # -- invoker-facing claim path ------------------------------------------
    #
    # Function runtimes hold a claim only for the lifetime of one stateless
    # invocation and must detect losing it mid-flight: ``try_commit`` is the
    # non-raising commit, ``finish`` the release-or-report-preempted exit.

    def try_commit(self, app: str, priority: int, placement: Sequence[int],
                   tag: str = "") -> Claim | None:
        """Commit a claim, or return None when it cannot be satisfied."""
        try:
            return self.commit(app, priority, placement, tag=tag)
        except ConflictError:
            return None

    def is_active(self, claim: Claim) -> bool:
        with self._lock:
            return claim.claim_id in self.claims

    def finish(self, claim: Claim) -> bool:
        """Release a claim at invocation exit. Returns False if the claim had
        already been preempted (the invocation's work must be discarded and
        retried — safe for stateless functions)."""
        with self._lock:
            active = self._release_locked(claim)
        if active:
            self._notify("release", claim)
        return active

    def release(self, claim: Claim) -> None:
        with self._lock:
            active = self._release_locked(claim)
        if active:
            self._notify("release", claim)

    def _release_locked(self, claim: Claim) -> bool:
        """Bookkeeping half of a release; caller holds the lock and emits
        the notification after dropping it."""
        if claim.claim_id not in self.claims:
            return False
        del self.claims[claim.claim_id]
        for node, count in claim.slots_per_node().items():
            self.used[node] -= count
            self._node_release_epoch[node] = \
                self._node_release_epoch.get(node, 0) + 1
        self._release_epoch += 1
        self._release_cond.notify_all()
        return True

    # -- release-event wait (starved claimants block, not spin) --------------

    def release_epoch(self, node: int | None = None) -> int:
        """Current release epoch — per ``node`` when given, global otherwise.
        Read *before* a try_commit attempt: if the attempt fails,
        ``wait_for_release(epoch, ...)`` returns immediately when a matching
        slot was freed since — the lost-wakeup-free handshake."""
        with self._lock:
            if node is None:
                return self._release_epoch
            return self._node_release_epoch.get(node, 0)

    def wait_for_release(self, epoch: int, timeout: float | None = None,
                         node: int | None = None) -> bool:
        """Block until the release epoch advances past ``epoch`` — a claim
        was released or preempted since the caller sampled it, on ``node``
        when given (unrelated nodes' churn does not wake-and-burn a
        node-pinned claimant's retry budget) — or ``timeout`` elapses.
        Returns True if a matching release happened."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._release_cond:
            while True:
                current = self._release_epoch if node is None \
                    else self._node_release_epoch.get(node, 0)
                if current != epoch:
                    return True
                if deadline is None:
                    self._release_cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._release_cond.wait(remaining)

    def _preempt_for(self, shortfall: Mapping[int, int], priority: int,
                     app: str) -> list[Claim]:
        """Evict lowest-priority claims on contended nodes (paper: priority
        arbitration; effective because low-priority work is delay-tolerant).
        Returns the victims; the caller notifies listeners after unlocking."""
        victims = sorted(
            (c for c in self.claims.values() if c.priority < priority),
            key=lambda c: c.priority,
        )
        need = dict(shortfall)
        evicted: list[Claim] = []
        for victim in victims:
            if not any(n in need and need[n] > 0 for n in victim.placement):
                continue
            self._release_locked(victim)
            evicted.append(victim)
            self.preemptions.append(Preemption(victim, app))
            for node, count in victim.slots_per_node().items():
                if node in need:
                    need[node] -= count
            if all(v <= 0 for v in need.values()):
                break
        return evicted


class PrivateController:
    """Application-level controller: tracks app data distribution, runs the
    app's decision workflow against the global resource view, and converts
    decisions into committed claims."""

    def __init__(self, app: str, gc: GlobalController, priority: int = 0,
                 workflow: DecisionWorkflow | None = None):
        self.app = app
        self.gc = gc
        self.priority = priority
        self.workflow = workflow or DecisionWorkflow(app)
        self.data_dist: dict[str, DataDist] = {}
        self.profile: dict[str, object] = {}
        self.active_claims: list[Claim] = []

    # -- app-level knowledge -------------------------------------------------

    def observe_data(self, dist: DataDist) -> None:
        self.data_dist[dist.name] = dist

    def record_profile(self, **kv) -> None:
        self.profile.update(kv)

    def context(self, app_info: Mapping | None = None) -> DecisionContext:
        return DecisionContext(
            data_dist=dict(self.data_dist),
            node_status=self.gc.node_status(),
            app=dict(app_info or {}),
            profile=dict(self.profile),
        )

    # -- decision -> claim ---------------------------------------------------

    def enact(self, decision: Decision, tag: str = "") -> Claim:
        placement = decision.schedule.place(decision.scale)
        claim = self.gc.commit(self.app, self.priority, placement, tag=tag)
        self.active_claims.append(claim)
        return claim

    def release_all(self) -> None:
        for claim in self.active_claims:
            self.gc.release(claim)
        self.active_claims.clear()

    def run_workflow(self, executor, app_info: Mapping | None = None):
        ctx = self.context(app_info)
        return self.workflow.run(ctx, executor)

    def start_run(self, app_info: Mapping | None = None):
        """Open a late-bound ``WorkflowRun`` over this app's knowledge; the
        executor interleaves ``decide``/``feedback`` with its stages."""
        return self.workflow.start(self.context(app_info))
