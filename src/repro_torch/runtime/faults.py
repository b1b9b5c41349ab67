"""Deterministic fault injection for the serverless runtime.

The paper's extensibility claim is strongest where it is hardest: failure
handling. A disaggregated ephemeral store loses stages (the ServerMix
tension), function instances crash, and straggler nodes stretch tails (what
Lambada works around with exchange-operator retries). This module makes
every one of those failure modes a *reproducible test fixture*: a
``FaultPlan`` is a declarative, seedable schedule of faults, and a
``FaultInjector`` arms it on a ``Runtime`` — hooking the invoker (crashes,
injected latency) and the shuffle store (stage loss on the k-th read).

Fault-plan schema
-----------------

``FaultPlan(crashes=[...], stragglers=[...], losses=[...])`` where

* ``CrashFault(stage, index, when, attempt, times)`` — kill a function
  invocation of physical stage ``stage`` (``index=None`` matches any
  instance). ``when="before"`` crashes before the body runs
  (crash-before-commit: no store writes land); ``when="after"`` crashes
  after the body ran (crash-after-write: outputs are in the store under the
  invocation's writer label, so the retry *overwrites* instead of
  duplicating). ``attempt`` selects which retry attempt to kill (default 0,
  the first), ``times`` how many matching invocations to kill.
* ``StragglerFault(node, delay, stage)`` — every matching invocation placed
  on ``node`` (optionally only for ``stage``) sleeps ``delay`` seconds
  before its body runs, emulating a slow node. ``times`` bounds how many
  invocations straggle (default: all).
* ``StageLossFault(stage, partitions, on_read)`` — evict the *data* stage
  ``stage`` (all partitions, or just ``partitions``) from the store
  immediately before its ``on_read``-th read (1-based), leaving lost
  tombstones so the reader raises ``StageLostError`` — the trigger for
  lineage-based recovery.
* ``WorkerKillFault(stage, index, attempt, times)`` — SIGKILL the worker
  *subprocess* running a matching invocation mid-body (process-backed
  invokers only; thread invokers have no process to kill and ignore it).
  The host surfaces the dead pipe as ``WorkerKilledError`` — a crashed
  attempt record — and retries on a freshly provisioned worker. Because a
  worker's writes are buffered worker-side and committed by the host only
  after the body completes, a killed worker never leaves partial store
  writes.

All triggers are match-count based (never wall-clock), so a plan replays
identically under the inline invoker, the thread-pool invoker, and the
cluster simulator's failure models.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.decisions import DecisionContext, NodeStatus, speculation_node
from repro_torch.runtime.store import StageLostError  # noqa: F401  (re-export)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.runtime.invoker import Invocation


class InjectedFault(RuntimeError):
    """Base class for faults raised by a ``FaultInjector``."""


class InjectedCrashError(InjectedFault):
    """An invocation was killed by the fault plan; the invoker retries it
    (stateless functions + writer-label overwrite make the retry safe)."""


class WorkerKilledError(InjectedCrashError):
    """A worker subprocess died (SIGKILL, OOM, injected worker-kill) while
    running an invocation. A subclass of ``InjectedCrashError`` so the
    invoker's existing crash machinery records it and retries — on a fresh
    worker, since the dead one's pipe is gone."""


class RecoveryError(RuntimeError):
    """Lineage recovery could not (or was told not to) heal a lost stage:
    no lineage recorded, recovery budget exhausted, or the recovery
    decision node chose a whole-query rerun."""


@dataclass(frozen=True)
class CrashFault:
    stage: str
    index: int | None = None
    when: str = "before"          # "before" (no writes) | "after" (written)
    attempt: int = 0
    times: int = 1


@dataclass(frozen=True)
class StragglerFault:
    node: int
    delay: float
    stage: str | None = None
    times: int | None = None      # None = every matching invocation


@dataclass(frozen=True)
class StageLossFault:
    stage: str                    # *data* stage name, e.g. "joined"
    partitions: tuple[int, ...] | None = None
    on_read: int = 1              # trigger before the k-th get (1-based)


@dataclass(frozen=True)
class WorkerKillFault:
    stage: str
    index: int | None = None      # None matches any instance of the stage
    attempt: int = 0
    times: int = 1
    # "body": the worker SIGKILLs itself at its first store read (claim
    # live, body started, nothing written); "late": after the body ran —
    # its writes are buffered worker-side and die with it, proving the
    # no-partial-writes invariant
    when: str = "body"


@dataclass
class FaultPlan:
    """A declarative, replayable schedule of injected faults."""

    crashes: list[CrashFault] = field(default_factory=list)
    stragglers: list[StragglerFault] = field(default_factory=list)
    losses: list[StageLossFault] = field(default_factory=list)
    worker_kills: list[WorkerKillFault] = field(default_factory=list)

    @classmethod
    def seeded(cls, seed: int, stages: Sequence[str] = ("scan_fact", "join"),
               data_stages: Sequence[str] = ("joined",),
               nodes: Sequence[int] = (0, 1), n_crashes: int = 2,
               n_losses: int = 1, n_stragglers: int = 1,
               delay: float = 0.25) -> "FaultPlan":
        """Deterministically derive a plan from ``seed`` — the chaos tests'
        and benchmarks' reproducible fixture generator."""
        import numpy as np

        rng = np.random.default_rng(seed)
        crashes = [CrashFault(str(rng.choice(list(stages))), None,
                              when=("before", "after")[int(rng.integers(2))])
                   for _ in range(n_crashes)]
        losses = [StageLossFault(str(rng.choice(list(data_stages))),
                                 on_read=int(rng.integers(1, 3)))
                  for _ in range(n_losses)]
        stragglers = [StragglerFault(int(rng.choice(list(nodes))), delay)
                      for _ in range(n_stragglers)]
        return cls(crashes=crashes, stragglers=stragglers, losses=losses)


class FaultInjector:
    """Arms a ``FaultPlan`` on a runtime: invoker + store hooks.

    Thread-safe; all trigger counters are under one lock so a plan fires
    each fault exactly ``times`` times no matter how invocations interleave.
    ``install(runtime)`` wires both hook points and returns the injector.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._crash_fired = [0] * len(plan.crashes)
        self._straggle_fired = [0] * len(plan.stragglers)
        self._loss_fired = [False] * len(plan.losses)
        self._kill_fired = [0] * len(getattr(plan, "worker_kills", []))
        self._reads: dict[tuple[str, str], int] = {}   # (app, stage) -> gets
        self._store = None
        self.injected: list[tuple[str, str]] = []      # (kind, detail) log

    def install(self, runtime) -> "FaultInjector":
        runtime.invoker.injector = self
        runtime.store.injector = self
        self._store = runtime.store
        return self

    # -- invoker hooks -------------------------------------------------------

    def _match_crash(self, inv: "Invocation", attempt: int,
                     when: str) -> bool:
        with self._lock:
            for i, c in enumerate(self.plan.crashes):
                if c.when != when or c.stage != inv.stage:
                    continue
                if c.index is not None and c.index != inv.index:
                    continue
                if c.attempt != attempt or self._crash_fired[i] >= c.times:
                    continue
                self._crash_fired[i] += 1
                self.injected.append(("crash-" + when, inv.name))
                return True
        return False

    def before_body(self, inv: "Invocation", attempt: int) -> None:
        """Runs while the slot claim is live, before the function body:
        injected latency (stragglers) first, then crash-before-commit."""
        delay = 0.0
        with self._lock:
            for i, s in enumerate(self.plan.stragglers):
                if s.node != inv.node:
                    continue
                if s.stage is not None and s.stage != inv.stage:
                    continue
                if s.times is not None and self._straggle_fired[i] >= s.times:
                    continue
                self._straggle_fired[i] += 1
                self.injected.append(("straggle", inv.name))
                delay = max(delay, s.delay)
        if delay > 0:
            time.sleep(delay)
        if self._match_crash(inv, attempt, "before"):
            raise InjectedCrashError(
                f"{inv.name}: injected crash before body (attempt {attempt})")

    def match_worker_kill(self, inv: "Invocation",
                          attempt: int) -> "WorkerKillFault | None":
        """Consulted by process-backed invokers as they dispatch ``inv`` to
        a worker: a returned fault means SIGKILL that worker mid-invocation
        (its ``when`` picks the kill point). Match-count semantics are
        identical to ``CrashFault`` so a plan replays deterministically."""
        kills = getattr(self.plan, "worker_kills", [])
        with self._lock:
            for i, k in enumerate(kills):
                if k.stage != inv.stage:
                    continue
                if k.index is not None and k.index != inv.index:
                    continue
                if k.attempt != attempt or self._kill_fired[i] >= k.times:
                    continue
                self._kill_fired[i] += 1
                self.injected.append(("worker-kill", inv.name))
                return k
        return None

    def after_body(self, inv: "Invocation", attempt: int) -> None:
        """Runs after the body wrote its outputs, before the claim commits:
        crash-after-write — the retry overwrites under the writer label."""
        if self._match_crash(inv, attempt, "after"):
            raise InjectedCrashError(
                f"{inv.name}: injected crash after write (attempt {attempt})")

    # -- store hook ----------------------------------------------------------

    def on_get(self, app: str, stage: str, partition: int,
               node: int) -> None:
        """Called at the top of every ``ShuffleStore.get`` (store lock held,
        re-entrant): the k-th read of a stage may lose it right now."""
        with self._lock:
            count = self._reads.get((app, stage), 0) + 1
            self._reads[(app, stage)] = count
            fire = []
            for i, loss in enumerate(self.plan.losses):
                if loss.stage != stage or self._loss_fired[i]:
                    continue
                if count != loss.on_read:
                    continue
                self._loss_fired[i] = True
                self.injected.append(("stage-loss", f"{app}/{stage}"))
                fire.append(loss)
        for loss in fire:
            self._store.lose_stage(app, stage, partitions=loss.partitions)


class SpeculationPolicy:
    """Straggler mitigation as a failure-feedback decision node.

    A parallel invoker exposes per-invocation elapsed times to this policy
    while a stage is in flight; the wrapped ``speculation_node`` decides —
    from the observed completion distribution — whether to launch a backup
    invocation on another node. First completion wins: both copies write
    under the same writer label, so the loser's (identical) output
    overwrites harmlessly. ``interval`` is the invoker's polling period,
    ``multiple`` the p50-multiple past which an invocation counts as a
    straggler, ``min_done`` how many sibling completions are needed before
    a p50 is trusted.
    """

    def __init__(self, multiple: float = 2.0, min_done: int = 2,
                 floor: float = 0.05, interval: float = 0.02):
        self.node = speculation_node(multiple=multiple, min_done=min_done,
                                     floor=floor)
        self.interval = interval

    def backup_node(self, inv: "Invocation", elapsed: float,
                    done_seconds: Sequence[float],
                    status: NodeStatus) -> int | None:
        """The node to launch a backup on, or None to keep waiting."""
        from repro_torch.obs.audit import bound_app
        ctx = DecisionContext(node_status=status, profile={
            "speculation.stage": inv.stage,
            "speculation.node": inv.node,
            "speculation.elapsed_s": elapsed,
            "speculation.done_s": tuple(done_seconds),
        })
        with bound_app(inv.app):
            decision = self.node.decide(ctx)
        if decision.func != "speculate" or decision.scale < 1:
            return None
        placed = decision.schedule.place(1)
        return placed[0] if placed else None
