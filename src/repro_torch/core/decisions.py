"""Decision workflows — the paper's core abstraction (§5.1).

A *decision node* receives system knowledge (``DecisionContext``: data
distribution + node/mesh status) and emits a decision tuple
``Decision(func, scale, schedule)``:

  * ``func``     — which implementation variant to run (paper: hash_join vs
                   merge_join; here e.g. "head_tp" vs "seq_tp" attention, or
                   "all_to_all" vs "gather" MoE dispatch),
  * ``scale``    — how many instances / how much parallelism (paper: function
                   count ∝ data size; here microbatch count, DP width, batch
                   size),
  * ``schedule`` — a placement policy over a node set (paper: round-robin vs
                   packing; here pod-spread vs pod-packing, slot selection).

A *decision workflow* is a DAG of decision nodes evaluated at runtime, between
the stages of an application (query phases, training steps, serving batches).
Decisions are **late-bound**: a stage's node is evaluated only once its
upstream stages have decided and the runtime feedback it awaits has been
folded into the context (paper Fig. 5 step 4) — so a decision made between
two application stages sees what the earlier stages actually produced, not
what the planner guessed up front. ``WorkflowRun`` is the incremental
evaluation handle executors drive; ``DecisionWorkflow.run`` remains the
one-shot convenience loop. Applications that need no customization fall back
to ``default_node`` — mirroring the paper's fallback to plain function
workflows.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence


# ---------------------------------------------------------------------------
# System knowledge exposed to decision nodes (paper Fig. 5, step 2)
# ---------------------------------------------------------------------------


@dataclass
class DataDist:
    """Distribution of one named datum across the cluster/mesh.

    For analytics: per-node byte counts of a table. For LM workloads: tensor
    sizes, token-per-expert histograms, KV-cache occupancy.
    """

    name: str
    bytes_per_node: Mapping[int, int] = field(default_factory=dict)
    rows: int = 0
    skew: float = 0.0                     # max/mean per-node load

    @property
    def size(self) -> int:
        return sum(self.bytes_per_node.values())

    @property
    def loc(self) -> frozenset[int]:
        return frozenset(n for n, b in self.bytes_per_node.items() if b > 0)


def partition_skew(counts: Iterable[int]) -> float:
    """max/mean per-partition load — the skew figure every ``DataDist``
    producer (tables, shuffle store, scan estimates) must agree on."""
    counts = list(counts)
    if not counts:
        return 0.0
    mean = sum(counts) / len(counts)
    return float(max(counts) / max(mean, 1e-9))


def merge_hot_keys(sketches: Iterable[Iterable[tuple[int, int]]],
                   k: int = 8) -> tuple[tuple[int, int], ...]:
    """Merge per-partition heavy-hitter sketches (``((key, count), ...)``)
    into one global top-k, ordered by (-count, key). Summation by key is
    order-independent, so the runtime (merging observed per-invocation
    sketches) and the simulator (merging recomputed per-partition sketches)
    produce bit-identical results from the same inputs."""
    counts: dict[int, int] = {}
    for sketch in sketches:
        for key, c in sketch:
            key = int(key)
            counts[key] = counts.get(key, 0) + int(c)
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return tuple((k_, c) for k_, c in top[:max(1, int(k))])


@dataclass
class NodeStatus:
    """Cluster/mesh resource view offered by the global controller."""

    total_slots: Mapping[int, int] = field(default_factory=dict)
    free_slots: Mapping[int, int] = field(default_factory=dict)
    link_bw: float = 50e9                 # bytes/s per link (ICI)
    intra_bw: float = 819e9               # bytes/s local (HBM)
    pods: Mapping[int, Sequence[int]] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return len(self.total_slots)

    def free(self, nodes: Iterable[int] | None = None) -> int:
        nodes = list(nodes) if nodes is not None else list(self.free_slots)
        return sum(self.free_slots.get(n, 0) for n in nodes)


@dataclass
class DecisionContext:
    """Everything a decision node may look at (system + app knowledge)."""

    data_dist: Mapping[str, DataDist] = field(default_factory=dict)
    node_status: NodeStatus = field(default_factory=NodeStatus)
    app: Mapping[str, Any] = field(default_factory=dict)      # app semantics
    profile: Mapping[str, Any] = field(default_factory=dict)  # runtime feedback
    # Decisions already bound earlier in the same workflow run; downstream
    # nodes may condition on them (e.g. the exchange pattern follows the
    # join variant). Populated by ``WorkflowRun.decide``.
    decisions: Mapping[str, "Decision"] = field(default_factory=dict)
    # Feedback from previous runs (paper Fig. 5, step 4) is merged into
    # ``profile`` by the private controller between executions.


# ---------------------------------------------------------------------------
# Decision output (paper Fig. 6, "output decision tuple")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Schedule:
    policy: str                           # "round-robin" | "packing" | custom
    nodes: tuple[int, ...]                # candidate node set
    slots_per_node: int = 8               # capacity used by the packing policy

    def place(self, n_instances: int) -> tuple[int, ...]:
        """Materialize instance -> node placement under this policy."""
        nodes = list(self.nodes)
        if not nodes:
            return ()
        if self.policy == "packing":
            # Fill each node to capacity before opening the next one
            # (the paper's consolidation strategy for skewed data).
            cap = max(1, self.slots_per_node)
            return tuple(
                nodes[min(i // cap, len(nodes) - 1)] for i in range(n_instances)
            )
        # round-robin: spread instances across the node set.
        return tuple(nodes[i % len(nodes)] for i in range(n_instances))


@dataclass(frozen=True)
class Decision:
    func: str
    scale: int
    schedule: Schedule
    extras: tuple[tuple[str, Any], ...] = ()

    def extra(self, key: str, default: Any = None) -> Any:
        return dict(self.extras).get(key, default)


DecisionFn = Callable[[DecisionContext], Decision]


# ---------------------------------------------------------------------------
# Decision nodes and workflows
# ---------------------------------------------------------------------------


class DecisionNode:
    """A named, user-supplied control-plane decision point.

    ``history`` keeps the last ``max_history`` decisions (bounded so
    long-lived nodes shared across many queries don't grow without limit);
    it is what profiling dashboards and the re-plan tests inspect.
    ``candidates`` names the implementation variants the node chooses among
    (purely declarative — recorded in the decision audit log so a binding
    shows what it picked *against*).

    Every binding is reported to the global ``DecisionAuditLog``
    (``repro_torch.obs.audit``) together with the context snapshot it saw —
    profile feedback, data distributions, free slots, upstream decisions —
    attributed to the query the calling scope bound via ``bound_app``.
    """

    def __init__(self, name: str, fn: DecisionFn,
                 fallback: DecisionFn | None = None, max_history: int = 64,
                 candidates: Sequence[str] = ()):
        self.name = name
        self.fn = fn
        self.fallback = fallback
        self.candidates = tuple(candidates)
        self.history: deque[tuple[float, Decision]] = deque(maxlen=max_history)

    def decide(self, ctx: DecisionContext) -> Decision:
        from repro_torch.obs.audit import get_audit_log
        try:
            decision = self.fn(ctx)
        except Exception:
            if self.fallback is None:
                raise
            decision = self.fallback(ctx)
        self.history.append((time.monotonic(), decision))
        get_audit_log().record(self, ctx, decision)
        return decision

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DecisionNode({self.name!r})"


def default_node(name: str, func: str = "default") -> DecisionNode:
    """The paper's fallback: scale = all free slots, round-robin placement."""

    def fn(ctx: DecisionContext) -> Decision:
        nodes = tuple(sorted(ctx.node_status.free_slots))
        scale = max(1, ctx.node_status.free(nodes))
        return Decision(func, scale, Schedule("round-robin", nodes))

    return DecisionNode(name, fn, candidates=(func,))


# ---------------------------------------------------------------------------
# Failure-feedback nodes: failure handling as a decision-workflow concern.
# The runtime feeds observed failure metrics (per-invocation elapsed times,
# recovery plan sizes) into these nodes exactly like any other profile
# feedback; the decision tuple picks the mitigation — speculate vs wait,
# lineage recompute vs whole-query rerun.
# ---------------------------------------------------------------------------


def should_speculate(done_seconds: Iterable[float], elapsed: float,
                     multiple: float = 2.0, min_done: int = 2,
                     floor: float = 0.05) -> bool:
    """Pure straggler predicate shared by the runtime invoker and the
    cluster simulator: an in-flight invocation is a straggler once its
    elapsed time exceeds ``multiple`` × the p50 of its completed siblings
    (needs ``min_done`` completions; ``floor`` suppresses speculation on
    microsecond-scale stages where a backup costs more than it saves)."""
    done = sorted(done_seconds)
    if len(done) < min_done:
        return False
    p50 = done[len(done) // 2]
    return elapsed > max(multiple * p50, floor)


def speculation_node(multiple: float = 2.0, min_done: int = 2,
                     floor: float = 0.05) -> DecisionNode:
    """Failure-feedback node: launch a backup for a straggling invocation?

    Context contract (fed by the invoker per straggler candidate):
    ``profile["speculation.done_s"]`` — completed siblings' durations,
    ``profile["speculation.elapsed_s"]`` — the candidate's elapsed time,
    ``profile["speculation.node"]`` — the node it is stuck on. Decides
    ``Decision("speculate", 1, schedule)`` with the schedule ranging over
    every *other* node (the straggler's node is presumed slow), or
    ``Decision("wait", 0, ...)``.
    """

    def fn(ctx: DecisionContext) -> Decision:
        done = ctx.profile.get("speculation.done_s", ())
        elapsed = float(ctx.profile.get("speculation.elapsed_s", 0.0))
        avoid = ctx.profile.get("speculation.node")
        nodes = tuple(n for n in sorted(ctx.node_status.total_slots)
                      if n != avoid) or \
            tuple(sorted(ctx.node_status.total_slots))
        if should_speculate(done, elapsed, multiple, min_done, floor):
            return Decision("speculate", 1, Schedule("round-robin", nodes))
        return Decision("wait", 0, Schedule("round-robin", nodes))

    return DecisionNode("speculation", fn,
                        candidates=("speculate", "wait"))


def recovery_node(max_reexec_frac: float = 0.5) -> DecisionNode:
    """Failure-feedback node: heal a lost stage by lineage recompute or give
    up and rerun the whole query?

    Context contract (fed by the executor on ``StageLostError``):
    ``profile["recovery.reexec_invocations"]`` — invocations the lineage
    plan would re-execute, ``profile["recovery.total_invocations"]`` — the
    query's total. Recompute while the plan re-executes at most
    ``max_reexec_frac`` of the query; otherwise decide ``"rerun"`` (the
    executor then surfaces ``RecoveryError`` for the caller to rerun).
    """

    def fn(ctx: DecisionContext) -> Decision:
        n_re = int(ctx.profile.get("recovery.reexec_invocations", 0))
        total = max(1, int(ctx.profile.get("recovery.total_invocations", 0)))
        nodes = tuple(sorted(ctx.node_status.total_slots))
        func = "recompute" if n_re <= max_reexec_frac * total else "rerun"
        return Decision(func, n_re, Schedule("round-robin", nodes))

    return DecisionNode("recovery", fn,
                        candidates=("recompute", "rerun"))


def worker_pool_target(fanout: int, pool: int, min_workers: int = 1,
                       max_workers: int = 16,
                       tasks_per_worker: int = 4) -> int:
    """Pure pool-sizing rule shared by the runtime invoker and the cluster
    simulator (the sharing is what makes elastic decision sequences
    identical across planes): enough warm workers that the upcoming
    fan-out queues at most ``tasks_per_worker`` deep per worker, clamped
    to ``[min_workers, max_workers]``. With no upcoming work the pool
    shrinks to ``min_workers`` (the warm floor the idle reaper leaves)."""
    if fanout <= 0:
        return max(min_workers, 0)
    want = -(-int(fanout) // max(1, int(tasks_per_worker)))   # ceil div
    return max(min_workers, min(int(max_workers), want))


def elasticity_node(min_workers: int = 1, max_workers: int = 16,
                    tasks_per_worker: int = 4,
                    name: str = "elastic") -> DecisionNode:
    """Elasticity as a decision node: grow or shrink the worker pool from
    queue pressure — the control-plane half of the process worker plane,
    in the spirit of Lambada's burst fan-out.

    Context contract (fed by the planner on either plane before the node
    binds): ``profile["elastic.fanout"]`` — the upcoming stage fan-out
    (invocations about to queue), ``profile["elastic.pool"]`` — the
    current worker-pool size (0 on backends without a pool: the decision
    still binds and is audited, it just has nothing to resize — the same
    control-plane-invisibility convention as the pipeline node). Decides
    ``Decision("grow"|"shrink"|"hold", target_pool, schedule)`` where
    ``scale`` IS the target pool size; ``extras`` carry the sizing inputs
    so the audit log shows why.
    """

    def fn(ctx: DecisionContext) -> Decision:
        fanout = int(ctx.profile.get("elastic.fanout", 0))
        pool = int(ctx.profile.get("elastic.pool", 0))
        target = worker_pool_target(fanout, pool, min_workers=min_workers,
                                    max_workers=max_workers,
                                    tasks_per_worker=tasks_per_worker)
        func = "grow" if target > pool else \
            "shrink" if target < pool else "hold"
        nodes = tuple(sorted(ctx.node_status.total_slots))
        return Decision(func, target, Schedule("round-robin", nodes),
                        extras=(("fanout", fanout), ("pool", pool),
                                ("tasks_per_worker", tasks_per_worker)))

    return DecisionNode(name, fn, candidates=("grow", "shrink", "hold"))


# spill costs are seconds + dollars; one exchange rate folds them into a
# single objective ($1 ≈ one cpu-hour of makespan — the serverless duality
# of paying for time)
SPILL_DOLLARS_TO_SECONDS = 3600.0


def tiering_choice(nbytes: int, reread_p: float, recompute_s: float,
                   tiers: Mapping[str, Mapping]) -> tuple[str, str | None]:
    """Pure per-stage tiering rule shared by the runtime planner and the
    cluster simulator (the sharing is what makes tiering decision
    sequences identical across planes): for one reclaimable stage of
    ``nbytes``, compare evict-and-recompute (``reread_p *
    recompute_s``) against spilling to each cold tier (write now, read
    back with probability ``reread_p``, request/GB dollars monetized at
    ``SPILL_DOLLARS_TO_SECONDS``). ``tiers`` maps tier name ->
    ``StorageBackend.spec()``. Returns ``("spill", tier)`` or
    ``("evict", None)``; ties break toward evicting (recompute needs no
    new machinery) then toward the warmer tier."""
    best = ("evict", None)
    best_cost = max(0.0, float(reread_p)) * max(0.0, float(recompute_s))
    for name in sorted(tiers, key=lambda n: (tiers[n].get("order", 99), n)):
        spec = tiers[name]
        lat = float(spec.get("latency_s") or 0.0)
        write_bw = spec.get("write_bw")
        read_bw = spec.get("read_bw")
        write_s = lat + (nbytes / write_bw if write_bw else 0.0)
        read_s = lat + (nbytes / read_bw if read_bw else 0.0)
        dollars = (float(spec.get("cost_per_request") or 0.0) * 2
                   + 2 * nbytes * float(spec.get("cost_per_gb") or 0.0)
                   / 1e9)
        cost = write_s + reread_p * read_s \
            + dollars * SPILL_DOLLARS_TO_SECONDS
        if cost < best_cost:
            best, best_cost = ("spill", name), cost
    return best


def tiering_node(loss_rate: float = 0.05, recompute_bw: float = 32e6,
                 name: str = "tiering") -> DecisionNode:
    """Storage tiering as a decision node: choose, per reclaimable shuffle
    stage, whether quota pressure should *spill* it to a colder backend or
    *evict* it and lean on lineage recompute — the graceful-degradation
    answer to ServerMix's ephemeral-storage tension.

    Context contract (fed by the planner on either plane before the node
    binds): ``profile["tiering.stages"]`` — tuple of ``(stage,
    est_bytes, lineage_depth, downstream_remaining)`` per ephemeral data
    stage of the chosen physical plan; ``profile["tiering.quota"]`` — the
    app's store quota (None = unlimited); ``profile["tiering.tiers"]`` —
    cold-tier specs (``ShuffleStore.storage_spec()``; empty on stores
    without spill backends). With no quota or no cold tiers the node
    decides ``keep`` — today's behavior, byte-identical on both planes.

    Per stage, re-read probability grows with the downstream stages still
    to run (``loss_rate`` per consumer — more future readers, more
    chances a fault or speculation replay re-pulls it) and recompute cost
    scales with lineage depth at an effective ``recompute_bw`` bytes/s
    (recomputing a deep stage replays its whole producer chain). Both
    inputs are plan-derived, never measured, so runtime and simulator
    price identically. Decides ``Decision("spill"|"evict"|"keep",
    n_spilled, schedule)``; ``extras["plan"]`` carries the per-stage
    choices (``tier`` name or ``"evict"``) the planner installs via
    ``ShuffleStore.set_spill_policy``.
    """

    def fn(ctx: DecisionContext) -> Decision:
        stages = tuple(ctx.profile.get("tiering.stages", ()))
        quota = ctx.profile.get("tiering.quota")
        tiers = dict(ctx.profile.get("tiering.tiers") or {})
        nodes = tuple(sorted(ctx.node_status.total_slots))
        sched = Schedule("round-robin", nodes)
        if quota is None or not tiers or not stages:
            return Decision("keep", 0, sched, extras=(("plan", ()),))
        plan = []
        spilled = 0
        for stage, nbytes, depth, remaining in stages:
            p = min(1.0, loss_rate * (1 + int(remaining)))
            recompute_s = max(1, int(depth)) * int(nbytes) / recompute_bw
            func, tier = tiering_choice(int(nbytes), p, recompute_s, tiers)
            if func == "spill":
                spilled += 1
                plan.append((stage, tier))
            else:
                plan.append((stage, "evict"))
        func = "spill" if spilled else "evict"
        return Decision(func, spilled, sched,
                        extras=(("plan", tuple(plan)),))

    return DecisionNode(name, fn, candidates=("spill", "evict", "keep"))


def skew_mitigation(rows_hist: Sequence[int],
                    hot_keys: Sequence[tuple[int, int]],
                    threshold: float = 2.0, min_rows: int = 4096,
                    salt_cap: int = 8, hot_frac: float = 0.08,
                    force: str | None = None,
                    ) -> tuple[str, tuple[tuple[int, int], ...], int,
                               tuple[int, ...]]:
    """Pure skew-mitigation rule shared by the runtime planner and the
    cluster simulator (the sharing is what makes skew decision sequences
    identical across planes). From an observed per-bucket row histogram
    and a merged heavy-hitter sketch, pick:

      * ``("none", (), 0, ())`` — balanced enough (max/mean below
        ``threshold``) or too small (< ``min_rows``) to be worth touching;
      * ``("broadcast", heavy, salt, hot)`` — a few keys dominate
        (any sketch key holding >= ``hot_frac`` of all rows): split them
        out of the shuffle and join them against a replicated build side,
        and shard what remains of the heavy buckets ``salt`` ways;
      * ``("salted", heavy, salt, ())`` — buckets are lopsided without a
        single dominating key: split each heavy bucket (>= ``threshold`` x
        mean rows) into ``salt`` writer-sharded sub-joins.

    ``heavy`` is ``((bucket, rows), ...)``; ``salt`` = ceil(max/mean)
    clamped to ``[2, salt_cap]``. ``force`` pins the mitigation for A/B
    benchmarking: a forced choice still needs a histogram to split on
    (empty input stays ``none``), and forced ``salted`` on balanced data
    splits the single largest bucket.
    """
    rows = [int(r) for r in rows_hist]
    total = sum(rows)
    if total <= 0 or len(rows) < 2:
        return ("none", (), 0, ())
    mean = total / len(rows)
    ratio = max(rows) / max(mean, 1e-9)
    heavy = tuple((b, r) for b, r in enumerate(rows)
                  if r >= threshold * mean and r > 0)
    hot = tuple(int(k) for k, c in hot_keys if c >= hot_frac * total)
    salt = max(2, min(int(salt_cap), math.ceil(ratio)))
    if force == "none":
        return ("none", (), 0, ())
    if force == "broadcast":
        if not hot:
            hot = tuple(int(k) for k, _ in list(hot_keys)[:2])
        return ("broadcast", heavy, salt, hot) if hot \
            else ("none", (), 0, ())
    if force == "salted":
        if not heavy:
            b = max(range(len(rows)), key=lambda i: rows[i])
            heavy = ((b, rows[b]),)
        return ("salted", heavy, salt, ())
    if total < min_rows or ratio < threshold:
        return ("none", (), 0, ())
    if hot:
        return ("broadcast", heavy, salt, hot)
    if heavy:
        return ("salted", heavy, salt, ())
    return ("none", (), 0, ())


def skew_node(threshold: float = 2.0, min_rows: int = 4096,
              salt_cap: int = 8, hot_frac: float = 0.08,
              force: str | None = None, name: str = "skew") -> DecisionNode:
    """Skew mitigation as a decision node: fire between exchange and join
    on the *observed* shuffle histogram — not a planner estimate — and
    rewrite the heavy part of the join fan-in (ROADMAP's skew half of the
    plan-language item; Lambada's exchange-balance concern).

    Context contract (fed by the planner on either plane before the node
    binds): ``profile["skew.partition_rows"]`` / ``["skew.partition_bytes"]``
    — per-join-bucket row/byte histograms summed over the shuffle writers
    (runtime: observed via ``InvocationRecord.stats``; simulator: exactly
    recomputed from the same partition contents), and
    ``profile["skew.hot_keys"]`` — the merged top-k heavy-hitter sketch
    ``((key, count), ...)``. Empty histograms (broadcast exchange, phantom
    tables) bind ``none`` — today's behavior, byte-identical on both
    planes. Decides ``Decision("none"|"salted"|"broadcast", n_extra_invs,
    schedule)`` reusing the join schedule's node set; ``extras`` carry
    everything stage materialization needs (``heavy`` buckets, ``salt``
    width, ``hot_keys``) plus the observed ``ratio`` so the audit log
    shows why.
    """

    def fn(ctx: DecisionContext) -> Decision:
        rows = tuple(ctx.profile.get("skew.partition_rows", ()))
        nbytes = tuple(ctx.profile.get("skew.partition_bytes", ()))
        sketch = tuple(ctx.profile.get("skew.hot_keys", ()))
        func, heavy, salt, hot = skew_mitigation(
            rows, sketch, threshold=threshold, min_rows=min_rows,
            salt_cap=salt_cap, hot_frac=hot_frac, force=force)
        join = ctx.decisions.get("join")
        sched = join.schedule if join is not None else Schedule(
            "round-robin", tuple(sorted(ctx.node_status.total_slots)))
        scale = len(heavy) * salt if func == "salted" else len(hot)
        return Decision(func, scale, sched,
                        extras=(("heavy", heavy), ("salt", salt),
                                ("hot_keys", hot),
                                ("ratio", round(partition_skew(rows), 4)),
                                ("max_bytes", max(nbytes, default=0)),
                                ("total_rows", sum(int(r) for r in rows))))

    return DecisionNode(name, fn, candidates=("none", "salted", "broadcast"))


@dataclass
class Stage:
    """One stage of a decision workflow: a decision node plus downstream
    function group it controls (the paper: "the scheduling of a group of
    functions as a decision node").

    ``depends_on`` orders decisions (upstream stages must have *decided*);
    ``await_feedback`` late-binds them (the named stages must also have had
    their runtime feedback folded into the context before this stage may
    decide). ``None`` means "same as depends_on" — the decision order and
    the feedback order coincide, which is the common linear case. Pass an
    explicit subset when a stage's physical work runs *after* a downstream
    decision (e.g. the exchange decision follows the join decision but both
    bind on the scan stage's feedback).
    """

    node: DecisionNode
    depends_on: tuple[str, ...] = ()
    await_feedback: tuple[str, ...] | None = None

    @property
    def awaits(self) -> tuple[str, ...]:
        return self.depends_on if self.await_feedback is None \
            else self.await_feedback


class LateBindingError(RuntimeError):
    """A decision was requested before its awaited feedback arrived."""


class WorkflowRun:
    """One incremental, late-bound evaluation of a workflow.

    Executors drive it between application stages:

        run = workflow.start(ctx)
        run.decide("scan")              # binds the scan decision
        ... execute the scan stage ...
        run.observe(post_scan_dist)     # fold observed data distribution
        run.feedback("scan", metrics)   # fold runtime feedback (Fig. 5 §4)
        run.decide("join")              # now sees what the scan produced

    ``decide`` refuses to run a stage whose upstream decisions or awaited
    feedback are missing — that is the late-binding contract.
    """

    def __init__(self, workflow: "DecisionWorkflow", ctx: DecisionContext):
        self.workflow = workflow
        self.ctx = ctx
        # the application this run plans for — set by the planner entry
        # points so decision audit entries attribute to the right query
        self.app: str | None = None
        self.decisions: dict[str, Decision] = {}
        self.fed: set[str] = set()

    def ready(self) -> list[str]:
        """Undecided stages whose deps have decided and feedback arrived."""
        out = []
        for name in self.workflow.order:
            if name in self.decisions:
                continue
            stage = self.workflow.stages[name]
            if all(d in self.decisions for d in stage.depends_on) and \
                    all(f in self.fed for f in stage.awaits):
                out.append(name)
        return out

    def decide(self, name: str) -> Decision:
        stage = self.workflow.stages[name]
        if name in self.decisions:
            raise LateBindingError(f"stage {name!r} already decided")
        undecided = [d for d in stage.depends_on if d not in self.decisions]
        unfed = [f for f in stage.awaits if f not in self.fed]
        if undecided or unfed:
            raise LateBindingError(
                f"stage {name!r} is not ready: undecided deps {undecided}, "
                f"awaiting feedback from {unfed}")
        from repro_torch.obs.audit import bound_app
        with bound_app(self.app):
            decision = stage.node.decide(self.ctx)
        self.decisions[name] = decision
        self.ctx.decisions = dict(self.ctx.decisions, **{name: decision})
        return decision

    def feedback(self, name: str, feedback: Mapping | None = None) -> None:
        """Fold a completed stage's runtime feedback and unblock dependents.

        Keys are merged into ``ctx.profile`` verbatim — callers prefix them
        (``"scan.seconds"``) when they want namespacing.
        """
        if feedback:
            merged = dict(self.ctx.profile)
            merged.update(feedback)
            self.ctx.profile = merged
        self.fed.add(name)

    def observe(self, dist: DataDist) -> None:
        """Fold an observed data distribution (e.g. post-filter scan output)
        into the context so later decisions see actual, not planned, sizes."""
        merged = dict(self.ctx.data_dist)
        merged[dist.name] = dist
        self.ctx.data_dist = merged

    def refresh_status(self, status: NodeStatus) -> None:
        """Update the resource view so late decisions see current free slots."""
        self.ctx.node_status = status

    def complete(self) -> bool:
        return len(self.decisions) == len(self.workflow.stages)

    @property
    def sequence(self) -> list[tuple[str, Decision]]:
        """The materialized decision sequence, in binding order."""
        return list(self.decisions.items())


class DecisionWorkflow:
    """A DAG of decision stages evaluated at runtime.

    ``start`` hands out a ``WorkflowRun`` for incremental, late-bound
    evaluation interleaved with application stages. ``run`` is the one-shot
    loop: it walks ready stages in insertion order, calls a user
    ``executor`` for each resolved decision, and folds the feedback the
    executor returns into the context for downstream stages (paper Fig. 5,
    step 4). One workflow may be shared by several planners (simulator and
    runtime); each ``start`` opens an independent run while the nodes'
    bounded histories accumulate across runs.
    """

    def __init__(self, name: str):
        self.name = name
        self.stages: dict[str, Stage] = {}
        self.order: list[str] = []
        self.last_run: WorkflowRun | None = None

    def add(self, node: DecisionNode, depends_on: Sequence[str] = (),
            await_feedback: Sequence[str] | None = None) -> "DecisionWorkflow":
        missing = [d for d in depends_on if d not in self.stages]
        missing += [f for f in (await_feedback or ()) if f not in self.stages]
        if missing:
            raise ValueError(f"unknown dependencies {missing} for {node.name}")
        if node.name in self.stages:
            raise ValueError(f"duplicate stage {node.name}")
        self.stages[node.name] = Stage(
            node, tuple(depends_on),
            None if await_feedback is None else tuple(await_feedback))
        self.order.append(node.name)
        return self

    def toposorted(self) -> list[str]:
        # insertion order is already valid because add() checks deps exist
        return list(self.order)

    def start(self, ctx: DecisionContext) -> WorkflowRun:
        self.last_run = WorkflowRun(self, ctx)
        return self.last_run

    def run(self, ctx: DecisionContext,
            executor: Callable[[str, Decision, DecisionContext], Mapping | None],
            ) -> dict[str, Decision]:
        run = self.start(ctx)
        while not run.complete():
            ready = run.ready()
            if not ready:
                stuck = [n for n in self.order if n not in run.decisions]
                raise LateBindingError(
                    f"workflow {self.name}: stages {stuck} never became "
                    f"ready (missing feedback?)")
            for name in ready:
                decision = run.decide(name)
                feedback = executor(name, decision, ctx)
                run.feedback(name, {f"{name}.{k}": v
                                    for k, v in (feedback or {}).items()})
        return dict(run.decisions)

    def explain(self) -> str:
        lines = [f"DecisionWorkflow({self.name})"]
        for name in self.order:
            stage = self.stages[name]
            lines.append(f"  {name} <- {list(stage.depends_on) or '[]'}"
                         f" [awaits {list(stage.awaits) or '[]'}]")
        return "\n".join(lines)
