"""Workflow-driven adaptive query planner (paper Fig. 5 step 4, Fig. 6).

One ``DecisionWorkflow`` per query carries five per-phase decision nodes —
``scan``, ``join``, ``exchange``, ``aggregate``, ``pipeline`` — and drives
the serverless runtime. ``AdaptiveQueryPlan`` is the runtime side: the DAG
executor calls it back as physical stages complete, it folds the observed
metrics and the **post-filter** scan output distribution into the workflow
context, binds the next decisions, and emits the newly materialized stages
— a mid-query re-plan. (The reference's simulator side,
``plan_query_with_workflow``, is not ported yet.)

The join node is late-bound on the scan stage: it sees ``A_scanned`` (the
post-filter fact distribution) instead of the raw input, so a highly
selective filter observed at runtime can flip the join variant mid-query —
a decision impossible under a plan-everything-up-front planner.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.analytics.decisions import ALPHA
from repro_torch.core.decisions import (
    DataDist,
    Decision,
    DecisionContext,
    DecisionNode,
    DecisionWorkflow,
    Schedule,
    WorkflowRun,
    elasticity_node,
    skew_node,
    tiering_node,
)

MAX_JOIN_FANOUT = 64      # runtime join bucket-space cap


# ---------------------------------------------------------------------------
# Per-phase decision nodes
# ---------------------------------------------------------------------------


def observed_join_ctx(ctx: DecisionContext) -> DecisionContext:
    """The join node's view: the post-scan distribution (``A_scanned``),
    when observed, replaces the raw fact input as side ``A``."""
    scanned = ctx.data_dist.get("A_scanned")
    if scanned is None:
        return ctx
    return DecisionContext(
        data_dist=dict(ctx.data_dist, A=scanned),
        node_status=ctx.node_status, app=ctx.app, profile=ctx.profile,
        decisions=ctx.decisions)


def scan_decision(ctx: DecisionContext) -> Decision:
    """Scans are data-local: one wave per ~ALPHA bytes over the input homes."""
    dist_f = ctx.data_dist["A"]
    nodes = tuple(sorted(dist_f.loc)) or \
        tuple(sorted(ctx.node_status.total_slots))
    scale = max(1, int(dist_f.size / ALPHA))
    return Decision("scan_filter", scale, Schedule("round-robin", nodes))


def consolidation_applies(strategy_name: str, decision: Decision,
                          total_bytes: int, threshold: int) -> bool:
    """The paper's consolidation policy, shared by the workflow join node
    and the legacy up-front shim: either the decision node itself opted in
    (cost model) or the literal Fig. 6 strategy sees the whole input fit
    one node."""
    return bool(decision.extra("consolidate", False)) or (
        strategy_name == "dynamic_fig6" and total_bytes <= threshold)


def strategy_join_fn(strategy, consolidate_threshold: int = 2 << 30):
    """Wrap a strategy's join choice as a late-bound workflow node fn.

    The wrapped node sees the observed post-filter fact distribution. When
    the paper's consolidation applies (whole input fits one node) the
    decision itself is rewritten to what will actually run — hash join,
    packed onto the data-heaviest node — so the recorded sequence never
    contradicts the materialized plan.
    """

    def fn(ctx: DecisionContext) -> Decision:
        decision = strategy.join_method(observed_join_ctx(ctx))
        dist_f = ctx.data_dist["A"]
        total = dist_f.size + ctx.data_dist["B"].size
        if consolidation_applies(strategy.name, decision, total,
                                 consolidate_threshold) and \
                not decision.extra("consolidate", False):
            slots = ctx.node_status.total_slots
            cap = max(slots.values()) if slots else 8
            target = max(dist_f.bytes_per_node,
                         key=dist_f.bytes_per_node.get) \
                if dist_f.bytes_per_node else 0
            decision = Decision(
                "hash_join", min(join_fanout(decision), cap),
                Schedule("packing", (target,), slots_per_node=cap),
                extras=decision.extras + (("consolidate", True),))
        return decision

    return fn


def join_fanout(join: Decision) -> int:
    return max(1, min(int(join.scale), MAX_JOIN_FANOUT))


def decide_elastic(run: WorkflowRun, fanout: int, pool: int) -> Decision:
    """Plant the elastic node's context contract — the upcoming fan-out and
    the current pool size — and bind it. One helper shared by both planes,
    so the profile keys (and therefore the bound sequences) cannot drift
    between the simulator and the runtime."""
    run.ctx.profile["elastic.fanout"] = int(fanout)
    run.ctx.profile["elastic.pool"] = int(pool)
    return run.decide("elastic")


def decide_skew(run: WorkflowRun, rows_hist, bytes_hist,
                hot_keys) -> Decision:
    """Plant the skew node's context contract — the observed (runtime) or
    exactly recomputed (simulator) shuffle histogram and merged
    heavy-hitter sketch — and bind it. One helper shared by both planes,
    so the profile keys (and therefore the bound sequences) cannot drift
    between the simulator and the runtime."""
    run.ctx.profile["skew.partition_rows"] = tuple(
        int(r) for r in rows_hist)
    run.ctx.profile["skew.partition_bytes"] = tuple(
        int(b) for b in bytes_hist)
    run.ctx.profile["skew.hot_keys"] = tuple(
        (int(k), int(c)) for k, c in hot_keys)
    return run.decide("skew")


# rough per-row bytes of a two-phase partial-aggregate bucket (group key +
# accumulator), used only to *estimate* the partials stage for tiering
PARTIAL_AGG_ROW_BYTES = 16


def ephemeral_stage_profile(scanned: DataDist, dist_b: DataDist,
                            join: Decision, exchange: Decision,
                            num_groups: int,
                            skew: Decision | None = None) -> tuple:
    """``(stage, est_bytes, lineage_depth, downstream_remaining)`` for each
    ephemeral data stage the chosen physical plan will reclaim, in reclaim
    order — the tiering node's sizing input. Every number is derived from
    the bound plan (estimated scan output, dim distribution, join fan-out,
    skew mitigation extras), never measured, so the runtime and the
    simulator price the same stages identically."""
    n_join = join_fanout(join)
    partials = PARTIAL_AGG_ROW_BYTES * int(num_groups) * n_join
    if exchange.func == "shuffle":
        stages = [("fact_buckets", int(scanned.size), 2, 2),
                  ("dim_buckets", int(dist_b.size), 2, 2)]
        # salted sub-joins write straight into extra ``joined`` partitions,
        # so the ``joined`` entry below already covers their output bytes
        if skew is not None and skew.func == "broadcast":
            # replicated hot build side: ~one dim row per heavy-hitter key
            row_b = (int(dist_b.size) // max(1, int(dist_b.rows))) \
                if dist_b.rows else 0
            stages.append(("dim_hot",
                           row_b * len(skew.extra("hot_keys", ())), 2, 1))
        stages += [("joined", int(scanned.size), 3, 1),
                   ("partials", partials, 4, 0)]
        return tuple(stages)
    # broadcast path: the dim broadcast is never reclaimed (no ephemeral
    # input names it), so only the join output and the partials spill
    return (("joined", int(scanned.size), 2, 1),
            ("partials", partials, 3, 0))


def decide_tiering(run: WorkflowRun, stages, quota: int | None,
                   tiers) -> Decision:
    """Plant the tiering node's context contract — the plan's ephemeral
    stages, the app's store quota, and the cold-tier specs — and bind it.
    One helper shared by both planes, so the profile keys (and therefore
    the bound sequences) cannot drift between simulator and runtime."""
    run.ctx.profile["tiering.stages"] = tuple(stages)
    run.ctx.profile["tiering.quota"] = None if quota is None else int(quota)
    run.ctx.profile["tiering.tiers"] = dict(tiers or {})
    return run.decide("tiering")


def exchange_decision(ctx: DecisionContext) -> Decision:
    """The exchange pattern follows the bound join decision: merge join
    hash-shuffles both sides into the join's bucket space, hash join
    broadcasts the (small) dim side from its home nodes."""
    join = ctx.decisions["join"]
    dist_a = ctx.data_dist.get("A_scanned", ctx.data_dist["A"])
    dist_b = ctx.data_dist["B"]
    n_join = join_fanout(join)
    if join.func == "merge_join":
        producers = tuple(sorted(dist_a.loc | dist_b.loc)) or \
            tuple(sorted(ctx.node_status.total_slots))
        return Decision("shuffle", n_join,
                        Schedule("round-robin", producers),
                        extras=(("num_buckets", n_join),))
    homes = tuple(sorted(dist_b.loc)) or \
        tuple(sorted(ctx.node_status.total_slots))
    return Decision("broadcast", max(1, len(homes)),
                    Schedule("round-robin", homes))


def aggregate_decision(ctx: DecisionContext) -> Decision:
    """Two-phase aggregation co-located with the join outputs."""
    join = ctx.decisions["join"]
    return Decision("two_phase", join_fanout(join), join.schedule)


# per-bucket bytes under which the fused partition+probe kernel's build
# side comfortably fits the fused probe (one-hot probe over the whole
# bucket); a control-plane constant equal to the reference's, so the
# pipeline decisions match
FUSED_BUCKET_BYTES = 4 << 20
PREFETCH_DEPTH = 2            # in-flight partition fetches per join side


def pipeline_decision(ctx: DecisionContext) -> Decision:
    """Shuffle→join coupling: stage ``barrier`` vs partition-``pipelined``
    consumption vs the ``fused`` partition+probe kernel.

    A control-plane choice, not a data-plane flag: it binds from the
    *observed* post-scan volume (bucket size = both sides over the join
    fan-out) and the controller's free-slot view. Small buckets take the
    fused single-dispatch kernel (its build side must fit on chip); otherwise
    free slots make partition-granularity pipelining worthwhile (consumers
    can launch while producers still hold slots); a saturated cluster keeps
    the stage barrier — pipelining would only queue behind producers. The
    ``scale`` is the per-side prefetch depth (double buffering)."""
    join = ctx.decisions["join"]
    dist_a = ctx.data_dist.get("A_scanned", ctx.data_dist["A"])
    dist_b = ctx.data_dist["B"]
    n_join = join_fanout(join)
    bucket = (dist_a.size + dist_b.size) / max(1, n_join)
    if bucket <= FUSED_BUCKET_BYTES:
        return Decision("fused", PREFETCH_DEPTH, join.schedule,
                        extras=(("bucket_bytes", int(bucket)),))
    if ctx.node_status.free() > 0:
        return Decision("pipelined", PREFETCH_DEPTH, join.schedule,
                        extras=(("bucket_bytes", int(bucket)),))
    return Decision("barrier", 1, join.schedule,
                    extras=(("bucket_bytes", int(bucket)),))


def build_query_workflow(strategy, name: str | None = None,
                         consolidate_threshold: int = 2 << 30,
                         elastic_max_workers: int = 16,
                         skew_threshold: float = 2.0,
                         skew_min_rows: int = 4096,
                         skew_force: str | None = None,
                         ) -> DecisionWorkflow:
    """The query's decision workflow (paper Fig. 5): eight per-phase nodes.

    ``join`` is late-bound on the scan stage's feedback; ``exchange``,
    ``aggregate`` and ``pipeline`` follow the join *decision* (their
    physical effect brackets the join stage) but await only the scan
    feedback. ``skew`` is the latest-bound node of all: it awaits the
    *exchange* stage's feedback — the observed per-bucket shuffle
    histogram — and fires between exchange and join, choosing none /
    salted / broadcast mitigation (``skew_force`` pins the choice for A/B
    benchmarking). ``elastic`` sizes the worker pool for the join fan-out
    about to queue, and ``tiering`` chooses spill-vs-evict per ephemeral
    stage of the chosen plan — both decided from plan-derived inputs
    planted in the profile by the planner, so the simulator and the
    runtime bind identical sequences.
    """
    wf = DecisionWorkflow(name or f"query[{strategy.name}]")
    wf.add(DecisionNode("scan", scan_decision,
                        candidates=("scan_filter",)))
    wf.add(DecisionNode("join",
                        strategy_join_fn(strategy, consolidate_threshold),
                        candidates=("hash_join", "merge_join")),
           depends_on=("scan",))
    wf.add(DecisionNode("exchange", exchange_decision,
                        candidates=("shuffle", "broadcast")),
           depends_on=("join",), await_feedback=("scan",))
    wf.add(skew_node(threshold=skew_threshold, min_rows=skew_min_rows,
                     force=skew_force),
           depends_on=("exchange",), await_feedback=("exchange",))
    wf.add(DecisionNode("aggregate", aggregate_decision,
                        candidates=("two_phase",)),
           depends_on=("exchange",), await_feedback=("scan",))
    wf.add(DecisionNode("pipeline", pipeline_decision,
                        candidates=("barrier", "pipelined", "fused")),
           depends_on=("exchange",), await_feedback=("scan",))
    wf.add(elasticity_node(max_workers=elastic_max_workers),
           depends_on=("join",), await_feedback=("scan",))
    wf.add(tiering_node(),
           depends_on=("exchange",), await_feedback=("scan",))
    return wf


def resolve_query_workflow(workflow: DecisionWorkflow | None, strategy,
                           consolidate_threshold: int | None,
                           ) -> DecisionWorkflow:
    """Reuse a caller-supplied workflow or build one. The consolidation
    threshold is baked into a workflow's join node at build time, so
    passing both is a contradiction, not a merge."""
    if workflow is not None:
        if consolidate_threshold is not None:
            raise ValueError(
                "consolidate_threshold is fixed when the workflow is built; "
                "pass it to build_query_workflow, not alongside an existing "
                "workflow")
        return workflow
    return build_query_workflow(
        strategy,
        consolidate_threshold=2 << 30 if consolidate_threshold is None
        else consolidate_threshold)


# ---------------------------------------------------------------------------
# Runtime materialization: decisions -> RuntimeStages
# ---------------------------------------------------------------------------


def _inv(app: str, stage: str, i: int, fn: str, node: int, params: dict,
         priority: int, batchable: bool = False, needs: tuple = ()):
    from repro_torch.runtime.invoker import Invocation
    return Invocation(f"{app}/{stage}/{i}", app, stage, i, fn, node,
                      priority=priority, params=params, batchable=batchable,
                      needs=needs)


def scan_stages(app: str, fact_layout: Sequence[tuple[int, int]],
                dim_layout: Sequence[tuple[int, int]],
                priority: int = 0) -> list:
    """Data-local scan stages; independent, so the dependency-driven
    executor runs them concurrently under a parallel invoker. Scans are
    map-shaped (one partition in, one out): ``batchable`` lets the invoker
    coalesce co-located instances into one slot claim."""
    from repro_torch.runtime.executor import RuntimeStage
    return [
        RuntimeStage("scan_fact", [
            _inv(app, "scan_fact", i, "scan_filter", node,
                 {"src": "input/fact", "dst": "scan_fact", "partition": i,
                  "filter_col": "v0", "filter_gt": 0.0}, priority,
                 batchable=True)
            for i, node in fact_layout], decision="scan"),
        RuntimeStage("scan_dim", [
            _inv(app, "scan_dim", j, "scan_filter", node,
                 {"src": "input/dim", "dst": "scan_dim", "partition": j},
                 priority, batchable=True)
            for j, node in dim_layout], decision="scan"),
    ]


def _tail_shape(fact_layout, dim_layout, decision: Decision,
                dist_f: DataDist, consolidated: bool,
                exchange: Decision | None, aggregate: Decision | None,
                pipeline: Decision | None):
    """Shared geometry of the post-scan plan: join fan-out, placements,
    exchange pattern and pipeline mode — one derivation for the exchange
    wave and the join/aggregate wave, so a plan emitted in two waves is
    identical to the same plan emitted at once."""
    all_nodes = tuple(sorted({n for _, n in fact_layout} |
                             {n for _, n in dim_layout}))
    plan_mode = pipeline.func if pipeline is not None else "barrier"
    n_join = join_fanout(decision)
    join_nodes = decision.schedule.place(n_join) or \
        tuple(all_nodes[i % len(all_nodes)] for i in range(n_join))
    func = decision.func
    if consolidated:
        target = max(dist_f.bytes_per_node, key=dist_f.bytes_per_node.get) \
            if dist_f.bytes_per_node else all_nodes[0]
        join_nodes = (target,) * n_join
        func = "hash_join"
    pattern = exchange.func if exchange is not None else \
        ("shuffle" if func == "merge_join" else "broadcast")
    agg_nodes = (aggregate.schedule.place(n_join) or join_nodes) \
        if aggregate is not None and not consolidated else join_nodes
    return all_nodes, plan_mode, n_join, join_nodes, pattern, agg_nodes


def exchange_stages(app: str, fact_layout: Sequence[tuple[int, int]],
                    dim_layout: Sequence[tuple[int, int]],
                    decision: Decision, dist_f: DataDist,
                    consolidated: bool = False, priority: int = 0,
                    exchange: Decision | None = None) -> list:
    """The shuffle half of the post-scan plan — emitted as its own wave so
    the skew node can bind on the *observed* shuffle histogram before the
    join/aggregate wave materializes. Only meaningful for the shuffle
    exchange pattern (the broadcast pattern has nothing to observe; its
    whole tail is emitted at once)."""
    from repro_torch.runtime.executor import RuntimeStage

    _, _, n_join, _, pattern, _ = _tail_shape(
        fact_layout, dim_layout, decision, dist_f, consolidated, exchange,
        None, None)
    if pattern != "shuffle":
        return []
    return [
        RuntimeStage("shuffle_fact", [
            _inv(app, "shuffle_fact", i, "shuffle_write", node,
                 {"src": "scan_fact", "dst": "fact_buckets",
                  "partition": i, "num_buckets": n_join}, priority,
                 batchable=True, needs=(f"{app}/scan_fact/{i}",))
            for i, node in fact_layout], deps=("scan_fact",),
            decision="exchange"),
        RuntimeStage("shuffle_dim", [
            _inv(app, "shuffle_dim", j, "shuffle_write", node,
                 {"src": "scan_dim", "dst": "dim_buckets",
                  "partition": j, "num_buckets": n_join}, priority,
                 batchable=True, needs=(f"{app}/scan_dim/{j}",))
            for j, node in dim_layout], deps=("scan_dim",),
            decision="exchange"),
    ]


def join_agg_stages(app: str, fact_layout: Sequence[tuple[int, int]],
                    dim_layout: Sequence[tuple[int, int]],
                    decision: Decision, dist_f: DataDist,
                    consolidated: bool = False, num_groups: int = 64,
                    priority: int = 0,
                    exchange: Decision | None = None,
                    aggregate: Decision | None = None,
                    pipeline: Decision | None = None,
                    skew: Decision | None = None) -> list:
    """Materialize the join + aggregation wave from the bound decisions:
    the ``exchange`` decision picks the pattern (``shuffle`` both sides
    into the join's bucket space vs ``broadcast`` the dim side), the join
    decision's ``scale``/``schedule`` set the join fan-out and placement,
    and the ``aggregate`` decision places the two-phase aggregation. When
    only the join decision is given (legacy up-front path) the exchange
    pattern is derived from its ``func`` and aggregation co-locates with
    the join; ``consolidated`` then packs the whole tail onto the
    data-heaviest node (workflow-built consolidated decisions already
    carry that placement).

    The ``pipeline`` decision (barrier / pipelined / fused) rides along as
    a ``plan`` parameter on every join invocation, and every invocation
    carries ``needs`` — the producer invocations whose commits complete its
    inputs — so a pipelining executor can launch it at partition
    granularity. Both are *always* materialized from the bound decision:
    whether the executor honors them is its own flag, so the emitted plan
    (and the decision audit) is byte-identical with pipelining on or off.

    The ``skew`` decision rewrites the heavy part of the shuffle join's
    fan-in without touching anything downstream:

      * ``salted`` — each heavy bucket becomes ``salt`` *writer-sharded*
        sub-joins (``salted_join`` stage): each sub-join reads only its
        round-robin share of the bucket's per-writer slices (the store
        keeps every shuffle writer's slice separately, so a shard read
        moves 1/salt of the bucket's bytes) and writes straight into an
        extra ``joined`` partition the aggregation folds like any other.
        The normal join stage simply skips the heavy buckets, and no
        single invocation ever pulls a heavy bucket whole — the read, not
        just the probe, is what skew serializes. Sub-join ``needs`` edges
        are per-shard: a shard launches as soon as ITS writers (plus the
        dim side's) committed. Bucket reclaim moves from the join stage
        to partial_agg, whose deps cover every bucket reader.
      * ``broadcast`` — the heavy-hitter keys are joined separately: one
        ``hot_build`` invocation replicates their dim rows from the scan
        output, and per-fact-partition ``hot_join`` probes write extra
        ``joined`` partitions. The buckets that contain the hot keys are
        still heavy to *read*, so they get the same writer-sharded
        sub-joins with ``drop_keys`` folded in (single-shard fallback:
        a plain ``drop_keys`` join).

    Either way the ``partials``/``result`` layout downstream stages see
    is exactly the unmitigated plan's — mitigation is control-plane-
    visible (audited) but invisible to the aggregation contract.
    """
    from repro_torch.runtime.executor import RuntimeStage

    all_nodes, plan_mode, n_join, join_nodes, pattern, agg_nodes = \
        _tail_shape(fact_layout, dim_layout, decision, dist_f, consolidated,
                    exchange, aggregate, pipeline)

    stages = []
    if pattern == "shuffle":
        skew_func = skew.func if skew is not None else "none"
        heavy = {int(b): int(r)
                 for b, r in (skew.extra("heavy", ()) if skew else ())}
        hot = tuple(int(k) for k in
                    (skew.extra("hot_keys", ()) if skew else ()))
        salt = int(skew.extra("salt", 0)) if skew is not None else 0
        # hash distribution is all-to-all: every join bucket may hold rows
        # from every writer, so a join's inputs are complete only once ALL
        # shuffle writers committed
        fact_writers = tuple(f"{app}/shuffle_fact/{i}"
                             for i, _ in fact_layout)
        dim_writers_sh = tuple(f"{app}/shuffle_dim/{j}"
                               for j, _ in dim_layout)
        writers = fact_writers + dim_writers_sh
        broadcast_hot = skew_func == "broadcast" and bool(hot)
        hot_buckets: set[int] = set()
        if broadcast_hot:
            from repro_torch.kernels import ops as kops
            hot_buckets = {int(b) for b in np.asarray(
                kops.partition_ids(np.asarray(hot, np.int32), n_join))}
        # which buckets get writer-sharded sub-joins, and the extra params
        # their sub-joins carry. Sharding needs >= 2 fact writers: with one
        # writer a "shard" would be the whole bucket again
        n_shard = min(salt, len(fact_writers))
        shard: dict[int, dict] = {}
        if n_shard > 1:
            if skew_func == "salted" and heavy:
                shard = {r: {} for r in sorted(heavy)}
            elif broadcast_hot:
                shard = {r: {"drop_keys": hot} for r in sorted(hot_buckets)}
        # buckets stay alive until partial_agg when a sharded stage also
        # reads them; the unmitigated plan reclaims at the join stage
        # exactly as before
        join_ephemeral = () if shard else ("fact_buckets", "dim_buckets")
        join_invs = []
        for r in range(n_join):
            if r in shard:
                continue   # the writer-sharded sub-joins cover this bucket
            params = {"fact_stage": "fact_buckets", "fact_partitions": [r],
                      "dim_stage": "dim_buckets", "dim_partitions": [r],
                      "dst": "joined", "partition": r,
                      "num_groups": num_groups, "plan": plan_mode}
            if broadcast_hot and r in hot_buckets:
                params["drop_keys"] = hot
            join_invs.append(
                _inv(app, "join", r, "merge_join_partition", join_nodes[r],
                     params, priority, needs=writers))
        stages += [
            RuntimeStage("join", join_invs,
                         deps=("shuffle_fact", "shuffle_dim"),
                         ephemeral_inputs=join_ephemeral, decision="join"),
        ]
        agg_parts = [r for r in range(n_join) if r not in shard]
        agg_needs = {r: (f"{app}/join/{r}",) for r in agg_parts}
        agg_deps = ("join",)
        agg_ephemeral = ("joined",)
        if shard:
            # extra joined partitions: hot_join probes (broadcast) own
            # n_join .. n_join+len(fact_layout)-1, shard outputs follow
            base = n_join + (len(fact_layout) if broadcast_hot else 0)
            salt_nodes = skew.schedule.place(len(shard) * n_shard) \
                or join_nodes
            sub_invs = []
            si = 0
            for r in sorted(shard):
                for g in range(n_shard):
                    group = fact_writers[g::n_shard]
                    params = {"fact_stage": "fact_buckets",
                              "fact_partitions": [r],
                              "fact_writers": group,
                              "dim_stage": "dim_buckets",
                              "dim_partitions": [r],
                              "dst": "joined", "partition": base + si,
                              "num_groups": num_groups, "plan": plan_mode}
                    params.update(shard[r])
                    sub_invs.append(_inv(
                        app, "salted_join", si, "salted_join_partition",
                        salt_nodes[si % len(salt_nodes)], params, priority,
                        needs=group + dim_writers_sh))
                    agg_needs[base + si] = (f"{app}/salted_join/{si}",)
                    agg_parts.append(base + si)
                    si += 1
            stages += [
                RuntimeStage("salted_join", sub_invs,
                             deps=("shuffle_fact", "shuffle_dim"),
                             decision="skew"),
            ]
            agg_deps = ("join", "salted_join")
            agg_ephemeral = ("joined", "fact_buckets", "dim_buckets")
        if broadcast_hot:
            dim_writers = tuple(f"{app}/scan_dim/{j}" for j, _ in dim_layout)
            stages += [
                RuntimeStage("hot_build", [
                    _inv(app, "hot_build", 0, "hot_filter_write",
                         dim_layout[0][1],
                         {"src": "scan_dim",
                          "src_partitions": [j for j, _ in dim_layout],
                          "keys": hot, "dst": "dim_hot"}, priority,
                         needs=dim_writers)],
                    deps=("scan_dim",), decision="skew"),
                RuntimeStage("hot_join", [
                    _inv(app, "hot_join", i, "hot_join_partition", node,
                         {"fact_stage": "scan_fact", "fact_partitions": [i],
                          "dim_stage": "dim_hot", "dim_partitions": [0],
                          "keep_keys": hot, "dst": "joined",
                          "partition": n_join + i,
                          "num_groups": num_groups, "plan": plan_mode},
                         priority,
                         needs=(f"{app}/scan_fact/{i}",
                                f"{app}/hot_build/0"))
                    for i, node in fact_layout],
                    deps=("scan_fact", "hot_build"), decision="skew"),
            ]
            for i, _node in fact_layout:
                agg_needs[n_join + i] = (f"{app}/hot_join/{i}",)
                agg_parts.append(n_join + i)
            agg_deps = agg_deps + ("hot_join",)
            agg_ephemeral = agg_ephemeral + ("dim_hot",)
    else:
        agg_parts = list(range(n_join))
        agg_needs = {r: (f"{app}/join/{r}",) for r in range(n_join)}
        agg_deps = ("join",)
        agg_ephemeral = ("joined",)
        bcast = tuple(f"{app}/broadcast_dim/{j}" for j, _ in dim_layout)
        stages += [
            RuntimeStage("broadcast_dim", [
                _inv(app, "broadcast_dim", j, "broadcast_write", node,
                     {"src": "scan_dim", "dst": "dim_bcast", "partition": j},
                     priority, batchable=True,
                     needs=(f"{app}/scan_dim/{j}",))
                for j, node in dim_layout], deps=("scan_dim",),
                decision="exchange"),
            RuntimeStage("join", [
                _inv(app, "join", k, "hash_join_partition", join_nodes[k],
                     {"fact_stage": "scan_fact",
                      "fact_partitions": [i for i, _ in fact_layout
                                          if i % n_join == k],
                      "dim_stage": "dim_bcast", "dim_partitions": "all",
                      "dst": "joined", "partition": k,
                      "num_groups": num_groups, "plan": plan_mode},
                     priority,
                     needs=bcast + tuple(
                         f"{app}/scan_fact/{i}" for i, _ in fact_layout
                         if i % n_join == k))
                for k in range(n_join)],
                deps=("scan_fact", "broadcast_dim"), decision="join"),
        ]

    pagg_nodes = {k: agg_nodes[j % len(agg_nodes)]
                  for j, k in enumerate(agg_parts)}
    stages += [
        RuntimeStage("partial_agg", [
            _inv(app, "partial_agg", k, "partial_aggregate", pagg_nodes[k],
                 {"src": "joined", "dst": "partials", "partition": k,
                  "num_groups": num_groups}, priority, batchable=True,
                 needs=agg_needs[k])
            for k in agg_parts], deps=agg_deps,
            ephemeral_inputs=agg_ephemeral, decision="aggregate"),
        RuntimeStage("final_agg", [
            _inv(app, "final_agg", 0, "final_aggregate", agg_nodes[0],
                 {"src": "partials", "dst": "result",
                  "num_groups": num_groups}, priority,
                 needs=tuple(f"{app}/partial_agg/{k}"
                             for k in agg_parts))],
            deps=("partial_agg",), ephemeral_inputs=("partials",),
            decision="aggregate"),
    ]
    return stages


def tail_stages(app: str, fact_layout: Sequence[tuple[int, int]],
                dim_layout: Sequence[tuple[int, int]], decision: Decision,
                dist_f: DataDist, consolidated: bool = False,
                num_groups: int = 64, priority: int = 0,
                exchange: Decision | None = None,
                aggregate: Decision | None = None,
                pipeline: Decision | None = None,
                skew: Decision | None = None) -> list:
    """The full post-scan plan in one list: the exchange wave (when the
    pattern shuffles) followed by the join/aggregate wave — what the
    adaptive planner emits in two callbacks, concatenated. Static callers
    (``stages_for_run``, the up-front legacy path) use this; they already
    hold every decision, including skew."""
    return exchange_stages(
        app, fact_layout, dim_layout, decision, dist_f,
        consolidated=consolidated, priority=priority, exchange=exchange,
    ) + join_agg_stages(
        app, fact_layout, dim_layout, decision, dist_f,
        consolidated=consolidated, num_groups=num_groups, priority=priority,
        exchange=exchange, aggregate=aggregate, pipeline=pipeline,
        skew=skew)


class AdaptiveQueryPlan:
    """Stage planner driving one ``WorkflowRun`` against the runtime.

    The DAG executor calls ``on_stage_complete`` as physical stages finish.
    The decide→execute→re-decide loop now has two re-plan points:

    1. Once ``scan_fact`` lands, the measured metrics and the observed
       post-filter distribution bind ``join`` and ``exchange``. A shuffle
       exchange emits only the shuffle wave; a broadcast exchange has no
       shuffle histogram to wait for, so the skew node binds immediately
       (trivially ``none``) and the whole tail is emitted.
    2. Once both shuffle stages land, the observed per-bucket histogram
       and heavy-hitter sketch from ``profile_feedback`` bind ``skew``,
       then ``aggregate``/``pipeline``/``elastic``/``tiering``, and the
       join/aggregate wave — including any mitigation stages — is emitted.

    Two-wave emission costs nothing at s=0: every join invocation needs
    ALL shuffle writers (hash distribution is all-to-all), so no join
    could have launched before the shuffle completed anyway.
    """

    def __init__(self, run: WorkflowRun, app: str,
                 fact_layout: Sequence[tuple[int, int]],
                 dim_layout: Sequence[tuple[int, int]],
                 num_groups: int = 64, priority: int = 0):
        self.run = run
        self.app = app
        self.fact_layout = list(fact_layout)
        self.dim_layout = list(dim_layout)
        self.num_groups = num_groups
        self.priority = priority
        self._completed: set[str] = set()
        self._tail_planned = False
        self._join_planned = False
        self._join_d: Decision | None = None
        self._exchange_d: Decision | None = None
        self._scanned: DataDist | None = None

    def initial_stages(self) -> list:
        self.run.decide("scan")
        return scan_stages(self.app, self.fact_layout, self.dim_layout,
                           self.priority)

    def on_stage_complete(self, stage: str, runtime, pc=None) -> list:
        self._completed.add(stage)
        # The join decision needs only the *fact* side's observed post-filter
        # output (the dim side has no filter, its input dist is app
        # knowledge) — so the first wave binds as soon as scan_fact lands,
        # and e.g. shuffle_fact overlaps a still-running scan_dim.
        if not self._tail_planned:
            if "scan_fact" not in self._completed:
                return []
            return self._plan_exchange(runtime, pc)
        if not self._join_planned and self._exchange_d is not None and \
                self._exchange_d.func == "shuffle" and \
                {"shuffle_fact", "shuffle_dim"} <= self._completed:
            return self._plan_join_tail(runtime)
        return []

    def _plan_exchange(self, runtime, pc) -> list:
        self._tail_planned = True
        # Fig. 5 step 4: fold observed output + metrics, then decide late.
        scanned = runtime.store.data_dist(self.app, "scan_fact",
                                          name="A_scanned")
        if pc is not None:
            pc.observe_data(scanned)
        self.run.observe(scanned)
        self.run.refresh_status(runtime.gc.node_status())
        self.run.feedback("scan",
                          runtime.metrics.profile_feedback(self.app))
        join_d = self.run.decide("join")
        exchange_d = self.run.decide("exchange")
        self._join_d, self._exchange_d, self._scanned = \
            join_d, exchange_d, scanned
        if exchange_d.func == "shuffle":
            # emit only the shuffle wave: the skew node (and everything
            # after it) binds on the observed bucket histogram in wave 2
            return exchange_stages(
                self.app, self.fact_layout, self.dim_layout, join_d,
                self.run.ctx.data_dist["A"], priority=self.priority,
                exchange=exchange_d)
        # broadcast exchange: no shuffle to observe — skew binds now, on
        # an empty histogram, and trivially decides "none"
        self._join_planned = True
        self.run.feedback("exchange", {})
        skew_d = decide_skew(self.run, (), (), ())
        return self._plan_rest(runtime, skew_d)

    def _plan_join_tail(self, runtime) -> list:
        self._join_planned = True
        # wave 2, Fig. 5 step 4 again: the *observed* shuffle histogram
        # and merged heavy-hitter sketch feed the skew node
        fb = runtime.metrics.profile_feedback(self.app)
        self.run.feedback("exchange", fb)
        rows = tuple(fb.get("shuffle_fact.partition_rows", ()))
        nbytes = tuple(fb.get("shuffle_fact.partition_bytes", ()))
        hot = tuple(fb.get("shuffle_fact.hot_keys", ()))
        skew_d = decide_skew(self.run, rows, nbytes, hot)
        # partition balance as counter tracks: visible in the Chrome trace
        # next to slot occupancy and store bytes
        from repro_torch.obs.tracer import get_tracer
        tr = get_tracer()
        if tr.enabled and nbytes:
            tr.count(f"skew/{self.app}/max_partition_bytes", max(nbytes))
            tr.count(f"skew/{self.app}/mean_partition_bytes",
                     int(sum(nbytes) / len(nbytes)))
            tr.count(f"skew/{self.app}/hot_keys", len(hot))
        return self._plan_rest(runtime, skew_d)

    def _plan_rest(self, runtime, skew_d: Decision) -> list:
        join_d, exchange_d, scanned = \
            self._join_d, self._exchange_d, self._scanned
        aggregate_d = self.run.decide("aggregate")
        pipeline_d = self.run.decide("pipeline")
        # elasticity: size the worker pool for the join fan-out about to
        # queue; on backends without a pool (threads, inline) the decision
        # still binds and is audited, it just has nothing to resize
        pool_size = getattr(runtime.invoker, "pool_size", None)
        elastic_d = decide_elastic(
            self.run, join_fanout(join_d),
            int(pool_size()) if callable(pool_size) else 0)
        resize = getattr(runtime.invoker, "resize", None)
        if callable(resize) and elastic_d.func != "hold":
            resize(int(elastic_d.scale))
        # tiering: price spill-vs-evict for the plan's ephemeral stages
        # against the store's cold tiers; the bound plan becomes the spill
        # policy reclaim/eviction consults. Stores without spill backends
        # (or apps without quotas) bind "keep" — today's behavior
        store = runtime.store
        tier_d = decide_tiering(
            self.run,
            ephemeral_stage_profile(scanned, self.run.ctx.data_dist["B"],
                                    join_d, exchange_d, self.num_groups,
                                    skew=skew_d),
            store.quota(self.app), store.storage_spec())
        if tier_d.func != "keep":
            store.set_spill_policy(self.app, dict(tier_d.extra("plan", ())))
        # consolidated join decisions already carry their packed placement,
        # so the materialization is exactly what the sequence records
        return join_agg_stages(
            self.app, self.fact_layout, self.dim_layout, join_d,
            self.run.ctx.data_dist["A"], num_groups=self.num_groups,
            priority=self.priority, exchange=exchange_d,
            aggregate=aggregate_d, pipeline=pipeline_d, skew=skew_d)


def stages_for_run(run: WorkflowRun, app: str,
                   fact_layout: Sequence[tuple[int, int]],
                   dim_layout: Sequence[tuple[int, int]],
                   num_groups: int = 64, priority: int = 0) -> list:
    """Materialize the full physical stage list from an already-bound
    ``WorkflowRun`` — the *static* twin of ``AdaptiveQueryPlan``'s
    incremental emission, used by the simulator-side fault model to predict
    recovery stage sets (``repro_torch.runtime.lineage.expected_recovery``) for
    the exact plan the decisions imply."""
    return scan_stages(app, fact_layout, dim_layout, priority) + tail_stages(
        app, fact_layout, dim_layout, run.decisions["join"],
        run.ctx.data_dist["A"], num_groups=num_groups, priority=priority,
        exchange=run.decisions.get("exchange"),
        aggregate=run.decisions.get("aggregate"),
        pipeline=run.decisions.get("pipeline"),
        skew=run.decisions.get("skew"))
