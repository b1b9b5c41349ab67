"""TPC-DS-like sub-query (paper §6): two MapReduce phases + a Join phase.

    Q: SELECT d.cat, SUM(f.v0 * f.v1)
       FROM fact f JOIN dim d ON f.key = d.key
       WHERE f.v0 > 0
       GROUP BY d.cat

Execution under Proteus: one decision workflow per query (scan → join →
exchange → skew → aggregate → pipeline → elastic → tiering, see
``repro_torch.analytics.planner``) drives both data planes. Decisions are
**late-bound**: the join node is evaluated only after the scan stage's
runtime feedback has been folded into the context, so a selective filter
can flip the join variant mid-query. On the serverless runtime the DAG
executor interleaves decision evaluation with stage completion through
``AdaptiveQueryPlan``; on the cluster simulator the same workflow binds the
same decision sequence against an estimated scan output.
``execute_query_runtime`` and ``plan_query_tasks`` are thin wrappers over
that shared machinery; ``execute_query_torch`` runs the logical plan
in-process for correctness tests against a numpy oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.analytics import operators as ops
from repro_torch.analytics.decisions import ALPHA
from repro_torch.analytics.planner import (
    AdaptiveQueryPlan,
    plan_query_with_workflow,
    resolve_query_workflow as _resolve_workflow,
    scan_stages,
    tail_stages,
)
from repro_torch.analytics.simulator import ClusterSim
from repro_torch.analytics.table import (
    DistTable,
    Table,
    distribute,
    from_numpy,
    synth_table,
    to_numpy,
)
from repro_torch.core.controllers import GlobalController, PrivateController
from repro_torch.core.decisions import (
    DataDist,
    Decision,
    DecisionContext,
    DecisionWorkflow,
    Schedule,
)


def synth_query_tables(rows: int = 4096, dim_rows: int = 512,
                       keyspace: int | None = None, seed: int = 1,
                       fact_nodes=4, dim_nodes=2, num_groups: int = 64,
                       zipf: float = 0.0, heavy_hitters: int = 0,
                       device=None,
                       ) -> tuple[DistTable, DistTable, np.ndarray]:
    """Synthetic fact/dim pair + numpy oracle for the TPC-DS-like sub-query.

    Draws exactly the reference's bytes from the same seeds. ``fact_nodes``
    / ``dim_nodes`` take a node count (placed on ``0..n-1``) or an explicit
    node iterable; the dim table uses ``seed + 1``. ``zipf=s`` draws fact
    keys from a Zipf(s) law; ``heavy_hitters=H`` routes ~half the rows to
    ``H`` seeded hot keys. Returns ``(fact, dim, reference_sums)``.
    """
    ks = keyspace if keyspace is not None else 2 * max(rows, dim_rows)
    if zipf or heavy_hitters:
        fact = _synth_skewed_fact(rows, ks, seed, zipf, heavy_hitters, device)
    else:
        fact = synth_table("f", rows, ks, seed=seed, device=device)
    dimc = synth_table("d", dim_rows, ks, seed=seed + 1, unique_keys=True,
                       device=device)
    dim = Table({**dimc.columns,
                 "cat": torch.arange(dim_rows, dtype=torch.int32,
                                     device=dimc["key"].device) % num_groups})
    ref = reference_query_numpy(fact, dim, num_groups=num_groups)
    fact_nodes = range(fact_nodes) if isinstance(fact_nodes, int) \
        else fact_nodes
    dim_nodes = range(dim_nodes) if isinstance(dim_nodes, int) else dim_nodes
    return (distribute(fact, fact_nodes, "A"),
            distribute(dim, dim_nodes, "B"), ref)


def zipf_weights(key_space: int, s: float) -> np.ndarray:
    """Normalized Zipf(s) mass over keys ``0..key_space-1`` (key ``r`` gets
    mass ``(r+1)^-s``)."""
    w = np.arange(1, int(key_space) + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def _synth_skewed_fact(rows: int, key_space: int, seed: int,
                       zipf: float, heavy_hitters: int, device=None) -> Table:
    """Skewed twin of ``synth_table('f', ...)`` — same column recipe
    (int32 ``key``, float32 ``v0``/``v1``), different key law."""
    rng = np.random.default_rng(seed)
    if zipf:
        keys = rng.choice(int(key_space), size=rows,
                          p=zipf_weights(key_space, zipf))
    else:
        keys = rng.integers(0, key_space, size=rows)
    if heavy_hitters:
        h = int(heavy_hitters)
        hot = rng.permutation(int(key_space))[:h]
        mask = rng.random(rows) < 0.5
        keys = np.where(mask, hot[rng.integers(0, h, size=rows)], keys)
    cols = {"key": keys.astype(np.int32)}
    for i in range(2):
        cols[f"v{i}"] = rng.standard_normal(rows, dtype=np.float32)
    return from_numpy(cols, device)


@dataclass
class QueryStrategy:
    """S-M = static merge, S-H = static hash, DYN = decision workflow.

    "dynamic" is the refined cost-model decision node (paper Fig. 5 step 4);
    "dynamic_fig6" is the literal T1/T2 threshold node of Fig. 6.
    """

    name: str   # static_merge | static_hash | dynamic | dynamic_fig6

    def join_method(self, ctx: DecisionContext) -> Decision:
        if self.name == "dynamic":
            from repro_torch.analytics.decisions import cost_model_join_node
            return cost_model_join_node().decide(ctx)
        if self.name == "dynamic_fig6":
            from repro_torch.analytics.decisions import join_decision
            return join_decision(ctx)
        func = "merge_join" if self.name == "static_merge" else "hash_join"
        dist_a, dist_b = ctx.data_dist["A"], ctx.data_dist["B"]
        nodes = tuple(sorted(dist_a.loc | dist_b.loc))
        scale = max(1, int((dist_a.size + dist_b.size) / ALPHA))
        return Decision(func, scale, Schedule("round-robin", nodes))


def resolve_join_decision(strategy: QueryStrategy, ctx: DecisionContext,
                          consolidate_threshold: int = 2 << 30,
                          ) -> tuple[Decision, bool]:
    """Compatibility shim: run the strategy's join choice once, up front."""
    from repro_torch.analytics.planner import consolidation_applies

    decision = strategy.join_method(ctx)
    total_bytes = sum(d.size for d in ctx.data_dist.values())
    return decision, consolidation_applies(
        strategy.name, decision, total_bytes, consolidate_threshold)


def plan_query_tasks(sim: ClusterSim, pc: PrivateController,
                     fact: DistTable, dim: DistTable,
                     strategy: QueryStrategy, app: str = "query",
                     consolidate_threshold: int | None = None,
                     workflow: DecisionWorkflow | None = None,
                     device=None) -> None:
    """Emit the task DAG for the sub-query — thin wrapper over the
    workflow-driven planner (``plan_query_with_workflow``); ``device`` is
    where its skew feedback and rate calibration run (the card unless
    ``"cpu"`` is passed)."""
    plan_query_with_workflow(
        sim, pc, fact, dim, strategy, app=app, workflow=workflow,
        consolidate_threshold=consolidate_threshold, device=device)


# -- runtime execution: decisions -> real partitioned invocations ----------------


def plan_runtime_stages(app: str, fact_layout: Sequence[tuple[int, int]],
                        dim_layout: Sequence[tuple[int, int]],
                        decision: Decision, dist_f: DataDist,
                        consolidated: bool = False, num_groups: int = 64,
                        priority: int = 0) -> list:
    """Compatibility shim: materialize a single up-front join decision into
    the full physical stage list (scans + exchange + join + aggregation)."""
    return scan_stages(app, fact_layout, dim_layout, priority) + tail_stages(
        app, fact_layout, dim_layout, decision, dist_f,
        consolidated=consolidated, num_groups=num_groups, priority=priority)


def split_partitions(partitions, split: int) -> list:
    """Split each home node's partition into ``split`` row-range slices —
    the fine-grained ``[(node, table), ...]`` layout. Slices are
    ``TableSlice`` views: no copies until a scan reads them. The per-node
    byte totals are unchanged."""
    out = []
    for node, t in sorted(partitions.items()):
        k = max(1, min(int(split), t.num_rows or 1))
        bounds = np.linspace(0, t.num_rows, k + 1).astype(int)
        out.extend((node, t.slice(lo, hi))
                   for lo, hi in zip(bounds[:-1], bounds[1:]))
    return out


def prepare_query_plan(runtime, fact: DistTable, dim: DistTable,
                       strategy: QueryStrategy, app: str = "query",
                       priority: int = 10, num_groups: int = 64,
                       pc: PrivateController | None = None,
                       consolidate_threshold: int | None = None,
                       workflow: DecisionWorkflow | None = None,
                       map_split: int = 1, seed_tier: str | None = None,
                       reuse_inputs: bool = False,
                       ) -> tuple[AdaptiveQueryPlan, PrivateController]:
    """Planner entry point for a *named* application on a shared runtime:
    observes the input distributions, opens the query's late-bound
    ``WorkflowRun``, seeds the inputs into the shared store under ``app``'s
    namespace, and returns the ``AdaptiveQueryPlan`` (plus the private
    controller) ready for ``runtime.execute``."""
    if pc is None:
        pc = PrivateController(app, runtime.gc, priority=priority)

    dist_f, dist_d = fact.data_dist(), dim.data_dist()
    pc.observe_data(dist_f)
    pc.observe_data(dist_d)
    wf = _resolve_workflow(workflow, strategy, consolidate_threshold)
    ctx = DecisionContext(
        data_dist={"A": dist_f, "B": dist_d},
        node_status=runtime.gc.node_status(), profile=dict(pc.profile))
    run = wf.start(ctx)
    run.app = app

    fact_parts = fact.partitions if map_split <= 1 \
        else split_partitions(fact.partitions, map_split)
    dim_parts = dim.partitions if map_split <= 1 \
        else split_partitions(dim.partitions, map_split)
    if reuse_inputs and runtime.store.stage_layout(app, "input/fact"):
        fact_layout = runtime.store.stage_layout(app, "input/fact")
        dim_layout = runtime.store.stage_layout(app, "input/dim")
    else:
        fact_layout = runtime.seed(app, "input/fact", fact_parts,
                                   tier=seed_tier)
        dim_layout = runtime.seed(app, "input/dim", dim_parts,
                                  tier=seed_tier)
    plan = AdaptiveQueryPlan(run, app, fact_layout, dim_layout,
                             num_groups=num_groups, priority=pc.priority)
    return plan, pc


def execute_query_runtime(fact: DistTable, dim: DistTable,
                          strategy: QueryStrategy, runtime=None,
                          gc: GlobalController | None = None,
                          pc: PrivateController | None = None,
                          app: str = "query", priority: int = 10,
                          num_groups: int = 64, invoker: str = "inline",
                          consolidate_threshold: int | None = None,
                          workflow: DecisionWorkflow | None = None,
                          barrier: bool = False, recovery="lineage",
                          max_recoveries: int = 8, batching: bool = True,
                          map_split: int = 1, pipeline: bool = False,
                          seed_tier: str | None = None,
                          reuse_inputs: bool = False, device=None):
    """Run the TPC-DS-like sub-query end-to-end on the serverless runtime.

    One decision workflow drives the whole query: the scan decision binds
    up front, the executor launches the scan stages, and when they complete
    the planner folds the observed post-filter distribution plus stage
    metrics back into the context and binds the join/exchange/aggregate
    decisions. ``pipeline=True`` lets the executor honor the bound
    ``pipeline`` decision (partition-granularity launch + prefetch + fused
    probe). ``device`` picks where a runtime built here computes: the card
    unless ``"cpu"`` is passed (a given ``runtime`` brings its own).
    Returns ``(group_sums, runtime)``.
    """
    from repro_torch.runtime.executor import Runtime

    if runtime is None:
        if gc is None:
            nodes = sorted(set(fact.partitions) | set(dim.partitions))
            gc = GlobalController({n: 8 for n in nodes})
        runtime = Runtime(gc, invoker=invoker, batching=batching,
                          device=device)
    plan, pc = prepare_query_plan(
        runtime, fact, dim, strategy, app=app, priority=priority,
        num_groups=num_groups, pc=pc,
        consolidate_threshold=consolidate_threshold, workflow=workflow,
        map_split=map_split, seed_tier=seed_tier, reuse_inputs=reuse_inputs)
    runtime.execute(plan.initial_stages(), pc=pc, planner=plan,
                    barrier=barrier, recovery=recovery,
                    max_recoveries=max_recoveries, pipeline=pipeline)
    return runtime.result(app), runtime


# -- in-process execution (correctness path) --------------------------------------


def execute_query_torch(fact: Table, dim: Table, method: str = "hash",
                        num_groups: int = 64) -> torch.Tensor:
    """Run the logical query on the tensor data plane; per-group sums."""
    keep = fact["v0"] > 0
    filtered = ops.filter_table(fact, keep)
    joined = ops.join(filtered, dim, method=method)
    weights = torch.where(joined["found"] & (joined["valid"] != 0),
                          joined["v0"] * joined["v1"], 0.0)
    group = joined["cat"].to(torch.int32) % num_groups
    return ops.groupby_sum(group, weights, num_groups)


def reference_query_numpy(fact: Table, dim: Table,
                          num_groups: int = 64) -> np.ndarray:
    """Pure-numpy oracle for tests (one Python step per fact row)."""
    fk = to_numpy(fact["key"])
    v0 = to_numpy(fact["v0"]).astype(np.float64)
    v1 = to_numpy(fact["v1"]).astype(np.float64)
    dk = to_numpy(dim["key"])
    cat = to_numpy(dim["cat"])
    lookup = {int(k): int(c) for k, c in zip(dk, cat)}
    out = np.zeros(num_groups)
    for k, a, b in zip(fk, v0, v1):
        if a > 0 and int(k) in lookup:
            out[lookup[int(k)] % num_groups] += a * b
    return out
