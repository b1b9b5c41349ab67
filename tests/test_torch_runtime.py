"""The query path of the PyTorch port against the JAX reference, end to end.

The same seeded tables go through ``repro.analytics.query.
execute_query_runtime`` and the port's twin (on the CPU, where the port's
kernel wrappers run their plain versions). Group sums must agree with each
other and with the numpy oracle within the reference's own tolerance
(1e-3); decision sequences, audit sequences, per-stage record counts, store
byte counts and lineage recovery sets must be equal.
"""

import numpy as np
import pytest
import torch

import repro.analytics.planner as jplan
import repro.analytics.query as jq
import repro.core.controllers as jctl
import repro.core.decisions as jdec
import repro.obs.audit as jaudit
import repro.runtime as jrt
import repro_torch.analytics.planner as tplan
import repro_torch.analytics.query as tq
import repro_torch.core.controllers as tctl
import repro_torch.core.decisions as tdec
import repro_torch.obs.audit as taudit
import repro_torch.runtime as trt

ATOL = 1e-3      # the reference's own runtime tolerance
STRATEGIES = ("static_merge", "static_hash", "dynamic", "dynamic_fig6")
RATES = {"scan": 2e9, "sort": 4e8, "hash_build": 3e8, "hash_probe": 6e8,
         "merge_join": 5e8, "agg": 1e9}

JAX = dict(q=jq, plan=jplan, ctl=jctl, dec=jdec, audit=jaudit, rt=jrt)
TORCH = dict(q=tq, plan=tplan, ctl=tctl, dec=tdec, audit=taudit, rt=trt)


def _fanout_strategy(pkg, name, fanout):
    base = pkg["q"].QueryStrategy

    class Fanout(base):
        """Pins the join fan-out: small tables otherwise bind scale=1,
        which the skew guard treats as unsplittable."""

        def join_method(self, ctx):
            d = super().join_method(ctx)
            return pkg["dec"].Decision(d.func, fanout, d.schedule,
                                       extras=d.extras)

    return Fanout(name)


def _run(pkg, app, strategy="static_merge", invoker="inline", fanout=None,
         table_kw=None, fault_seed=None, skew_force=None, **run_kw):
    kw = dict(rows=4096, dim_rows=512, seed=3, fact_nodes=2, dim_nodes=1,
              **(table_kw or {}))
    if pkg is TORCH:
        kw["device"] = "cpu"
    fact, dim, ref = pkg["q"].synth_query_tables(**kw)
    strat = _fanout_strategy(pkg, strategy, fanout) if fanout \
        else pkg["q"].QueryStrategy(strategy)
    gc = pkg["ctl"].GlobalController({n: 8 for n in range(4)})
    rt_kw = dict(invoker=invoker, batching=run_kw.pop("batching", True))
    if pkg is TORCH:
        rt_kw["device"] = "cpu"
    runtime = pkg["rt"].Runtime(gc, **rt_kw)
    if fault_seed is not None:
        plan = pkg["rt"].FaultPlan.seeded(
            fault_seed, stages=("scan_fact", "join"),
            data_stages=("joined",), nodes=(0, 1), delay=0.01)
        pkg["rt"].FaultInjector(plan).install(runtime)
    pc = pkg["ctl"].PrivateController(app, gc, priority=10)
    pc.profile["rates"] = RATES       # both frameworks time other ops
    wf = pkg["plan"].build_query_workflow(strat, skew_force=skew_force)
    got, runtime = pkg["q"].execute_query_runtime(
        fact, dim, strat, runtime=runtime, pc=pc, app=app, workflow=wf,
        **run_kw)
    assert sum(gc.used.values()) == 0
    return got, ref, runtime, wf.last_run


def _stage_counts(runtime, app):
    return {name: (m.invocations, m.ok, m.crashed, m.preempted, m.bytes_in,
                   m.bytes_out, m.rows_actual, m.rows_padded)
            for name, m in runtime.metrics.by_stage(app).items()}


def _sequence(run):
    return [(s, d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes),
             tuple(d.extras)) for s, d in run.sequence]


def _compare(app, deterministic=True, **kw):
    jgot, jref, jrun_t, jrun = _run(JAX, app, **kw)
    tgot, tref, trun_t, trun = _run(TORCH, app, **kw)
    np.testing.assert_array_equal(tref, jref)
    np.testing.assert_allclose(tgot, tref, atol=ATOL)
    np.testing.assert_allclose(tgot, jgot, atol=ATOL)
    if deterministic:
        assert _sequence(trun) == _sequence(jrun)
        assert taudit.get_audit_log().sequence(app) == \
            jaudit.get_audit_log().sequence(app)
        assert _stage_counts(trun_t, app) == _stage_counts(jrun_t, app)
        for attr in ("written_bytes", "read_bytes", "sent_bytes",
                     "cross_node_bytes"):
            assert getattr(trun_t.store, attr) == \
                getattr(jrun_t.store, attr), attr
    else:
        assert [s for s, _ in trun.sequence] == [s for s, _ in jrun.sequence]
    return trun_t, jrun_t, trun, jrun


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("invoker", ["inline", "threads"])
def test_strategies_match_reference_and_oracle(strategy, invoker):
    _compare(f"q_{strategy}_{invoker}", strategy=strategy, invoker=invoker,
             deterministic=invoker == "inline")


@pytest.mark.parametrize("plan", ["barrier", "batched", "pipelined",
                                  "fused"])
def test_plans_match_reference(plan, monkeypatch):
    kw = dict(strategy="static_merge", fanout=4)
    if plan == "barrier":
        kw.update(pipeline=False, barrier=True, batching=False)
    elif plan == "batched":
        kw.update(map_split=2)
    elif plan == "pipelined":
        # buckets this small always fit the fused kernel: lift the gate in
        # both planners so the pipeline node binds "pipelined"
        monkeypatch.setattr(jplan, "FUSED_BUCKET_BYTES", 0)
        monkeypatch.setattr(tplan, "FUSED_BUCKET_BYTES", 0)
        kw.update(pipeline=True)
    else:
        kw.update(pipeline=True)
    trt_, _, trun, _ = _compare(f"plan_{plan}", **kw)
    bound = trun.decisions["pipeline"].func
    assert bound == ("pipelined" if plan == "pipelined" else "fused")
    if plan == "batched":     # two fact nodes, each split in two
        assert trt_.metrics.by_stage(
            f"plan_{plan}")["scan_fact"].invocations == 4


@pytest.mark.parametrize("force,table_kw", [
    ("salted", dict(zipf=1.5)),
    ("broadcast", dict(heavy_hitters=3)),
])
def test_forced_skew_plans_match_reference(force, table_kw):
    app = f"skew_{force}_{sorted(table_kw)[0]}"
    _, _, trun, _ = _compare(app, strategy="static_merge", fanout=4,
                             skew_force=force, table_kw=table_kw,
                             pipeline=True)
    assert trun.decisions["skew"].func == force


def test_seeded_fault_plan_recovers_like_reference():
    trt_, jrt_, _, _ = _compare("faults", strategy="dynamic_fig6",
                                fault_seed=3)
    def events(runtime):
        return [(e.lost_stage, e.partitions, e.recovered, e.invocations)
                for e in runtime.recoveries]

    assert events(trt_) == events(jrt_) and events(trt_)


def test_in_process_query_matches_reference():
    tf, td, ref = tq.synth_query_tables(2048, 256, seed=4, device="cpu")
    jf, jd, _ = jq.synth_query_tables(2048, 256, seed=4)
    for method in ("hash", "merge"):
        got = tq.execute_query_torch(tf.gather(), td.gather(), method=method)
        want = jq.execute_query_jax(jf.gather(), jd.gather(), method=method)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
