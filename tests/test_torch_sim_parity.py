"""One workflow, two data planes, two packages.

The port's simulator plane (``plan_query_with_workflow`` over a
``ClusterSim``) and its runtime plane (``execute_query_runtime`` on the
CPU) walk one ``DecisionWorkflow`` and must bind the same decision
sequence; both must equal the reference's simulator plane on the same
seeded tables. Twins of ``test_adaptive_planner.py`` (the shared
sequences, the scan estimate), ``test_runtime.py`` (trace replay),
``test_faults.py`` (seeded fault plans), ``test_skew.py`` (the skew
decision, the exact histogram) and ``test_tiering.py`` (the tiering
decision). Decisions are compared for equality; group sums are held to
the numpy oracle at the reference's own tolerance, 1e-3. Operator rates
are pinned in both packages (``RATES``), as each would otherwise time its
own operators for the ``dynamic`` join node and the simulated durations.
"""

import numpy as np
import pytest

import repro.analytics.planner as jplan
import repro.analytics.query as jq
import repro.analytics.simulator as jsim
import repro.core.controllers as jctl
import repro.core.decisions as jdec
import repro.runtime as jrt
import repro_torch.analytics.planner as tplan
import repro_torch.analytics.query as tq
import repro_torch.analytics.simulator as tsim
import repro_torch.core.controllers as tctl
import repro_torch.core.decisions as tdec
import repro_torch.obs.audit as taudit
import repro_torch.runtime as trt
from repro_torch.runtime.lineage import expected_recovery

ATOL = 1e-3      # the reference's own runtime tolerance
RATES = {"scan": 2e9, "sort": 4e8, "hash_build": 3e8, "hash_probe": 6e8,
         "merge_join": 5e8, "agg": 1e9}
EIGHT_NODES = ["scan", "join", "exchange", "skew", "aggregate", "pipeline",
               "elastic", "tiering"]

JAX = dict(q=jq, plan=jplan, sim=jsim, ctl=jctl, dec=jdec, rt=jrt, dev={})
TORCH = dict(q=tq, plan=tplan, sim=tsim, ctl=tctl, dec=tdec, rt=trt,
             dev={"device": "cpu"})


@pytest.fixture(autouse=True)
def pinned_rates(monkeypatch):
    monkeypatch.setattr(jsim, "_RATE_CACHE", dict(RATES))
    monkeypatch.setattr(tsim, "_RATE_CACHE", dict(RATES))


def _tables(pkg, **kw):
    kw = {"rows": 4096, "dim_rows": 512, "seed": 1, **kw, **pkg["dev"]}
    return pkg["q"].synth_query_tables(**kw)


def _fanout(pkg, name, fanout):
    base = pkg["q"].QueryStrategy

    class Fanout(base):
        """Pins the join fan-out: small tables otherwise bind scale=1,
        which the skew guard treats as unsplittable."""

        def join_method(self, ctx):
            d = super().join_method(ctx)
            return pkg["dec"].Decision(d.func, fanout, d.schedule,
                                       extras=d.extras)

    return Fanout(name)


def _seq(sequence) -> list:
    """A decision sequence as plain data, comparable across packages."""
    return [(s, d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes),
             tuple(d.extras)) for s, d in sequence]


def _sim_plane(pkg, fd, dd, strategy, wf, sim=None, **kw):
    """Plan the query into a 4-node cluster through ``wf``; returns the
    bound sequence and the simulated completion."""
    if sim is None:
        gc_sim, sim = pkg["sim"].make_cluster(4)
    pc = pkg["ctl"].PrivateController("query", sim.gc, priority=10)
    pkg["plan"].plan_query_with_workflow(sim, pc, fd, dd, strategy,
                                         workflow=wf, **pkg["dev"], **kw)
    seq = list(wf.last_run.sequence)
    return seq, sim.run()["completion"]


def _reference_sim_sequence(tables_kw, strategy, sim_kw=None, **wf_kw):
    """The reference's simulator plane on the same seeded tables."""
    fd, dd, _ = _tables(JAX, **tables_kw)
    strat = strategy(JAX)
    wf = jplan.build_query_workflow(strat, **wf_kw)
    sim = jsim.ClusterSim(jctl.GlobalController({n: 8 for n in range(4)}),
                          **(sim_kw or {}))
    seq, completion = _sim_plane(JAX, fd, dd, strat, wf, sim=sim)
    return _seq(seq), completion


# -- test_adaptive_planner.py: one workflow, identical sequences ------------------


def test_planes_share_identical_decision_sequences():
    audit = taudit.get_audit_log()
    audit.clear()
    fd, dd, ref = _tables(TORCH)
    wf = tplan.build_query_workflow(tq.QueryStrategy("dynamic_fig6"))

    got, _ = tq.execute_query_runtime(
        fd, dd, tq.QueryStrategy("dynamic_fig6"),
        gc=tctl.GlobalController({n: 8 for n in range(4)}), workflow=wf,
        device="cpu")
    np.testing.assert_allclose(got, ref, atol=ATOL)
    seq_runtime = list(wf.last_run.sequence)
    nodes = [s for s, _ in seq_runtime]
    funcs = [(s, d.func) for s, d in seq_runtime]
    assert audit.sequence("query", nodes=nodes) == funcs

    seq_sim, completion = _sim_plane(TORCH, fd, dd,
                                     tq.QueryStrategy("dynamic_fig6"), wf)
    assert completion["query"] > 0
    assert seq_runtime == seq_sim                 # full Decision equality
    assert len(wf.stages["join"].node.history) == 2
    assert audit.sequence("query", nodes=nodes) == \
        funcs + [(s, d.func) for s, d in seq_sim]

    # the reference's simulator plane: same sequence, same makespan
    want_seq, want_completion = _reference_sim_sequence(
        {}, lambda pkg: pkg["q"].QueryStrategy("dynamic_fig6"))
    assert _seq(seq_sim) == want_seq
    assert completion == want_completion


def test_estimated_scan_output_matches_observed_store_distribution():
    fd, dd, _ = _tables(TORCH, seed=9)
    est = tplan.estimate_scan_output(fd)
    _, runtime = tq.execute_query_runtime(fd, dd,
                                          tq.QueryStrategy("static_hash"),
                                          device="cpu")
    obs = runtime.store.data_dist("query", "scan_fact", name="A_scanned")
    assert dict(est.bytes_per_node) == dict(obs.bytes_per_node)
    assert est.rows == obs.rows
    assert est.skew == pytest.approx(obs.skew)
    jfd, _, _ = _tables(JAX, seed=9)
    want = jplan.estimate_scan_output(jfd)
    assert (dict(est.bytes_per_node), est.rows, est.skew) == \
        (dict(want.bytes_per_node), want.rows, want.skew)


# -- test_runtime.py: trace replay -------------------------------------------------


def _replayed(pkg):
    fd, dd, _ = _tables(pkg)
    _, runtime = pkg["q"].execute_query_runtime(
        fd, dd, pkg["q"].QueryStrategy("static_merge"), **pkg["dev"])
    ok = [r for r in runtime.metrics.records if r.status == "ok"]
    gc, sim = pkg["sim"].make_cluster(4)
    n = runtime.replay_into(sim)
    assert n == len(ok)
    plan = {name: (t.app, t.node, t.priority, t.deps, dict(t.transfers))
            for name, t in sim.tasks.items()}
    return sim, plan


def test_invocation_trace_replays_into_simulator():
    sim, plan = _replayed(TORCH)
    out = sim.run()
    assert len(sim.done) == len(plan)
    assert out["completion"]["query"] > 0
    # replay preserves the DAG: the final aggregate finishes last
    assert sim.tasks["query/final_agg/0"].finished == \
        max(t.finished for t in sim.tasks.values())
    # names, placements, dependency edges and transfer volumes are the
    # reference's (durations are each runtime's own measured seconds)
    _, want = _replayed(JAX)
    assert plan == want


# -- test_faults.py: a seeded fault plan on both planes ----------------------------


@pytest.mark.parametrize("seed", (3, 11))
def test_seeded_plan_sim_and_runtime_parity(seed):
    fd, dd, ref = _tables(TORCH)
    plan = trt.FaultPlan.seeded(seed, stages=("scan_fact", "join"),
                                data_stages=("joined",), nodes=(0, 1),
                                delay=0.01)
    wf = tplan.build_query_workflow(tq.QueryStrategy("dynamic_fig6"))

    rt = trt.Runtime(tctl.GlobalController({n: 8 for n in range(4)}),
                     device="cpu")
    trt.FaultInjector(plan).install(rt)
    got, _ = tq.execute_query_runtime(fd, dd,
                                      tq.QueryStrategy("dynamic_fig6"),
                                      runtime=rt, workflow=wf)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    seq_rt = list(wf.last_run.sequence)
    recovered_rt = [ev.recovered for ev in rt.recoveries
                    if ev.lost_stage == "joined"]

    straggle, crash = tsim.sim_fault_models(plan)
    _, sim = tsim.make_cluster(4, straggle=straggle, crash_plan=crash)
    seq_sim, completion = _sim_plane(TORCH, fd, dd,
                                     tq.QueryStrategy("dynamic_fig6"), wf,
                                     sim=sim)
    assert completion["query"] > 0
    assert sim.reexecutions == sum(crash.values())
    assert seq_rt == seq_sim

    fl = [(i, n) for i, (n, _) in enumerate(sorted(fd.partitions.items()))]
    dl = [(j, n) for j, (n, _) in enumerate(sorted(dd.partitions.items()))]
    stages = tplan.stages_for_run(wf.last_run, "query", fl, dl)
    predicted = tuple(expected_recovery(stages, "joined"))
    for actual in recovered_rt:
        assert actual == predicted

    # the reference's simulator plane under the same seeded plan
    jplan_ = jrt.FaultPlan.seeded(seed, stages=("scan_fact", "join"),
                                  data_stages=("joined",), nodes=(0, 1),
                                  delay=0.01)
    jstraggle, jcrash = jsim.sim_fault_models(jplan_)
    assert (straggle, crash) == (jstraggle, jcrash)
    want_seq, want_completion = _reference_sim_sequence(
        {}, lambda pkg: pkg["q"].QueryStrategy("dynamic_fig6"),
        sim_kw=dict(straggle=jstraggle, crash_plan=jcrash))
    assert _seq(seq_sim) == want_seq
    assert completion == want_completion


# -- test_skew.py: the skew decision and its exact histogram -----------------------


@pytest.mark.parametrize("force", [None, "salted"])
def test_skew_decision_parity_across_planes(force):
    tables_kw = dict(rows=4096, dim_rows=512, zipf=1.5, seed=3)
    fd, dd, ref = _tables(TORCH, **tables_kw)
    strategy = _fanout(TORCH, "dynamic", 8)
    wf = tplan.build_query_workflow(strategy, skew_force=force)
    got, _ = tq.execute_query_runtime(
        fd, dd, strategy, workflow=wf, device="cpu",
        gc=tctl.GlobalController({n: 8 for n in range(4)}))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    seq_rt = list(wf.last_run.sequence)

    sim = tsim.ClusterSim(tctl.GlobalController({n: 8 for n in range(4)}))
    seq_sim, _ = _sim_plane(TORCH, fd, dd, strategy, wf, sim=sim)
    assert [s for s, _ in seq_rt] == EIGHT_NODES
    assert seq_rt == seq_sim        # heavy buckets / salt / hot keys too

    want_seq, _ = _reference_sim_sequence(
        tables_kw, lambda pkg: _fanout(pkg, "dynamic", 8), skew_force=force)
    assert _seq(seq_sim) == want_seq


def test_sim_feedback_recomputes_runtime_histogram():
    tables_kw = dict(rows=1 << 14, dim_rows=1024, zipf=1.5, seed=3)
    fd, dd, ref = _tables(TORCH, **tables_kw)
    rows, nbytes, hot = tplan.shuffle_skew_feedback(fd, 8, device="cpu")
    strategy = _fanout(TORCH, "static_merge", 8)
    wf = tplan.build_query_workflow(strategy)
    got, _ = tq.execute_query_runtime(
        fd, dd, strategy, workflow=wf, device="cpu",
        gc=tctl.GlobalController({n: 8 for n in range(4)}))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    profile = wf.last_run.ctx.profile
    assert profile["skew.partition_rows"] == rows
    assert profile["skew.partition_bytes"] == nbytes
    assert profile["skew.hot_keys"] == hot
    assert sum(rows) > 0 and hot
    jfd, _, _ = _tables(JAX, **tables_kw)
    assert (rows, nbytes, hot) == jplan.shuffle_skew_feedback(jfd, 8)


# -- test_tiering.py: the tiering decision with tiers and a quota ------------------


def test_tiering_decision_parity_across_planes():
    fd, dd, ref = _tables(TORCH)
    _, rt0 = tq.execute_query_runtime(fd, dd, tq.QueryStrategy("dynamic"),
                                      device="cpu")
    quota = rt0.store.peak_bytes["query"]
    wf = tplan.build_query_workflow(tq.QueryStrategy("dynamic"))
    rt = trt.Runtime(
        tctl.GlobalController({n: 8 for n in range(4)}), device="cpu",
        spill_backends=[trt.DiskBackend(), trt.ObjectStoreBackend(
            latency_s=0.0, bw=None, cost_per_request=0.0, cost_per_gb=0.0)])
    rt.store.set_quota("query", quota)
    try:
        got, _ = tq.execute_query_runtime(fd, dd, tq.QueryStrategy("dynamic"),
                                          runtime=rt, workflow=wf)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        spec = rt.store.storage_spec()
        seq_rt = list(wf.last_run.sequence)
    finally:
        rt.store.close()

    sim = tsim.ClusterSim(tctl.GlobalController({n: 8 for n in range(4)}),
                          storage_spec=spec, store_quotas={"query": quota})
    seq_sim, _ = _sim_plane(TORCH, fd, dd, tq.QueryStrategy("dynamic"), wf,
                            sim=sim)
    assert [s for s, _ in seq_rt] == EIGHT_NODES
    assert seq_rt == seq_sim           # per-stage spill plans included
    assert dict((s, d.func) for s, d in seq_rt)["tiering"] == "spill"

    want_seq, _ = _reference_sim_sequence(
        {}, lambda pkg: pkg["q"].QueryStrategy("dynamic"),
        sim_kw=dict(storage_spec=spec, store_quotas={"query": quota}))
    assert _seq(seq_sim) == want_seq
