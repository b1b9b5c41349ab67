"""Control plane of the PyTorch port against the JAX reference: equal
``DecisionContext``s bind equal decisions, controllers commit and preempt
alike. Plus the port's guards: it imports neither JAX nor the reference,
and its entry points refuse to drop to the CPU unasked."""

import ast
from pathlib import Path

import pytest
import torch

import repro.analytics.decisions as jad
import repro.analytics.planner as jplan
import repro.core.controllers as jctl
import repro.core.decisions as jdec
import repro.obs.audit as jaudit
import repro_torch.analytics.decisions as tad
import repro_torch.analytics.planner as tplan
import repro_torch.core.controllers as tctl
import repro_torch.core.decisions as tdec
import repro_torch.obs.audit as taudit

ROOT = Path(__file__).resolve().parents[1]
RATES = {"scan": 2e9, "sort": 4e8, "hash_build": 3e8, "hash_probe": 6e8,
         "merge_join": 5e8, "agg": 1e9}


def _ctx(pkg, scenario, decisions=None):
    dists = {name: pkg.DataDist(name, dict(per), rows=rows, skew=skew)
             for name, (per, rows, skew) in scenario["dists"].items()}
    total = scenario["slots"]
    status = pkg.NodeStatus(total_slots=dict(total),
                            free_slots=dict(scenario.get("free", total)))
    return pkg.DecisionContext(
        data_dist=dists, node_status=status, app=dict(scenario.get("app", {})),
        profile=dict(scenario.get("profile", {})),
        decisions=dict(decisions or {}))


def _tuple(d):
    return (d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes),
            d.schedule.slots_per_node, tuple(d.extras))


SCENARIOS = {
    "small_even": dict(
        dists={"A": ({0: 6 << 20, 1: 6 << 20, 2: 6 << 20, 3: 6 << 20},
                     2 << 20, 1.0),
               "B": ({0: 1 << 20, 1: 1 << 20}, 1 << 17, 1.0)},
        slots={n: 8 for n in range(4)}),
    "big_many_nodes": dict(
        dists={"A": ({n: 400 << 20 for n in range(12)}, 400 << 20, 1.0),
               "B": ({n: 100 << 20 for n in range(12)}, 100 << 20, 1.0)},
        slots={n: 8 for n in range(12)},
        free={n: (n % 3) * 3 for n in range(12)}),
    "skewed": dict(
        dists={"A": ({0: 900 << 20, 1: 10 << 20, 2: 5 << 20}, 1 << 26, 4.2),
               "B": ({1: 30 << 20}, 1 << 21, 1.0),
               "A_scanned": ({0: 450 << 20, 1: 5 << 20}, 1 << 25, 3.9)},
        slots={n: 4 for n in range(3)}, free={0: 0, 1: 0, 2: 0},
        app={"net_bw": 2.5e9}),
}


def _pairs(scenario):
    """(name, reference node fn, port node fn, needs-join-decision)."""
    return [
        ("fig6_join", jad.join_decision, tad.join_decision, False),
        ("cost_model", jad.cost_model_join_decision,
         tad.cost_model_join_decision, False),
        ("scheduling", jad.scheduling_decision, tad.scheduling_decision,
         False),
        ("scan", jplan.scan_decision, tplan.scan_decision, False),
        ("exchange", jplan.exchange_decision, tplan.exchange_decision, True),
        ("aggregate", jplan.aggregate_decision, tplan.aggregate_decision,
         True),
        ("pipeline", jplan.pipeline_decision, tplan.pipeline_decision, True),
    ]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_equal_contexts_bind_equal_decisions(scenario):
    sc = dict(SCENARIOS[scenario], profile={"rates": RATES})
    for name, jfn, tfn, needs_join in _pairs(sc):
        jj = {"join": jad.join_decision(_ctx(jdec, sc))} if needs_join else {}
        tj = {"join": tad.join_decision(_ctx(tdec, sc))} if needs_join else {}
        assert _tuple(tfn(_ctx(tdec, sc, tj))) == \
            _tuple(jfn(_ctx(jdec, sc, jj))), name


def _node_cases():
    hist_rows = (100, 5000, 90, 80, 7000, 60, 70, 50)
    return [
        ("skew", lambda p: p.skew_node(threshold=2.0, min_rows=64),
         {"skew.partition_rows": hist_rows,
          "skew.partition_bytes": tuple(12 * r for r in hist_rows),
          "skew.hot_keys": ((7, 3000), (3, 900), (11, 40))}),
        ("skew_forced", lambda p: p.skew_node(force="broadcast", min_rows=1),
         {"skew.partition_rows": hist_rows,
          "skew.partition_bytes": tuple(12 * r for r in hist_rows),
          "skew.hot_keys": ((7, 3000), (3, 900))}),
        ("elastic", lambda p: p.elasticity_node(max_workers=16),
         {"elastic.fanout": 12, "elastic.pool": 3}),
        ("tiering", lambda p: p.tiering_node(),
         {"tiering.stages": (("fact_buckets", 1 << 28, 2, 2),
                             ("joined", 1 << 26, 3, 1)),
          "tiering.quota": 1 << 27,
          "tiering.tiers": {"disk": {"tier": "disk", "order": 1,
                                     "read_bw": 2e9, "write_bw": 1e9,
                                     "latency": 0.0001, "get_cost": 0.0,
                                     "put_cost": 0.0, "gb_cost": 0.0}}}),
        ("recovery", lambda p: p.recovery_node(),
         {"recovery.lost_stage": "joined",
          "recovery.reexec_invocations": 3,
          "recovery.total_invocations": 20}),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _node_cases()])
def test_control_nodes_bind_equal_decisions(case):
    _, make, profile = next(c for c in _node_cases() if c[0] == case)
    sc = dict(SCENARIOS["small_even"], profile=profile)
    got = make(tdec).decide(_ctx(tdec, sc))
    want = make(jdec).decide(_ctx(jdec, sc))
    assert _tuple(got) == _tuple(want)


def test_workflow_late_binding_matches_reference():
    from repro.analytics.query import QueryStrategy as JQ
    from repro_torch.analytics.query import QueryStrategy as TQ

    sc = dict(SCENARIOS["small_even"], profile={"rates": RATES})
    seqs = []
    for pkg, plan, strategy in ((jdec, jplan, JQ("dynamic")),
                                (tdec, tplan, TQ("dynamic"))):
        wf = plan.build_query_workflow(strategy)
        run = wf.start(_ctx(pkg, sc))
        run.decide("scan")
        with pytest.raises(pkg.LateBindingError):
            run.decide("join")            # awaits the scan feedback
        run.feedback("scan", {"scan.seconds": 0.5})
        for name in ("join", "exchange"):
            run.decide(name)
        run.feedback("exchange", {})
        seqs.append([(s, _tuple(d)) for s, d in run.sequence])
    assert seqs[0] == seqs[1]


def test_global_controller_commits_and_preempts_alike():
    outcomes = []
    for ctl in (jctl, tctl):
        gc = ctl.GlobalController({0: 2, 1: 1})
        log = []
        low = gc.try_commit("low", 1, [0, 0], tag="a")
        log.append(low is not None)
        log.append(gc.try_commit("low", 1, [0], tag="b") is None)
        high = gc.try_commit("high", 5, [0], tag="c")   # preempts "low"
        log.append(high is not None and not gc.is_active(low))
        log.append(gc.finish(low))
        log.append(gc.finish(high))
        log.append(dict(gc.node_status().free_slots))
        pc = ctl.PrivateController("app", gc, priority=3)
        pc.record_profile(x=1)
        log.append(dict(pc.profile))
        outcomes.append(log)
    assert outcomes[0] == outcomes[1]


def test_audit_log_records_the_same_sequence():
    logs = (taudit.DecisionAuditLog(), jaudit.DecisionAuditLog())
    for log, aud, pkg in zip(logs, (taudit, jaudit), (tdec, jdec)):
        prev = aud.set_audit_log(log)
        try:
            with aud.bound_app("q"):
                pkg.DecisionNode("scan", lambda ctx, p=pkg: p.Decision(
                    "scan_filter", 2, p.Schedule("round-robin", (0, 1)))
                ).decide(_ctx(pkg, SCENARIOS["small_even"]))
        finally:
            aud.set_audit_log(prev)
    assert logs[0].sequence("q") == logs[1].sequence("q") == \
        [("scan", "scan_filter")]


# -- guards -----------------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_entry_points_raise_without_a_card_unless_asked(monkeypatch):
    from repro_torch import NoDeviceError
    from repro_torch.analytics.simulator import calibrated_rates
    from repro_torch.runtime.executor import Runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gc = tctl.GlobalController({0: 2})
    with pytest.raises(NoDeviceError):
        Runtime(gc)
    with pytest.raises(NoDeviceError):
        Runtime(gc, invoker="threads")
    with pytest.raises(NoDeviceError):
        calibrated_rates(force=True)
    assert Runtime(gc, device="cpu").device == torch.device("cpu")


def test_process_invoker_is_refused_not_replaced():
    from repro_torch.runtime.executor import Runtime
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        Runtime(tctl.GlobalController({0: 2}), invoker="process",
                device="cpu")


def test_calibrated_rates_on_the_cpu_when_asked():
    from repro_torch.analytics.simulator import calibrated_rates
    rates = calibrated_rates(sample_rows=1 << 10, force=True, device="cpu")
    assert set(rates) == {"scan", "sort", "hash_build", "hash_probe",
                          "merge_join", "agg"}
    assert all(v > 0 for v in rates.values())
