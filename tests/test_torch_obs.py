"""The critical-path analyser and the Chrome-trace export of the PyTorch port
against the JAX reference's.

The synthetic span DAGs of ``tests/test_obs.py`` and the spans of real
queries run by the port's runtime on the CPU go through both packages'
analysers; the paths, their per-step splits and the phase totals must be
equal (the same float arithmetic in the same order), and so must the
Chrome-trace dicts, which must also survive a JSON round trip.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.analytics.query import (
    QueryStrategy,
    execute_query_runtime,
    synth_query_tables,
)
from repro_torch.core.controllers import GlobalController
from repro_torch.runtime import QueryJob, QueryScheduler, Runtime


@pytest.fixture(autouse=True)
def fresh_obs():
    tobs.get_tracer().clear()
    tobs.get_audit_log().clear()
    yield
    tobs.get_tracer().clear()
    tobs.get_audit_log().clear()


def _as_reference(spans):
    return [jobs.Span(**dataclasses.asdict(s)) for s in spans]


def _both_paths(spans, app):
    """(port's, reference's) critical path of the same spans."""
    return (tobs.critical_path(spans, app=app),
            jobs.critical_path(_as_reference(spans), app=app))


def _same_path(spans, app):
    got, want = _both_paths(spans, app)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.to_dict() == want.to_dict()
        assert got.breakdown == want.breakdown
        assert [dataclasses.astuple(s) for s in got.steps] == \
            [dataclasses.astuple(s) for s in want.steps]
        assert got.format() == want.format()
    return got


# -- synthetic span DAGs (tests/test_obs.py's) -------------------------------------


def _stage(sid, name, deps, t0, t1):
    return tobs.Span(sid, "app", f"stage/{name}", "executor", t0, end=t1,
                     attrs={"stage": name, "deps": list(deps)})


def _inv(sid, stage, t0, t1, node=0, name=None, parent=None, kind=None):
    return tobs.Span(sid, "app", name or f"app/{stage}/0", "invoker", t0,
                     end=t1, node=node, parent_id=parent,
                     attrs={"kind": kind or "invocation", "stage": stage})


def _span(sid, name, cat, t0, t1, parent):
    return tobs.Span(sid, "app", name, cat, t0, end=t1, parent_id=parent)


SYNTHETIC = {
    # A (0-10) -> B (12-20), a non-bounding sibling A/1 finishing earlier,
    # a 3 s store read inside B
    "two_stages": ([
        _stage(1, "A", (), 0.0, 10.0), _stage(2, "B", ("A",), 10.0, 20.0),
        _inv(3, "A", 0.0, 10.0),
        _inv(4, "A", 0.0, 4.0, node=1, name="app/A/1"),
        _inv(5, "B", 12.0, 20.0, node=1),
        _span(6, "get/A", "store", 13.0, 16.0, 5)],
        {"stages": ["A", "B"], "makespan": 20.0, "dominant": "compute",
         "breakdown": {"compute": 15.0, "store": 3.0, "slot_wait": 0.0,
                       "queue": 2.0}}),
    "slot_wait": ([
        _stage(1, "A", (), 0.0, 30.0), _inv(2, "A", 0.0, 30.0),
        _span(3, "slot_wait", "wait", 1.0, 25.0, 2)],
        {"stages": ["A"], "makespan": 30.0, "dominant": "slot_wait",
         "breakdown": {"compute": 6.0, "store": 0.0, "slot_wait": 24.0,
                       "queue": 0.0}}),
    # a batch span owns the claim wait, its member the store time
    "batch_wait": ([
        _stage(1, "A", (), 0.0, 20.0),
        _inv(2, "A", 0.0, 20.0, name="batch/A@0", kind="batch"),
        _span(3, "slot_wait", "wait", 0.0, 2.0, 2),
        _inv(4, "A", 2.0, 20.0, parent=2),
        _span(5, "put/out", "store", 5.0, 17.0, 4)],
        {"stages": ["A"], "makespan": 20.0, "dominant": "store",
         "breakdown": {"compute": 4.0, "store": 12.0, "slot_wait": 2.0,
                       "queue": 2.0}}),
    # pipelined: B starts before either producer ends
    "overlap": ([
        _stage(1, "A", (), 0.0, 12.0), _stage(2, "B", ("A",), 4.0, 14.0),
        _inv(3, "A", 0.0, 10.0),
        _inv(4, "A", 0.0, 12.0, node=1, name="app/A/1"),
        _inv(5, "B", 4.0, 14.0, node=1),
        _span(6, "get/A", "store", 5.0, 10.0, 5)],
        {"stages": ["A", "B"], "makespan": 14.0, "dominant": "compute",
         "breakdown": {"compute": 12.0, "store": 2.0, "slot_wait": 0.0,
                       "queue": 0.0}}),
}


@pytest.mark.parametrize("case", list(SYNTHETIC))
def test_critical_path_on_synthetic_dags_matches_reference(case):
    spans, want = SYNTHETIC[case]
    cp = _same_path(spans, "app")
    assert [s.stage for s in cp.steps] == want["stages"]
    assert cp.makespan == pytest.approx(want["makespan"])
    assert cp.dominant == want["dominant"]
    for phase, seconds in want["breakdown"].items():
        assert cp.breakdown[phase] == pytest.approx(seconds), phase


def test_critical_path_none_without_invocations():
    for spans in ([], [_stage(1, "A", (), 0.0, 1.0)]):
        assert _both_paths(spans, "app") == (None, None)


# -- real queries on the port's runtime ------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("strategy,pipeline", [("static_merge", True),
                                               ("dynamic", False)])
def test_critical_path_of_a_query_matches_reference(strategy, pipeline,
                                                    seed):
    """The port's query leaves a span DAG whose critical path, per-step
    split and store, slot-wait, compute and queue totals both analysers
    give alike; the totals sum to the makespan."""
    fd, dd, ref = synth_query_tables(4096, 512, keyspace=2048, seed=seed,
                                     device="cpu")
    got, _ = execute_query_runtime(fd, dd, QueryStrategy(strategy),
                                   invoker="threads", pipeline=pipeline,
                                   device="cpu")
    np.testing.assert_allclose(got, ref, atol=1e-3)
    spans = tobs.get_tracer().spans()
    cp = _same_path(spans, "query")
    assert cp is not None and len(cp.steps) >= 2
    assert sum(cp.breakdown.values()) == pytest.approx(cp.makespan)


def test_chrome_trace_of_a_scheduled_query_matches_reference(tmp_path):
    """The Chrome-trace dict of a query run through the scheduler equals the
    reference export's of the same buffer, survives a JSON round trip, and
    ``write_bench_artifacts`` writes it beside the critical path."""
    fd, dd, ref = synth_query_tables(2048, 256, keyspace=2048, seed=5,
                                     fact_nodes=2, dim_nodes=1, device="cpu")
    gc = GlobalController({0: 4, 1: 4})
    rt = Runtime(gc, invoker="threads", device="cpu")
    sched = QueryScheduler(rt, policy="fair_share")
    sched.submit(QueryJob("obs_q", fd, dd, "static_hash", priority=3))
    res = sched.run()["obs_q"]
    assert res.ok, res.error
    np.testing.assert_allclose(res.sums, ref, atol=1e-3)

    tracer = tobs.get_tracer()
    for app in ("obs_q", None):
        trace = tobs.to_chrome_trace(tracer, app=app)
        assert trace == jobs.to_chrome_trace(tracer, app=app)
        again = json.loads(json.dumps(trace))
        assert again == trace
        info = tobs.validate_chrome_trace(json.dumps(trace))
        assert info == jobs.validate_chrome_trace(again)
    assert info["events"] > 0
    assert {"scheduler", "executor", "invoker", "store"} <= set(info["cats"])
    assert "store_bytes/obs_q" in info["counter_tracks"]
    assert any(t.startswith("slots/node") for t in info["counter_tracks"])
    assert 1 in info["pids"] and any(p >= 10 for p in info["pids"])

    out = tobs.write_bench_artifacts(tmp_path / "BENCH_obs.json",
                                     apps=("obs_q",))
    assert out["trace"] == str(tmp_path / "TRACE_obs.json")
    with open(out["trace"]) as f:
        assert json.load(f) == tobs.to_chrome_trace(tracer)
    assert out["critical_path"]["obs_q"] == jobs.critical_path(
        _as_reference(tracer.spans()), app="obs_q").to_dict()


@pytest.mark.parametrize("bad", [
    {"no": "traceEvents"},
    {"traceEvents": [{"ph": "X", "pid": 1, "ts": -1, "dur": 1, "name": "x",
                      "tid": 0}]},
    {"traceEvents": [{"ph": "C", "pid": 1, "ts": 0, "name": "c",
                      "args": {}}]},
    {"traceEvents": [{"name": "no phase", "pid": 1}]}])
def test_validate_chrome_trace_rejects_malformed_as_reference(bad):
    for validate in (tobs.validate_chrome_trace, jobs.validate_chrome_trace):
        with pytest.raises(ValueError):
            validate(bad)
