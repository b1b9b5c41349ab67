"""The port's multi-query scheduler, twin of ``tests/test_scheduler.py``.

Fair-share gate arithmetic, starvation semantics, the three admission
policies over one shared ``Runtime`` (on the CPU, with the ``threads``
invoker), store quotas and per-query errors, held to the same assertions
as the reference's tests and to the numpy oracle at its tolerance, 1e-3.
The gate's arithmetic and contention, and each policy's results, decisions
and admission order, are also held to the reference's ``FairShareGate``
and ``QueryScheduler`` on the same inputs. The concurrent-mix twin binds each query's workflow on the port's runtime
plane under fair share, then on the port's simulator plane, and holds both
sequences to the reference's simulator plane on the same seeded tables.
Operator rates are pinned in both packages (``RATES``) for the ``dynamic``
strategy.
"""

import random
import threading
import time

import numpy as np
import pytest

import repro.analytics.planner as jplan
import repro.analytics.query as jq
import repro.analytics.simulator as jsim
import repro.core.controllers as jctl
import repro.runtime as jrt
import repro.runtime.invoker as jinv
import repro.runtime.scheduler as jsched
import repro_torch.analytics.simulator as tsim
from repro_torch.analytics import (
    QueryStrategy,
    build_query_workflow,
    make_cluster,
    plan_query_tasks,
    synth_query_tables,
)
from repro_torch.core.controllers import GlobalController, PrivateController
from repro_torch.obs import get_audit_log
from repro_torch.runtime import (
    FairShareGate,
    InlineInvoker,
    Invocation,
    InvocationError,
    MetricsSink,
    QueryJob,
    QueryScheduler,
    Runtime,
    ShuffleStore,
)
from repro_torch.runtime.scheduler import POLICIES, default_weight

ATOL = 1e-3
STRATEGIES = ("static_merge", "static_hash", "dynamic", "dynamic_fig6")
RATES = {"scan": 2e9, "sort": 4e8, "hash_build": 3e8, "hash_probe": 6e8,
         "merge_join": 5e8, "agg": 1e9}


@pytest.fixture(autouse=True)
def pinned_rates(monkeypatch):
    monkeypatch.setattr(jsim, "_RATE_CACHE", dict(RATES))
    monkeypatch.setattr(tsim, "_RATE_CACHE", dict(RATES))


def make_query(seed, rows=2048, dim_rows=256, reference=False):
    """The seeded fact/dim pair and oracle sums, in the port (on the CPU)
    or, with ``reference``, in the JAX package."""
    if reference:
        return jq.synth_query_tables(rows, dim_rows, keyspace=1024,
                                     seed=seed, fact_nodes=4, dim_nodes=2)
    return synth_query_tables(rows, dim_rows, keyspace=1024, seed=seed,
                              fact_nodes=4, dim_nodes=2, device="cpu")


def _runtime(gc, **kw):
    return Runtime(gc, invoker="threads", max_workers=8, device="cpu", **kw)


# -- starvation semantics ------------------------------------------------------------


def test_starved_invocation_succeeds_once_slot_frees():
    gc = GlobalController({0: 1})
    hog = gc.commit("hog", priority=5, placement=[0])
    metrics = MetricsSink()
    invoker = InlineInvoker(gc, ShuffleStore(), metrics, max_attempts=5,
                            starve_wait=0.0, device="cpu")
    invoker.registry = {"noop": lambda ctx: None}
    inv = Invocation("lo/s/0", "lo", "s", 0, "noop", node=0, priority=0)

    done = []
    t = threading.Thread(
        target=lambda: (invoker.run_stage([inv]), done.append(True)))
    t.start()
    time.sleep(0.15)
    assert not done, "invocation gave up while the slot was still held"
    gc.release(hog)
    t.join(timeout=10)
    assert not t.is_alive() and done
    assert [r.status for r in metrics.records if r.name == "lo/s/0"] == \
        ["ok"]
    assert sum(gc.used.values()) == 0


def test_truly_starved_invocation_still_errors_within_budget():
    gc = GlobalController({0: 1})
    gc.commit("hog", priority=5, placement=[0])   # never released
    invoker = InlineInvoker(gc, ShuffleStore(), MetricsSink(),
                            max_attempts=3, starve_wait=0.01, device="cpu")
    invoker.registry = {"noop": lambda ctx: None}
    inv = Invocation("lo/s/0", "lo", "s", 0, "noop", node=0, priority=0)
    with pytest.raises(InvocationError, match="no slot"):
        invoker.run_stage([inv])


# -- fair-share gate arithmetic ------------------------------------------------------


def _inv(app, priority=0):
    return Invocation(f"{app}/s/0", app, "s", 0, "noop", node=0,
                      priority=priority)


def test_fair_share_gate_entitlements_and_work_conservation():
    gate = FairShareGate(total_slots=4, timeout=2.0)
    gate.register("a", weight=3.0)
    gate.register("b", weight=1.0)
    assert gate.entitlement("a") == 3
    assert gate.entitlement("b") == 1
    for _ in range(4):       # the fourth: b is idle, so a may exceed
        gate.acquire(_inv("a"))
    assert gate.in_use["a"] == 4

    got_b = threading.Event()
    t_b = threading.Thread(
        target=lambda: (gate.acquire(_inv("b")), got_b.set()))
    t_b.start()
    time.sleep(0.05)
    assert not got_b.is_set()        # full: b waits
    a_acquired = threading.Event()
    t_a = threading.Thread(
        target=lambda: (gate.acquire(_inv("a")), a_acquired.set()))
    t_a.start()
    time.sleep(0.05)
    gate.release(_inv("a"))          # one slot frees; b is under-served
    t_b.join(timeout=5)
    assert got_b.is_set() and gate.in_use["b"] == 1
    assert not a_acquired.is_set(), \
        "over-entitled app took the slot from the under-served waiter"
    gate.release(_inv("b"))          # b done -> a's waiter proceeds
    t_a.join(timeout=5)
    assert a_acquired.is_set()


def test_gate_token_released_when_claim_attempt_raises():
    gc = GlobalController({0: 1})
    gate = FairShareGate(total_slots=1, timeout=1.0)
    gate.register("lo", weight=1.0)
    invoker = InlineInvoker(gc, ShuffleStore(), MetricsSink(),
                            max_attempts=2, gate=gate, device="cpu")
    invoker.registry = {"noop": lambda ctx: None}

    def bad_listener(event, claim):
        raise RuntimeError("listener exploded")

    gc.subscribe(bad_listener)
    inv = Invocation("lo/s/0", "lo", "s", 0, "noop", node=0, priority=0)
    with pytest.raises(RuntimeError, match="listener exploded"):
        invoker.run_stage([inv])
    assert gate.in_use["lo"] == 0
    assert gc.used == {0: 0}
    assert gc.claims == {}


def test_fair_share_gate_unregister_redistributes():
    gate = FairShareGate(total_slots=8, timeout=2.0)
    gate.register("a", weight=1.0)
    gate.register("b", weight=1.0)
    assert gate.entitlement("a") == 4
    gate.unregister("b")
    assert gate.entitlement("a") == 8


# -- scheduler policies --------------------------------------------------------------


def test_scheduler_fifo_serializes_in_arrival_order():
    gc = GlobalController({n: 8 for n in range(4)})
    sched = QueryScheduler(_runtime(gc), policy="fifo")
    queries = {f"q{i}": make_query(40 + 3 * i) for i in range(3)}
    for app, (fd, dd, _) in queries.items():
        sched.submit(QueryJob(app, fd, dd, "static_hash", priority=0))
    results = sched.run()
    for app, (_, _, ref) in queries.items():
        assert results[app].ok, results[app].error
        np.testing.assert_allclose(results[app].sums, ref, atol=ATOL)
    ordered = [results[f"q{i}"] for i in range(3)]
    for prev, nxt in zip(ordered, ordered[1:]):
        assert nxt.started >= prev.finished
    assert sum(gc.used.values()) == 0


def test_scheduler_priority_admits_high_priority_first():
    gc = GlobalController({n: 8 for n in range(4)})
    sched = QueryScheduler(_runtime(gc), policy="priority")
    fd, dd, ref_lo = make_query(50)
    fd2, dd2, ref_hi = make_query(53)
    sched.submit(QueryJob("lo", fd, dd, "static_hash", priority=0))
    sched.submit(QueryJob("hi", fd2, dd2, "static_hash", priority=10))
    results = sched.run()
    assert results["hi"].started <= results["lo"].started
    assert results["hi"].finished <= results["lo"].started
    np.testing.assert_allclose(results["hi"].sums, ref_hi, atol=ATOL)
    np.testing.assert_allclose(results["lo"].sums, ref_lo, atol=ATOL)


def test_scheduler_fair_share_runs_concurrently_and_correctly():
    gc = GlobalController({n: 8 for n in range(4)})
    runtime = _runtime(gc)
    sched = QueryScheduler(runtime, policy="fair_share")
    queries = {}
    for i in range(4):
        app = f"q{i}"
        queries[app] = make_query(60 + 3 * i)
        fd, dd, _ = queries[app]
        sched.submit(QueryJob(app, fd, dd, STRATEGIES[i % 4],
                              priority=10 if i % 2 else 0))
    results = sched.run()
    for app, (_, _, ref) in queries.items():
        assert results[app].ok, results[app].error
        np.testing.assert_allclose(results[app].sums, ref, atol=ATOL)
    spans = sorted((r.started, r.finished) for r in results.values())
    assert any(a_end > b_start for (_, a_end), (b_start, _)
               in zip(spans, spans[1:]))
    assert runtime.invoker.gate is None
    assert sum(gc.used.values()) == 0
    assert all(len(r.decisions) == 8 for r in results.values())


def test_scheduler_fair_share_respects_store_quotas():
    gc = GlobalController({n: 8 for n in range(4)})
    runtime = _runtime(gc)
    sched = QueryScheduler(runtime, policy="fair_share")
    fd, dd, ref = make_query(70)
    quota = 6 * (fd.nbytes + dd.nbytes)
    sched.submit(QueryJob("capped", fd, dd, "static_merge", priority=5,
                          quota=quota))
    results = sched.run()
    assert results["capped"].ok, results["capped"].error
    np.testing.assert_allclose(results["capped"].sums, ref, atol=ATOL)
    assert runtime.store.peak_bytes["capped"] <= quota
    assert runtime.store.quota("capped") is None
    assert runtime.store.stage_bytes("capped", "fact_buckets") == 0
    assert runtime.store.stage_bytes("capped", "dim_buckets") == 0
    assert runtime.store.stage_bytes("capped", "result") > 0


def test_scheduler_surfaces_per_query_errors():
    class BoomStrategy:
        """Join decision node that always fails (no fallback)."""

        name = "boom"

        def join_method(self, ctx):
            raise RuntimeError("boom: decision node exploded")

    gc = GlobalController({n: 8 for n in range(4)})
    sched = QueryScheduler(_runtime(gc), policy="fifo")
    fd, dd, ref = make_query(80)
    sched.submit(QueryJob("bad", fd, dd, BoomStrategy()))
    sched.submit(QueryJob("good", fd, dd, "static_hash"))
    results = sched.run()
    assert not results["bad"].ok
    assert isinstance(results["bad"].error, RuntimeError)
    assert results["good"].ok
    np.testing.assert_allclose(results["good"].sums, ref, atol=ATOL)
    assert sum(gc.used.values()) == 0


# -- concurrent mix: runtime vs simulator, port vs reference -----------------------


def _seq(sequence) -> list:
    return [(s, d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes),
             tuple(d.extras)) for s, d in sequence]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_concurrent_mix_sim_and_runtime_bind_identical_decisions(seed):
    audit = get_audit_log()
    audit.clear()
    rng = random.Random(seed)
    jobs = []
    for i in range(rng.randint(2, 4)):
        strat = rng.choice(STRATEGIES)
        table_kw = dict(seed=100 * seed + 7 * i,
                        rows=rng.choice([1024, 2048, 4096]),
                        dim_rows=rng.choice([128, 256]))
        fd, dd, ref = make_query(**table_kw)
        wf = build_query_workflow(QueryStrategy(strat))
        jobs.append((f"mix{i}", strat, fd, dd, ref, wf,
                     rng.choice([0, 5, 10]), table_kw))

    gc = GlobalController({n: 8 for n in range(4)})
    sched = QueryScheduler(_runtime(gc), policy="fair_share")
    for app, strat, fd, dd, _, wf, prio, _ in jobs:
        sched.submit(QueryJob(app, fd, dd, strat, priority=prio,
                              workflow=wf))
    results = sched.run()
    assert sum(gc.used.values()) == 0

    gc_sim, sim = make_cluster(4)
    jgc_sim, jsim_ = jsim.make_cluster(4)
    for app, strat, fd, dd, ref, wf, _, table_kw in jobs:
        assert results[app].ok, results[app].error
        np.testing.assert_allclose(results[app].sums, ref, atol=ATOL)
        pc = PrivateController(app, gc_sim, priority=10)
        plan_query_tasks(sim, pc, fd, dd, QueryStrategy(strat), app=app,
                         workflow=wf, device="cpu")
        sim_seq = list(wf.last_run.sequence)
        assert sim_seq == results[app].decisions, \
            f"{app} [{strat}]: decision sequences diverged across planes"
        funcs = [(s, d.func) for s, d in sim_seq]
        assert audit.sequence(app, nodes=[s for s, _ in sim_seq]) == \
            funcs + funcs, f"{app} [{strat}]: audit log diverged"
        # the reference's simulator plane on the same seeded tables
        jfd, jdd, _ = make_query(reference=True, **table_kw)
        jwf = jplan.build_query_workflow(jq.QueryStrategy(strat))
        jq.plan_query_tasks(jsim_, jctl.PrivateController(app, jgc_sim,
                                                          priority=10),
                            jfd, jdd, jq.QueryStrategy(strat), app=app,
                            workflow=jwf)
        assert _seq(sim_seq) == _seq(jwf.last_run.sequence), app
    out, jout = sim.run(), jsim_.run()
    for app, *_ in jobs:
        assert out["completion"][app] > 0
    assert out["completion"] == jout["completion"]


# -- the reference's gate and scheduler on the same inputs ---------------------------


GATE_CASES = {
    "two_apps": (4, [("a", 3.0), ("b", 1.0)]),
    "even": (8, [("a", 1.0), ("b", 1.0)]),
    "three_uneven": (7, [("a", 1.0), ("b", 2.0), ("c", 4.0)]),
    "by_priority": (16, [("lo", jsched.default_weight(0)),
                         ("hi", jsched.default_weight(10)),
                         ("mid", jsched.default_weight(5))]),
}


def _gate_arithmetic(gate_cls, inv_cls, total, weights) -> list:
    """Entitlements after each register and unregister, and ``_may_take``
    of every app as the first app fills the gate alone (no other demand)."""
    gate = gate_cls(total_slots=total, timeout=1.0)
    log = []
    for app, w in weights:
        gate.register(app, weight=w)
        log.append({a: gate.entitlement(a) for a, _ in weights})
    first = weights[0][0]
    for _ in range(total):
        log.append({a: gate._may_take(a) for a, _ in weights})
        gate.acquire(inv_cls(f"{first}/s/0", first, "s", 0, "noop", node=0))
    log.append(({a: gate._may_take(a) for a, _ in weights},
                dict(gate.in_use)))
    for app, _ in weights[1:]:
        gate.unregister(app)
        log.append(gate.entitlement(first))
    return log


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_fair_share_gate_arithmetic_matches_reference(case):
    total, weights = GATE_CASES[case]
    got = _gate_arithmetic(FairShareGate, Invocation, total, weights)
    want = _gate_arithmetic(jsched.FairShareGate, jinv.Invocation, total,
                            weights)
    assert got == want
    assert [default_weight(p) for p in (-3, 0, 1, 10)] == \
        [jsched.default_weight(p) for p in (-3, 0, 1, 10)]
    assert POLICIES == jsched.POLICIES


def _gate_contention(gate_cls, inv_cls) -> list:
    """The contention of ``test_fair_share_gate_entitlements_and_work_
    conservation`` as a log: who holds what, and who was admitted when a
    slot freed (``b`` under its entitlement, then ``a`` over its own)."""
    gate = gate_cls(total_slots=4, timeout=5.0)
    gate.register("a", weight=3.0)
    gate.register("b", weight=1.0)

    def inv(app):
        return inv_cls(f"{app}/s/0", app, "s", 0, "noop", node=0)

    for _ in range(4):
        gate.acquire(inv("a"))
    admitted = []
    waiters = {app: threading.Thread(
        target=lambda app=app: (gate.acquire(inv(app)), admitted.append(app)))
        for app in ("b", "a")}
    log = [dict(gate.in_use)]
    for app in ("b", "a"):
        waiters[app].start()
        time.sleep(0.05)
    log.append(list(admitted))
    gate.release(inv("a"))
    waiters["b"].join(timeout=5)
    time.sleep(0.05)
    log.append((list(admitted), dict(gate.in_use)))
    gate.release(inv("b"))
    waiters["a"].join(timeout=5)
    log.append((list(admitted), dict(gate.in_use)))
    return log


def test_fair_share_gate_contention_matches_reference():
    got = _gate_contention(FairShareGate, Invocation)
    assert got == _gate_contention(jsched.FairShareGate, jinv.Invocation)
    assert got[-1] == (["b", "a"], {"a": 4, "b": 0})


# (app, table seed, strategy, priority), submitted in this order
MIX = [("q0", 40, "static_hash", 0), ("q1", 43, "dynamic", 10),
       ("q2", 46, "static_merge", 0), ("q3", 49, "dynamic_fig6", 5)]


def _run_mix(policy: str, reference: bool) -> tuple:
    """``MIX`` through one package's ``QueryScheduler`` over a ``threads``
    runtime; returns the results, each oracle and the slots left in use."""
    if reference:
        gc = jctl.GlobalController({n: 8 for n in range(4)})
        runtime = jrt.Runtime(gc, invoker="threads", max_workers=8)
        sched = jsched.QueryScheduler(runtime, policy=policy)
        job_cls = jsched.QueryJob
    else:
        gc = GlobalController({n: 8 for n in range(4)})
        sched = QueryScheduler(_runtime(gc), policy=policy)
        job_cls = QueryJob
    oracles = {}
    for app, seed, strat, prio in MIX:
        fd, dd, oracles[app] = make_query(seed, reference=reference)
        sched.submit(job_cls(app, fd, dd, strat, priority=prio))
    return sched.run(), oracles, sum(gc.used.values())


@pytest.mark.parametrize("policy", ["fifo", "priority", "fair_share"])
def test_scheduler_policy_matches_reference(policy):
    """The same seeded queries through the port's and the reference's
    scheduler: equal result sums (and each equal to its oracle), equal
    decision sequences, the same admission order where the policy fixes
    one, and no slot left in use in either."""
    got, want_oracle, got_used = _run_mix(policy, reference=False)
    ref, ref_oracle, ref_used = _run_mix(policy, reference=True)
    assert got_used == ref_used == 0
    for app, *_ in MIX:
        assert got[app].ok, got[app].error
        assert ref[app].ok, ref[app].error
        np.testing.assert_allclose(want_oracle[app], ref_oracle[app],
                                   atol=ATOL)
        np.testing.assert_allclose(got[app].sums, want_oracle[app],
                                   atol=ATOL)
        np.testing.assert_allclose(got[app].sums, ref[app].sums, atol=ATOL)
        assert _seq(got[app].decisions) == _seq(ref[app].decisions), app
    if policy != "fair_share":      # fair share admits every query at once
        def order(results):
            return sorted(results, key=lambda a: results[a].started)
        assert order(got) == order(ref)
        assert order(got) == (["q0", "q1", "q2", "q3"] if policy == "fifo"
                              else ["q1", "q3", "q0", "q2"])
