"""The port's cluster simulator against the JAX reference's.

``repro_torch.analytics.simulator`` is a copy of the reference's
discrete-event engine, so the same submitted tasks must give the same
event times, makespans, allocation rates, cold-start counts and
function-seconds, bit for bit: every float here is compared exactly.
Planning through ``plan_query_tasks`` runs with both packages' operator
rates pinned to one table (``RATES``), since each package would otherwise
time its own operators.
"""

import random

import pytest

import repro.analytics as jan
import repro.analytics.simulator as jsim
import repro.core.controllers as jctl
import repro.runtime as jrt
import repro_torch.analytics as tan
import repro_torch.analytics.simulator as tsim
import repro_torch.core.controllers as tctl
import repro_torch.runtime as trt
from repro.analytics.table import phantom as jphantom
from repro_torch.analytics.table import phantom as tphantom

RATES = {"scan": 2e9, "sort": 4e8, "hash_build": 3e8, "hash_probe": 6e8,
         "merge_join": 5e8, "agg": 1e9}

JAX = dict(sim=jsim, ctl=jctl, an=jan, rt=jrt, phantom=jphantom)
TORCH = dict(sim=tsim, ctl=tctl, an=tan, rt=trt, phantom=tphantom)


@pytest.fixture
def pinned_rates(monkeypatch):
    monkeypatch.setattr(jsim, "_RATE_CACHE", dict(RATES))
    monkeypatch.setattr(tsim, "_RATE_CACHE", dict(RATES))


def _both(fn):
    """``fn(pkg)`` for the reference and the port; asserts the two results
    are equal and returns the port's."""
    want, got = fn(JAX), fn(TORCH)
    assert got == want
    return got


def _times(sim) -> dict:
    return {n: (t.started, t.finished) for n, t in sim.tasks.items()}


def _samples(timeline) -> list:
    return list(timeline.samples)


# -- twins of tests/test_analytics.py's simulator tests ---------------------------


def test_dependencies_and_slots_match_reference():
    def run(pkg):
        gc, sim = pkg["sim"].make_cluster(2, slots=1)
        sim.submit(pkg["sim"].SimTask("a", "app", 1.0, node=0))
        sim.submit(pkg["sim"].SimTask("b", "app", 1.0, node=0, deps=("a",)))
        out = sim.run()
        return out["completion"], _times(sim)

    completion, times = _both(run)
    assert times["b"][0] >= times["a"][1]
    assert completion["app"] == 2.0


def test_transfers_serialize_on_nic_like_reference():
    def run(pkg):
        gc, sim = pkg["sim"].make_cluster(3)
        for name, node in (("x", 1), ("y", 2)):
            sim.submit(pkg["sim"].SimTask(name, "app", 0.0, node=node,
                                          transfers={0: int(1.25e9)}))
        out = sim.run()
        return out["completion"], _times(sim), dict(sim.nic_free_send)

    completion, _, _ = _both(run)
    assert completion["app"] == pytest.approx(2.0, rel=0.01)


def test_allocation_rate_matches_reference():
    def run(pkg):
        gc, sim = pkg["sim"].make_cluster(2, slots=2)
        for i in range(8):
            sim.submit(pkg["sim"].SimTask(f"t{i}", "app", 0.5))
        out = sim.run()
        tl = out["allocation"]
        return (out["completion"], _samples(tl), tl.allocation_rate(),
                tl.allocation_rate(0.25, 1.5))

    _, _, rate, _ = _both(run)
    assert 0.0 < rate <= 1.0


def test_flexible_task_backfills_like_reference():
    def run(pkg):
        gc, sim = pkg["sim"].make_cluster(2, slots=2)
        gc.commit("other", 5, [0])           # node 0: 1 free, node 1: 2 free
        placements = {}
        gc.subscribe(lambda ev, c: placements.setdefault(c.tag, c.placement)
                     if ev == "commit" else None)
        sim.submit(pkg["sim"].SimTask("flex", "app", 1.0))
        sim.run()
        return placements

    assert _both(run)["flex"] == (1,)


def test_background_tasks_backfill_like_reference():
    def build(pkg, with_bg):
        gc, sim = pkg["sim"].make_cluster(2, slots=2)
        sim.submit(pkg["sim"].SimTask("hi/1", "query", 1.0, node=0,
                                      priority=10))
        sim.submit(pkg["sim"].SimTask("hi/2", "query", 1.0, node=0,
                                      priority=10, deps=("hi/1",)))
        if with_bg:
            for i in range(6):
                sim.submit(pkg["sim"].SimTask(f"bg/{i}", "bg", 0.5))
        out = sim.run()
        return (out["completion"], out["cost_slot_seconds"], _times(sim),
                out["allocation"].allocation_rate())

    solo = _both(lambda pkg: build(pkg, False))
    shared = _both(lambda pkg: build(pkg, True))
    assert shared[0]["query"] <= solo[0]["query"] + 1e-6
    assert shared[3] > solo[3]


def test_dynamic_strategy_never_worst_like_reference(pinned_rates):
    """Fig. 7's trend on phantom tables: the planned makespans of all three
    strategies, and each task's times, equal the reference's."""
    def run(pkg):
        results, times = {}, {}
        for strat in ("static_merge", "static_hash", "dynamic"):
            for gb in (2, 6):
                gc, sim = pkg["sim"].make_cluster(6)
                pc = pkg["ctl"].PrivateController("query", gc, priority=10)
                f = pkg["phantom"]("A", int(gb * 0.9 * 2 ** 30), range(6))
                d = pkg["phantom"]("B", int(gb * 0.05 * 2 ** 30), range(2))
                kw = {"device": "cpu"} if pkg is TORCH else {}
                pkg["an"].plan_query_tasks(sim, pc, f, d,
                                           pkg["an"].QueryStrategy(strat),
                                           **kw)
                results.setdefault(strat, []).append(
                    sim.run()["completion"]["query"])
                times[strat, gb] = _times(sim)
        return results, times

    results, _ = _both(run)
    for i in range(2):
        worst = max(r[i] for r in results.values())
        assert results["dynamic"][i] < worst * 1.001


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_task_dags_give_reference_event_times(seed):
    """Random DAGs with pinned and flexible tasks, priorities, NIC
    transfers, several apps and a cold-start model: every task's start and
    finish, the timeline and the bills equal the reference's."""
    def run(pkg):
        rng = random.Random(seed)
        gc, sim = pkg["sim"].make_cluster(
            4, slots=rng.choice([1, 2, 4]), provision_s=0.25,
            warm_pool=rng.randint(0, 3), idle_reap_s=rng.choice([None, 0.5]))
        names = []
        for i in range(40):
            app = rng.choice(["a", "b", "c"])
            name = f"{app}/t/{i}"
            deps = tuple(rng.sample(names, k=min(len(names),
                                                 rng.randint(0, 3))))
            transfers = {rng.randrange(4): rng.randint(0, 10**9)
                         for _ in range(rng.randint(0, 2))}
            sim.submit(pkg["sim"].SimTask(
                name, app, rng.uniform(0.0, 2.0),
                node=rng.choice([None, 0, 1, 2, 3]), deps=deps,
                priority=rng.choice([0, 5, 10]), transfers=transfers))
            names.append(name)
        out = sim.run()
        return (_times(sim), out["completion"], out["cost_slot_seconds"],
                out["cost_function_seconds"], _samples(out["allocation"]),
                (sim.cold_starts, sim.warm_hits, sim.reaped, sim.pool))

    times, completion, *_ = _both(run)
    assert len(times) == 40 and all(f >= s >= 0 for s, f in times.values())
    assert max(completion.values()) == max(f for _, f in times.values())


# -- twins of tests/test_workers.py's cold-start tests -----------------------------


def _sim_wave(pkg, provision_s, warm_pool, n=4, slots=4):
    gc = pkg["ctl"].GlobalController({0: slots})
    sim = pkg["sim"].ClusterSim(gc, provision_s=provision_s,
                                warm_pool=warm_pool)
    for i in range(n):
        sim.submit(pkg["sim"].SimTask(f"a/map1/{i}", "a", 1.0, node=0))
    out = sim.run()
    return ((sim.cold_starts, sim.warm_hits, sim.pool), out["completion"],
            out["cost_function_seconds"])


def test_sim_cold_starts_vs_warm_pool_like_reference():
    (cold_n, cold_done, cold_fn) = _both(
        lambda pkg: _sim_wave(pkg, provision_s=2.0, warm_pool=0))
    (warm_n, warm_done, warm_fn) = _both(
        lambda pkg: _sim_wave(pkg, provision_s=2.0, warm_pool=4))
    assert cold_n[:2] == (4, 0) and warm_n[:2] == (0, 4)
    assert warm_done["a"] + 2.0 <= cold_done["a"]
    assert warm_fn["a"] + 8.0 <= cold_fn["a"] + 1e-9


def test_sim_warm_reuse_and_prewarm_billing_like_reference():
    counts, _, _ = _both(
        lambda pkg: _sim_wave(pkg, provision_s=2.0, warm_pool=0, n=3,
                              slots=1))
    assert counts == (1, 2, 1)

    def prewarmed(pkg):
        sim = pkg["sim"].ClusterSim(pkg["ctl"].GlobalController({0: 4}),
                                    provision_s=2.0)
        sim.prewarm(3, app="a")
        before = (sim.pool, sim.cold_starts, dict(sim.fn_seconds))
        for i in range(3):
            sim.submit(pkg["sim"].SimTask(f"a/map1/{i}", "a", 1.0, node=0))
        out = sim.run()
        return before, sim.warm_hits, out["completion"]

    before, warm_hits, completion = _both(prewarmed)
    assert before == (3, 3, {"a": 6.0})
    assert warm_hits == 3 and completion["a"] == 1.0


def test_sim_idle_reap_retires_warm_workers_like_reference():
    def run(pkg):
        sim = pkg["sim"].ClusterSim(pkg["ctl"].GlobalController({0: 1}),
                                    provision_s=2.0, idle_reap_s=0.5)
        sim.prewarm(2, app="a")
        sim.now = 1.0      # sim time passes the reap window with no leases
        sim.submit(pkg["sim"].SimTask("a/map1/0", "a", 1.0, node=0))
        out = sim.run()
        return sim.reaped, sim.cold_starts, out["completion"]

    reaped, cold, completion = _both(run)
    assert (reaped, cold) == (2, 3)
    assert completion["a"] == 1.0 + 2.0 + 1.0


# -- the fault models ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_sim_fault_models_match_reference(seed):
    """``sim_fault_models`` maps the same seeded ``FaultPlan`` to the same
    straggler entries and crash plan, and a cluster run under them gives
    the reference's event times and re-executions."""
    def run(pkg):
        plan = pkg["rt"].FaultPlan.seeded(
            seed, stages=("scan_fact", "join", "final_agg"),
            data_stages=("joined",), nodes=(0, 1), delay=0.25)
        straggle, crash = pkg["sim"].sim_fault_models(plan)
        gc, sim = pkg["sim"].make_cluster(2, slots=2, straggle=straggle,
                                          crash_plan=crash)
        for i in range(4):
            sim.submit(pkg["sim"].SimTask(f"query/map1/{i}", "query", 0.5,
                                          node=i % 2))
            sim.submit(pkg["sim"].SimTask(f"query/join/{i}", "query", 0.75,
                                          node=(i + 1) % 2,
                                          deps=(f"query/map1/{i}",)))
        sim.submit(pkg["sim"].SimTask(
            "query/agg", "query", 0.1, node=0,
            deps=tuple(f"query/join/{i}" for i in range(4))))
        out = sim.run()
        return (straggle, crash, _times(sim), out["completion"],
                sim.reexecutions)

    _, crash, _, _, reexecutions = _both(run)
    assert reexecutions == sum(crash.values())
