"""The port's process-backed worker plane, twin of ``tests/test_workers.py``.

The pool's cold-start economics (warm LIFO reuse, the provision floor,
idle reaping, resize), a full query on the ``process`` backend under the
scheduler (against the numpy oracle and the port's ``threads`` result, at
the reference's tolerance 1e-3), and SIGKILL chaos: killed workers never
leak controller slots, never leave partial store writes, and heal through
the crash-retry machinery. The reference's Hypothesis property over kill
schedules is a fixed list of three schedules here.

Workers are spawned and each pays a real ``torch`` import at its cold
start (about two seconds here), so pools stay at one or two workers and
every worker computes on the CPU (``device="cpu"``).
"""

import time

import numpy as np
import pytest
import torch

import repro.core.decisions as jdec
from repro_torch.analytics import QueryStrategy, execute_query_runtime
from repro_torch.analytics.query import synth_query_tables
from repro_torch.analytics.table import Table, to_numpy
from repro_torch.core.controllers import GlobalController
from repro_torch.core.decisions import worker_pool_target
from repro_torch.device import NoDeviceError
from repro_torch.kernels import partition as tpart
from repro_torch.runtime import (
    FaultInjector,
    FaultPlan,
    InvocationError,
    QueryJob,
    QueryScheduler,
    Runtime,
    WorkerKillFault,
    WorkerPool,
)
from repro_torch.runtime.workers import deserialize_table, serialize_table

ATOL = 1e-3
EIGHT_NODES = ["scan", "join", "exchange", "skew", "aggregate", "pipeline",
               "elastic", "tiering"]


def make_tables(seed=1):
    return synth_query_tables(4096, 512, keyspace=2048, seed=seed,
                              fact_nodes=4, dim_nodes=2, device="cpu")


def _process_runtime(gc):
    return Runtime(gc, invoker="process", max_workers=2, device="cpu")


# -- pool economics (no query machinery involved) ---------------------------------


def test_pool_warm_reuse_and_function_seconds():
    pool = WorkerPool(max_workers=1, device="cpu")
    try:
        w, cold = pool.lease()
        assert cold and w.pid is not None
        pid = w.pid
        pool.release(w, busy_s=0.5)
        w2, cold2 = pool.lease()
        assert not cold2 and w2.pid == pid     # LIFO warm reuse
        pool.release(w2, busy_s=0.25)
        assert pool.cold_starts == 1 and pool.warm_hits == 1
        assert pool.cost_function_seconds() >= 0.75 + pool.provision_seconds \
            - 1e-6
        assert pool.provision_seconds > 0
        assert pool.stats()["peak_size"] == 1
    finally:
        pool.shutdown()


def test_pool_provision_floor_is_modeled_cold_start():
    t0 = time.perf_counter()
    pool = WorkerPool(max_workers=1, provision_s=3.0, device="cpu")
    try:
        _, cold = pool.lease()
        assert cold
        assert time.perf_counter() - t0 >= 3.0
        assert pool.provision_seconds >= 3.0
    finally:
        pool.shutdown()


def test_pool_idle_reap_and_resize():
    pool = WorkerPool(max_workers=2, idle_reap_s=0.2, device="cpu")
    try:
        w, _ = pool.lease()
        first_pid = w.pid
        pool.release(w, busy_s=0.0)
        assert pool.size() == 1
        time.sleep(0.35)
        w2, cold = pool.lease()
        assert cold and w2.pid != first_pid
        assert pool.reaped == 1 and pool.cold_starts == 2
        pool.release(w2, busy_s=0.0)
        assert pool.resize(2) == 2
        assert pool.cold_starts == 3
        assert pool.resize(1) == 1
        assert pool.resize(99) == 2           # clamped at max_workers
        assert pool.stats()["peak_size"] == 2
    finally:
        pool.shutdown()


def test_worker_pool_target_rule_matches_reference():
    assert worker_pool_target(0, 5) == 1
    assert worker_pool_target(4, 0) == 1
    assert worker_pool_target(17, 0) == 5
    assert worker_pool_target(1024, 0) == 16
    assert worker_pool_target(1024, 0, max_workers=4) == 4
    for fanout in (0, 1, 3, 4, 5, 63, 64, 65, 1000):
        for kw in ({}, {"max_workers": 4}, {"min_workers": 2},
                   {"tasks_per_worker": 1}):
            assert worker_pool_target(fanout, 3, **kw) == \
                jdec.worker_pool_target(fanout, 3, **kw)


def test_tables_cross_the_pipe_as_numpy():
    cols = {"key": np.arange(10, dtype=np.int32),
            "v0": np.linspace(0, 1, 10, dtype=np.float32)}
    sent = serialize_table(Table({k: torch.from_numpy(v)
                                  for k, v in cols.items()}).slice(2, 7))
    assert all(isinstance(v, np.ndarray) for v in sent.values())
    host = deserialize_table(sent)
    worker = deserialize_table(sent, torch.device("cpu"))
    for k, v in cols.items():
        assert isinstance(host[k], np.ndarray)
        assert isinstance(worker[k], torch.Tensor)
        np.testing.assert_array_equal(host[k], v[2:7])
        np.testing.assert_array_equal(to_numpy(worker[k]), v[2:7])


def test_worker_that_cannot_start_raises_invocation_error():
    pool = WorkerPool(max_workers=1, device="cpu",
                      modules=("repro_torch.no_such_module",))
    try:
        with pytest.raises(InvocationError, match="could not start"):
            pool.lease()
        assert pool.size() == 0
    finally:
        pool.shutdown()


def test_fork_is_refused_on_the_card():
    # the start method is checked before the device is resolved, so this
    # holds on a machine without a card too
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match="spawned"):
            WorkerPool(start_method="fork", device=device)


def test_process_runtime_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        Runtime(GlobalController({0: 8}), invoker="process")


# -- full query on the process backend --------------------------------------------


def test_process_backend_query_matches_oracle_and_threads():
    fd, dd, ref = make_tables()
    gc = GlobalController({n: 8 for n in range(4)})
    rt = _process_runtime(gc)
    host_launches = dict(tpart.LAUNCHES)
    try:
        sched = QueryScheduler(rt, policy="fifo")
        sched.submit(QueryJob("q1", fd, dd, "static_merge"))
        res = sched.run()["q1"]
        assert res.ok, res.error
        np.testing.assert_allclose(res.sums, ref, atol=ATOL)
        assert [n for n, _ in res.decisions] == EIGHT_NODES
        elastic = dict(res.decisions)["elastic"]
        assert elastic.func in ("grow", "shrink", "hold")
        assert elastic.scale >= 1
        assert sum(gc.used.values()) == 0
        stats = rt.invoker.pool.stats()
        assert stats["warm_hits"] > 0
        assert stats["cost_function_seconds"] > 0
        # workers on the CPU launch no kernel, and the host's counters
        # only ever count this process's calls
        assert rt.invoker.worker_launches == dict.fromkeys(tpart.LAUNCHES, 0)
        assert tpart.LAUNCHES == host_launches
    finally:
        rt.invoker.shutdown()
    threads, _ = execute_query_runtime(
        fd, dd, QueryStrategy("static_merge"), invoker="threads",
        device="cpu")
    np.testing.assert_allclose(res.sums, threads, atol=ATOL)


# -- SIGKILL chaos ----------------------------------------------------------------


def _run_killed_query(kills, seed=7):
    fd, dd, ref = make_tables(seed=seed)
    gc = GlobalController({n: 8 for n in range(4)})
    rt = _process_runtime(gc)
    FaultInjector(FaultPlan(worker_kills=list(kills))).install(rt)
    try:
        got, _ = execute_query_runtime(fd, dd, QueryStrategy("static_merge"),
                                       runtime=rt)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        return rt, gc
    finally:
        rt.invoker.shutdown()


@pytest.mark.parametrize("when", ["body", "late"])
def test_worker_kill_heals_with_clean_slots(when):
    rt, gc = _run_killed_query(
        [WorkerKillFault("scan_fact", index=1, when=when)])
    recs = [(r.status, r.attempt) for r in rt.metrics.records
            if r.name == "query/scan_fact/1"]
    assert ("crashed", 0) in recs and ("ok", 1) in recs
    assert sum(gc.used.values()) == 0
    assert ("worker-kill", "query/scan_fact/1") in rt.invoker.injector.injected
    # the healed store holds exactly one live write per scan partition
    assert sorted(rt.store.partitions("query", "scan_fact")) == [0, 1, 2, 3]


def test_worker_kill_mid_join_recovers_and_replaces_worker():
    rt, gc = _run_killed_query(
        [WorkerKillFault("join", index=0, when="body")], seed=3)
    recs = [(r.status, r.attempt) for r in rt.metrics.records
            if r.name == "query/join/0"]
    assert ("crashed", 0) in recs and ("ok", 1) in recs
    assert sum(gc.used.values()) == 0
    assert rt.invoker.pool.cold_starts >= 2


@pytest.mark.parametrize("kills", [
    [("scan_fact", 0, "body")],
    [("join", 0, "late"), ("partial_agg", 1, "body")],
    [("partial_agg", 0, "late"), ("scan_fact", 1, "late")],
])
def test_chaos_worker_kill_schedules_never_leak(kills):
    """Each schedule of worker kills completes with the oracle result,
    zero leaked controller slots, and one crashed record per fired kill."""
    plan = [WorkerKillFault(stage, index=idx, when=when)
            for stage, idx, when in kills]
    rt, gc = _run_killed_query(plan, seed=13)
    assert sum(gc.used.values()) == 0
    crashed = [r for r in rt.metrics.records if r.status == "crashed"]
    assert len(crashed) == len(rt.invoker.injector.injected) > 0
    assert all(kind == "worker-kill"
               for kind, _ in rt.invoker.injector.injected)
