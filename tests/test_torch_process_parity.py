"""A query on the port's process backend held to the reference's.

The same seeded tables go through ``QueryScheduler`` (``fifo``,
``static_merge``) onto the port's and the reference's process-backed
``Runtime`` (their ``ProcessPoolInvoker``s) with two workers each. The two
must agree on the result sums (each within the reference's tolerance,
1e-3, of the other and of the numpy oracle), on the eight bound decisions
(the elastic one included), on the number of leases, and leave no
controller slot in use.

How many of those leases start a worker cold depends on how the worker
threads' leases and releases interleave (the scheduler shrinks the pool to
one worker for its one query, and a worker released while another is busy
retires), so it can differ between two runs of one package. Each run's
calls to its pool are therefore recorded in the order the pool's lock
took them, and replayed, one at a time, on a pool of the other package
(its workers stand-ins, not processes): every lease must come out cold or
warm as it did, on the same worker, and the cold starts, warm hits and
reaps must end equal.

A reference worker imports the JAX package and a port worker ``torch``,
so the pools stay at two workers and the port computes on the CPU.
"""
import itertools

import numpy as np

import repro.analytics.query as jq
import repro.core.controllers as jctl
import repro.runtime as jrt
from repro_torch.analytics.query import synth_query_tables
from repro_torch.core.controllers import GlobalController
from repro_torch.runtime import QueryJob, QueryScheduler, Runtime, WorkerPool

ATOL = 1e-3


def _process_query(reference: bool, seed: int = 1) -> tuple:
    """The seeded query under ``QueryScheduler`` (``fifo``,
    ``static_merge``) on one package's process backend with two workers;
    returns the result, its oracle, the pool's stats and the slots left."""
    kw = dict(keyspace=2048, seed=seed, fact_nodes=4, dim_nodes=2)
    if reference:
        fd, dd, oracle = jq.synth_query_tables(4096, 512, **kw)
        gc = jctl.GlobalController({n: 8 for n in range(4)})
        rt = jrt.Runtime(gc, invoker="process", max_workers=2)
        sched = jrt.QueryScheduler(rt, policy="fifo")
        sched.submit(jrt.QueryJob("q1", fd, dd, "static_merge"))
    else:
        fd, dd, oracle = synth_query_tables(4096, 512, device="cpu", **kw)
        gc = GlobalController({n: 8 for n in range(4)})
        rt = Runtime(gc, invoker="process", max_workers=2, device="cpu")
        sched = QueryScheduler(rt, policy="fifo")
        sched.submit(QueryJob("q1", fd, dd, "static_merge"))
    calls = record(rt.invoker.pool)
    try:
        res = sched.run()["q1"]
        stats = rt.invoker.pool.stats()
    finally:
        rt.invoker.shutdown()
    return res, oracle, stats, calls, sum(gc.used.values())


def record(pool) -> list:
    """Log the calls made to ``pool`` as they happen: ``("lease", worker,
    cold)``, ``("release", worker)``, ``("retire", worker)`` and
    ``("resize", target, size)``, workers numbered in order of first use.
    Each call holds the pool's lock (reentrant) throughout, so the log's
    order is the order in which the pool decided."""
    calls, ids = [], {}

    def wrap(name):
        inner = getattr(pool, name)

        def call(*args, **kw):
            with pool._cond:
                out = inner(*args, **kw)
                if name == "lease":
                    w, cold = out
                    calls.append(("lease", ids.setdefault(w, len(ids)),
                                  cold))
                elif name == "resize":
                    calls.append(("resize", args[0], out))
                else:
                    calls.append((name, ids[args[0]]))
                return out
        setattr(pool, name, call)

    for name in ("lease", "release", "retire", "resize"):
        wrap(name)
    return calls


class _Conn:
    """A worker's pipe that answers the start-up handshake and nothing else."""

    def poll(self, timeout=None):
        return True

    def recv(self):
        return ("ready",)

    def send(self, msg):
        pass

    def close(self):
        pass


class _Proc:
    pids = itertools.count(1)

    def __init__(self, target=None, args=(), daemon=None, name=None):
        self.pid = None

    def start(self):
        self.pid = next(self.pids)

    def join(self, timeout=None):
        pass

    def is_alive(self):
        return False

    def kill(self):
        pass


class _StandInProcesses:
    """A start-method context whose workers are stand-ins, not processes."""

    Process = _Proc

    @staticmethod
    def Pipe():
        return _Conn(), _Conn()


def replay(calls: list, pool) -> dict:
    """Make ``calls`` on ``pool`` (whose workers are stand-ins) one at a
    time, requiring every lease to come out cold or warm, and on the same
    worker, as recorded; returns the pool's stats."""
    pool._mp = _StandInProcesses()
    workers = {}
    for call in calls:
        if call[0] == "lease":
            _, who, cold = call
            assert pool.size() < pool.max_workers or pool._idle, call
            w, got = pool.lease()
            assert got == cold, call
            assert workers.setdefault(who, w) is w, call
            assert list(workers.values()).count(w) == 1, call
        elif call[0] == "resize":
            assert pool.resize(call[1]) == call[2], call
        else:
            getattr(pool, call[0])(workers[call[1]], 0.0)
    stats = pool.stats()
    pool.shutdown()
    return stats


def _seq(decisions) -> list:
    return [(s, d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes),
             tuple(d.extras)) for s, d in decisions]


def test_process_backend_query_matches_reference():
    got, oracle, stats, calls, used = _process_query(reference=False)
    ref, ref_oracle, ref_stats, ref_calls, ref_used = \
        _process_query(reference=True)
    assert got.ok, got.error
    assert ref.ok, ref.error
    assert used == ref_used == 0
    np.testing.assert_allclose(oracle, ref_oracle, atol=ATOL)
    np.testing.assert_allclose(got.sums, oracle, atol=ATOL)
    np.testing.assert_allclose(got.sums, ref.sums, atol=ATOL)
    assert _seq(got.decisions) == _seq(ref.decisions)
    assert len(got.decisions) == 8
    keys = ("cold_starts", "warm_hits", "reaped")
    leases = [c for c in calls if c[0] == "lease"]
    assert len(leases) == len([c for c in ref_calls if c[0] == "lease"])
    assert stats["warm_hits"] == sum(not cold for *_, cold in leases)
    assert stats["warm_hits"] > 0
    # each run's pool calls give the other package's pool the same leases
    on_ref = replay(calls, jrt.WorkerPool(max_workers=2))
    on_port = replay(ref_calls, WorkerPool(max_workers=2, device="cpu"))
    assert {k: on_ref[k] for k in keys} == {k: stats[k] for k in keys}
    assert {k: on_port[k] for k in keys} == {k: ref_stats[k] for k in keys}
