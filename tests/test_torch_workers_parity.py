"""The port's ``WorkerPool`` held to the reference's on the same scripts.

``tests/test_torch_workers.py`` checks the port's pool against the
assertions of ``tests/test_workers.py``; here the reference's
``WorkerPool`` runs the same scripts of leases, releases and resizes, and
the two must agree on which leases were cold and on the pool's size, cold
starts, warm hits and reaps after every step, the shrink churn included: a
worker released above a shrink target retires, so the next lease above it
starts cold. ``tests/test_torch_process_parity.py`` does the same for a
query on the process backend.

Workers are spawned; a reference worker imports the JAX package and a
port worker ``torch``, so pools stay at two workers and the port computes
on the CPU (``device="cpu"``).
"""

import time

import pytest

import repro.runtime as jrt
from repro_torch.runtime import WorkerPool


def _churn(pool) -> list:
    """Warm reuse, a second cold worker, a shrink to one worker with a
    lease above it (cold, then retired on release) and a grow to two."""
    log, pids = [], {}

    def note(step, cold=None, w=None):
        who = None if w is None else pids.setdefault(w.pid, len(pids))
        log.append((step, cold, who, pool.size(), pool.cold_starts,
                    pool.warm_hits, pool.reaped))

    w1, cold = pool.lease()
    note("lease", cold, w1)
    pool.release(w1, busy_s=0.0)
    note("release")
    a, cold = pool.lease()
    note("lease", cold, a)
    b, cold = pool.lease()
    note("lease", cold, b)
    pool.release(a, busy_s=0.0)
    pool.release(b, busy_s=0.0)
    note("release")
    note(("resize", 1, pool.resize(1)))
    a, cold = pool.lease()
    note("lease", cold, a)
    b, cold = pool.lease()
    note("lease", cold, b)
    pool.release(a, busy_s=0.0)      # above the target: retired
    note("release")
    pool.release(b, busy_s=0.0)
    note("release")
    c, cold = pool.lease()
    note("lease", cold, c)
    pool.release(c, busy_s=0.0)
    note(("resize", 2, pool.resize(2)))
    return log


def _reap(pool) -> list:
    """The provision floor and idle reaping."""
    log = []
    w, cold = pool.lease()
    first = w.pid
    pool.release(w, busy_s=0.25)
    log.append((cold, pool.size(), pool.provision_seconds >= 0.3))
    time.sleep(0.35)
    w, cold = pool.lease()
    log.append((cold, w.pid != first, pool.reaped, pool.cold_starts,
                pool.warm_hits))
    pool.release(w, busy_s=0.25)
    log.append((pool.size(),
                pool.cost_function_seconds() >= 0.5 + 0.6 - 1e-6))
    return log


SCRIPTS = {"churn": (_churn, dict(max_workers=2)),
           "reap": (_reap, dict(max_workers=2, provision_s=0.3,
                                idle_reap_s=0.2))}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_pool_script_matches_reference(script):
    run, kw = SCRIPTS[script]
    logs = []
    for pool in (WorkerPool(device="cpu", **kw), jrt.WorkerPool(**kw)):
        try:
            logs.append(run(pool))
        finally:
            pool.shutdown()
    got, want = logs
    assert got == want
    if script == "churn":
        # cold: the first lease, the second of two held at once and the
        # one above the shrink target; every other lease finds a warm
        # worker, and the grow starts a fourth
        assert [e[1] for e in got if e[0] == "lease"] == \
            [True, False, True, False, True, False]
        assert got[-1][3:5] == (2, 4)
