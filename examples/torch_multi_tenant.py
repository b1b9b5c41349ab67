"""Fine-grained resource sharing (paper Fig. 8) through the PyTorch port
(the twin of ``examples/multi_tenant.py``); the real queries run on the
card unless ``--device cpu`` is given.

Part 1 simulates a high-priority analytics query co-running with
low-priority background function chains: the GlobalController arbitrates
by priority and background work backfills the shuffle troughs. Part 2 runs
two real queries concurrently on one serverless runtime, sharing its
function slots, shuffle store and controller. Part 3 drives a six-query
mix through the ``QueryScheduler``: FIFO head-of-line blocking against
weighted fair-share slot rationing, with a store quota on one tenant.

Part 1's bound (background costs the query at most 1.25x) is the
reference's; the port's operators are faster, and there the bound fails
(ROADMAP Queue 3), so the example checks it last and exits non-zero.

    PYTHONPATH=src python examples/torch_multi_tenant.py [--device cpu]
"""

import argparse
import threading

import numpy as np

from repro_torch.analytics import (
    QueryStrategy,
    SimTask,
    execute_query_runtime,
    make_cluster,
    plan_query_tasks,
)
from repro_torch.analytics.query import synth_query_tables
from repro_torch.analytics.table import phantom
from repro_torch.core.controllers import GlobalController, PrivateController
from repro_torch.device import resolve_device
from repro_torch.obs import critical_path, get_tracer
from repro_torch.runtime import QueryJob, QueryScheduler, Runtime

GB = 1 << 30
STRATEGIES = ("static_hash", "dynamic", "static_merge")


def run(background: bool, device):
    gc, sim = make_cluster(6)
    query = PrivateController("query", gc, priority=10)
    fact = phantom("A", int(5.4 * GB), range(6))
    dim = phantom("B", int(0.3 * GB), range(2))
    plan_query_tasks(sim, query, fact, dim, QueryStrategy("dynamic"),
                     device=device)
    if background:
        for c in range(40):
            prev = None
            for i in range(6):
                name = f"bg/{c}/{i}"
                sim.submit(SimTask(name, "background", 0.2, priority=0,
                                   deps=(prev,) if prev else ()))
                prev = name
    out = sim.run()
    t_query = out["completion"]["query"]
    return t_query, out["allocation"].allocation_rate(0, t_query), gc


def run_two_queries_one_runtime(device):
    """Two tenants, one substrate: concurrent real execution."""
    gc = GlobalController({n: 4 for n in range(4)})
    runtime = Runtime(gc, invoker="threads", max_workers=8, device=device)

    def make_query(seed):
        return synth_query_tables(1 << 13, 1 << 8, keyspace=1 << 11,
                                  seed=seed, device=device)

    tenants = {"etl_hi": (10, "dynamic", make_query(11)),
               "adhoc_lo": (0, "static_hash", make_query(23))}
    results, errors = {}, []

    def worker(app, priority, strat, fd, dd):
        try:
            got, _ = execute_query_runtime(
                fd, dd, QueryStrategy(strat), runtime=runtime, app=app,
                priority=priority)
            results[app] = got
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((app, e))

    threads = [threading.Thread(target=worker, args=(app, prio, strat, fd, dd))
               for app, (prio, strat, (fd, dd, _)) in tenants.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors

    print("\ntwo concurrent queries on one runtime "
          "(shared slots, store, controller):")
    for app, (prio, strat, (_, _, ref)) in tenants.items():
        err = np.abs(results[app] - ref).max()
        print(f"  {app:9s} prio {prio:2d} [{strat:12s}] "
              f"max err vs oracle {err:.2e}")
        assert err < 1e-3, app
    print(runtime.metrics.format_table("etl_hi"))
    preempted = sum(r.status == "preempted" for r in runtime.metrics.records)
    print(f"  shuffle store cross-node bytes: "
          f"{runtime.store.cross_node_bytes}; preempted invocations "
          f"retried: {preempted}")


def run_scheduled_mix(device):
    """Part 3: a mixed workload under FIFO vs weighted fair-share."""
    queries = [synth_query_tables(1 << 15, 1 << 9, keyspace=1 << 12,
                                  seed=100 + 7 * i, device=device)
               for i in range(6)]
    # warm every operator once so the policy comparison measures
    # scheduling, not which policy paid the first launches
    for i, (fd, dd, _) in enumerate(queries):
        execute_query_runtime(
            fd, dd, QueryStrategy(STRATEGIES[i % 3]),
            gc=GlobalController({n: 4 for n in range(4)}), app=f"warm{i}",
            device=device)
    print("\nsix-query mix through the QueryScheduler "
          "(lo,hi alternating arrivals):")
    for policy in ("fifo", "fair_share"):
        get_tracer().clear()      # trace exactly this policy's mix
        # 2 slots/node + disaggregated store (5 MB/s): function slots are
        # the contended resource, which is what the policies ration
        gc = GlobalController({n: 2 for n in range(4)})
        runtime = Runtime(gc, invoker="threads", max_workers=8,
                          net_bw=5e6, disaggregated=True, device=device)
        sched = QueryScheduler(runtime, policy=policy)
        for i, (fd, dd, _) in enumerate(queries):
            sched.submit(QueryJob(
                f"q{i}", fd, dd, STRATEGIES[i % 3],
                priority=10 if i % 2 else 0,
                quota=64 << 20 if i == 0 else None))
        results = sched.run()
        for i, (_, _, ref) in enumerate(queries):
            res = results[f"q{i}"]
            assert res.ok, res.error
            assert np.abs(res.sums - ref).max() < 1e-3, f"q{i}"
        hi = sched.latencies(min_priority=10)
        print(f"  {policy:10s} makespan {sched.makespan():6.2f}s  "
              f"hi-prio latency p50 {hi[len(hi) // 2]:5.2f}s  "
              f"worst {hi[-1]:5.2f}s")
        # where did q0's makespan go under this policy? (compute vs store
        # transfer vs slot/admission waits)
        cp = critical_path(get_tracer().spans(), app="q0")
        if cp is not None:
            b = cp.breakdown
            print(f"  {'':10s} q0 critical path: dominant {cp.dominant} "
                  f"(compute {b['compute']:.2f}s store {b['store']:.2f}s "
                  f"slot_wait {b['slot_wait']:.2f}s queue {b['queue']:.2f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    t_solo, alloc_solo, _ = run(False, device)
    t_shared, alloc_shared, gc = run(True, device)
    print(f"query solo:            {t_solo:6.2f}s  allocation "
          f"{alloc_solo:5.1%}")
    print(f"query + background:    {t_shared:6.2f}s  allocation "
          f"{alloc_shared:5.1%}")
    print(f"allocation gain: +{(alloc_shared - alloc_solo):.1%}  "
          f"query slowdown: {t_shared / t_solo:.2f}x")
    print(f"priority preemptions recorded by the controller: "
          f"{len(gc.preemptions)}")
    run_two_queries_one_runtime(device)
    run_scheduled_mix(device)
    # the reference's bound on part 1, checked after parts 2 and 3 have run:
    # it holds at the reference's operator rates (a ~4 s query), not at the
    # port's, where the query takes ~1.5 s and waits behind the 0.2 s
    # background tasks at its stage boundaries (the simulator starts a task
    # only on a free slot, so nothing is preempted): both packages'
    # simulators give 1.28x at the port's CPU rates
    assert t_shared <= t_solo * 1.25, \
        f"background must not hurt the query: {t_shared / t_solo:.2f}x"


if __name__ == "__main__":
    main()
