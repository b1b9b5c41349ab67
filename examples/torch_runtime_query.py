"""The TPC-DS-like sub-query executed for real on the serverless runtime of
the PyTorch port (the twin of ``examples/runtime_query.py``), on the card
unless ``--device cpu`` is given.

One decision workflow per query (scan → join → exchange → aggregate) drives
actual partitioned function invocations through the dependency-driven DAG
executor; when the fact scan lands, the planner folds the observed
post-filter distribution back into the workflow and late-binds the rest.
The invocation trace is then replayed into ``ClusterSim``, and the span
DAG's critical path and the decision audit log are printed.

    PYTHONPATH=src python examples/torch_runtime_query.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.analytics import (
    QueryStrategy,
    Table,
    build_query_workflow,
    calibrated_rates,
    distribute,
    execute_query_runtime,
    make_cluster,
    synth_table,
)
from repro_torch.analytics.query import reference_query_numpy
from repro_torch.device import resolve_device
from repro_torch.obs import critical_path, get_audit_log, get_tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    rows, dim_rows, keyspace = 1 << 15, 1 << 10, 1 << 12
    fact = synth_table("fact", rows, keyspace, seed=1, device=device)
    dimc = synth_table("dim", dim_rows, keyspace, seed=2, unique_keys=True,
                       device=device)
    dim = Table({**dimc.columns,
                 "cat": torch.arange(dim_rows, dtype=torch.int32,
                                     device=device) % 64})
    ref = reference_query_numpy(fact, dim)
    # the cost-model join decision prices plans with rates measured here
    rates = calibrated_rates(device=device)

    fact_dist = distribute(fact, range(6), "A")
    dim_dist = distribute(dim, range(2), "B")

    for strat in ("static_hash", "static_merge", "dynamic"):
        wf = build_query_workflow(QueryStrategy(strat))
        got, runtime = execute_query_runtime(
            fact_dist, dim_dist, QueryStrategy(strat), workflow=wf,
            invoker="threads", device=device)
        err = np.abs(got - ref).max()
        print(f"\n=== strategy {strat} on {device}: group-sum max err vs "
              f"numpy oracle {err:.2e} ===")
        assert err < 1e-3, strat
        run = wf.last_run
        print("decision sequence (bound in order, join late-bound on the "
              "observed post-filter scan output):")
        for name, d in run.sequence:
            print(f"  {name:10s} -> func={d.func:12s} scale={d.scale:3d} "
                  f"schedule={d.schedule.policy}")
        scanned = run.ctx.data_dist.get("A_scanned")
        print(f"observed post-filter fact side: {scanned.size} bytes over "
              f"{len(scanned.loc)} nodes (raw input {fact_dist.nbytes})")
        print(runtime.metrics.format_table("query"))
        store = runtime.store
        print(f"shuffle store: {store.cross_node_bytes} cross-node bytes, "
              f"{sum(store.written_bytes.values())} written, "
              f"{sum(store.resident_bytes.values())} still resident")

        # one plan, two data planes: replay the trace into the simulator
        _, sim = make_cluster(6)
        n = runtime.replay_into(sim, rates=rates)
        out = sim.run()
        print(f"trace replay: {n} invocations -> simulated completion "
              f"{out['completion']['query'] * 1e3:.2f} ms")

        # the span DAG's critical path and the audit log's record of every
        # decision binding (diffable against run.sequence above)
        cp = critical_path(get_tracer().spans(), app="query")
        if cp is not None:
            print(cp.format())
        audited = get_audit_log().sequence("query",
                                           nodes=[s for s, _ in run.sequence])
        same = audited == [(s, d.func) for s, d in run.sequence]
        print(f"audit log: {audited} {'==' if same else '!='} run.sequence")
        get_tracer().clear()      # fresh trace and audit buffers per strategy
        get_audit_log().clear()


if __name__ == "__main__":
    main()
