"""The paper's case study end to end through the PyTorch port (the twin of
``examples/analytics_query.py``): the TPC-DS-like sub-query on the port's
tensor data plane, on the card unless ``--device cpu`` is given, AND
planned and simulated on a 6-node cluster under all four strategies.

    PYTHONPATH=src python examples/torch_analytics_query.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.analytics import (
    QueryStrategy,
    Table,
    make_cluster,
    plan_query_tasks,
    synth_table,
)
from repro_torch.analytics.query import (
    execute_query_torch,
    reference_query_numpy,
)
from repro_torch.analytics.table import phantom, to_numpy
from repro_torch.core.controllers import PrivateController
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # -- real data plane -------------------------------------------------------
    fact = synth_table("fact", 1 << 14, 1 << 12, seed=1, device=device)
    dim_cols = synth_table("dim", 1 << 10, 1 << 12, seed=2, unique_keys=True,
                           device=device)
    dim = Table({**dim_cols.columns,
                 "cat": torch.arange(1 << 10, dtype=torch.int32,
                                     device=device) % 64})
    ref = reference_query_numpy(fact, dim)
    for method in ("hash", "merge"):
        got = to_numpy(execute_query_torch(fact, dim, method=method))
        err = np.abs(got - ref).max()
        print(f"[data plane, {device}] {method}_join groupby-sum max err vs "
              f"numpy oracle: {err:.2e}")
        assert err < 1e-3, method

    # -- control plane: strategies on a 6-node cluster, 4 GB input ------------
    print(f"\n{'strategy':14s} {'completion':>11s} {'cost(slot-s)':>13s}")
    for strat in ("static_merge", "static_hash", "dynamic", "dynamic_fig6"):
        gc, sim = make_cluster(6)
        pc = PrivateController("query", gc, priority=10)
        f = phantom("A", int(3.6 * 2 ** 30), range(6))
        d = phantom("B", int(0.2 * 2 ** 30), range(2))
        plan_query_tasks(sim, pc, f, d, QueryStrategy(strat), device=device)
        out = sim.run()
        print(f"{strat:14s} {out['completion']['query']:10.2f}s "
              f"{out['cost_slot_seconds']['query']:13.1f}")


if __name__ == "__main__":
    main()
