"""Quickstart on the PyTorch port: the whole stack in one minute (the twin
of ``examples/quickstart.py``), on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Control plane: a decision workflow resolves strategy/scale/schedule.
2. Training: a few steps of a reduced llama3.2 config.
3. Serving: greedy-decode a few tokens through the batching engine.
4. Analytics: the paper's Fig. 6 join decision on a synthetic cluster.
"""

import argparse

import numpy as np
import torch

from repro_torch.analytics.decisions import join_decision
from repro_torch.configs import get_config
from repro_torch.core.config import OptimizerConfig, ShapeConfig
from repro_torch.core.controllers import GlobalController
from repro_torch.core.decisions import DataDist, DecisionContext
from repro_torch.data import SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import init_lm
from repro_torch.parallel.strategies import plan_cell
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("llama3.2-3b", smoke=True)
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=4,
                        mode="train")
    mesh = make_smoke_mesh()

    # 1. control plane --------------------------------------------------------
    pc = plan_cell(cfg, shape, mesh)
    print(f"[1] decision tuple: func=attn:{pc.attn_strategy} "
          f"scale={pc.microbatches} layout={pc.layout} "
          f"schedule={pc.pod_axis_role}")

    # 2. train a few steps ----------------------------------------------------
    model = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                    device)
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, shape, OptimizerConfig(lr=1e-3,
                                                       warmup_steps=0),
                           pc, q_chunk=32, ssm_chunk=16)
    src = SyntheticSource(cfg, shape, seed=0)
    losses = []
    for i in range(5):
        state, metrics = step(state, src.batch(i))
        losses.append(float(metrics["loss"]))
        print(f"[2] step {i} loss={losses[-1]:.4f}")

    # 3. serve ---------------------------------------------------------------
    engine = ServingEngine(cfg, state["params"], max_batch=2, max_seq=48,
                           device=device)
    for i in range(3):
        engine.submit(Request(i, list(np.random.default_rng(i).integers(
            0, cfg.vocab_size, 8)), max_new_tokens=4))
    done = engine.run()
    print(f"[3] served {len(done)} requests; outputs: "
          f"{[r.output for r in done]}")

    # 4. the paper's join decision --------------------------------------------
    gc = GlobalController({n: 8 for n in range(12)})
    ctx = DecisionContext(
        data_dist={"A": DataDist("A", {n: 400 * 2 ** 20 // 12
                                       for n in range(12)}),
                   "B": DataDist("B", {0: 10 * 2 ** 20})},
        node_status=gc.node_status())
    d = join_decision(ctx)
    print(f"[4] Fig.6 decision for 400MB JOIN 10MB on 12 nodes: "
          f"{d.func} x{d.scale} via {d.schedule.policy}")
    return {"losses": losses, "served": done, "join": d}


if __name__ == "__main__":
    main()
