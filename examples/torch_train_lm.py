"""End-to-end training driver of the PyTorch port (the twin of
``examples/train_lm.py``): a ~100M-parameter llama-style model trained for
a few hundred steps with checkpoint/restart and an injected node failure,
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200

``--smoke`` trains a narrow twin of the same model (2 layers, d_model 64,
a 512-token vocabulary) for a quick check, at a learning rate of 3e-3:
at that width 3e-4 moves the loss by less than the batches' noise in
tens of steps. The failure is raised once at
half the steps; the supervisor restores the newest checkpoint it wrote
(the starting state's, before the first periodic one) and the batches
follow the restored step.
"""

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.ckpt import Supervisor
from repro_torch.configs import get_config
from repro_torch.core.config import OptimizerConfig, ShapeConfig
from repro_torch.data import SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.train import StepFeed
from repro_torch.models import init_lm
from repro_torch.parallel.sharding import use_rules
from repro_torch.parallel.strategies import make_rules, plan_cell
from repro_torch.training import init_train_state, make_train_step


def hundred_m_config(smoke: bool = False):
    """~100M params: 12L, d=512, 8H, d_ff=2048, 32k vocab (``smoke``: 2L,
    d=64, 4H, d_ff=256, 512 vocab)."""
    base = get_config("llama3.2-3b", smoke=True)
    if smoke:
        return dataclasses.replace(
            base, name="llama-100m-smoke", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256,
            vocab_size=512, tie_embeddings=False)
    return dataclasses.replace(
        base, name="llama-100m", num_layers=12, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        tie_embeddings=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir())
                                          / "repro_torch_100m_ckpt"))
    ap.add_argument("--inject-failure", action="store_true", default=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = hundred_m_config(args.smoke)
    print(f"[train_lm] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
          f"on {device}")
    shape = ShapeConfig("train100m", args.seq, args.batch, "train")
    mesh = make_smoke_mesh()
    pc = plan_cell(cfg, shape, mesh)
    rules = make_rules(mesh, cfg, shape, pc)

    with use_rules(rules):
        model = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
        state = init_train_state(cfg, model)
        lr = 3e-3 if args.smoke else 3e-4
        step_fn = make_train_step(
            cfg, shape, OptimizerConfig(lr=lr, warmup_steps=20), pc,
            total_steps=args.steps, q_chunk=min(256, args.seq),
            ssm_chunk=64)
        feed = StepFeed(SyntheticSource(cfg, shape, seed=7))

        log = {"losses": [], "t": time.time()}

        def wrapped(st, batch):
            st, m = step_fn(st, batch)
            log["losses"].append(float(m["loss"]))
            n = len(log["losses"])
            if n % 20 == 0:
                dt = time.time() - log["t"]
                log["t"] = time.time()
                tput = 20 * shape.tokens_per_step / dt
                print(f"[train_lm] step {n:4d} loss "
                      f"{log['losses'][-1]:7.4f} ({tput:,.0f} tok/s)")
            return st, m

        failures = {"armed": args.inject_failure}

        def fault(step):
            if failures["armed"] and step == args.steps // 2:
                failures["armed"] = False
                print("[train_lm] >>> injecting simulated node failure <<<")
                raise RuntimeError("node lost")

        sup = Supervisor(wrapped, feed, args.ckpt,
                         ckpt_every=25, rules=rules)
        try:
            state, final = sup.run(state, args.steps, fault_hook=fault)
        finally:
            feed.close()
        print(f"[train_lm] done at step {final}; restarts={sup.restarts}; "
              f"loss {log['losses'][0]:.4f} -> {log['losses'][-1]:.4f}")
        assert log["losses"][-1] < log["losses"][0], "loss must descend"
    return log["losses"], sup


if __name__ == "__main__":
    main()
