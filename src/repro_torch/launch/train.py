"""End-to-end training driver (the port of ``repro/launch/train.py``), on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 200 --batch 8 --seq 128 --ckpt $TMPDIR/repro_torch_run

Runs the full stack: config -> decision workflow (strategy/scale/schedule)
-> the train step under the decision's rules -> data pipeline ->
supervisor (checkpoint/restart, straggler watchdog). ``--smoke`` (the
default) trains the architecture's reduced config, ``--full`` its
published one; weights are random from seed 0, batches
``SyntheticSource(seed=1)``'s. ``--resume`` restarts from the newest
checkpoint under ``--ckpt``: the resumed run's parameters, optimizer state
and losses are bit-equal to an uninterrupted run's, since ``batch_fn(step)``
hands out step ``step``'s batch whatever the prefetcher had read ahead.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.ckpt import Supervisor, latest_step, load_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.config import OptimizerConfig, ShapeConfig
from repro_torch.core.decisions import DecisionContext
from repro_torch.data import Prefetcher, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import init_lm
from repro_torch.models.convert import shard_params
from repro_torch.parallel.sharding import use_rules
from repro_torch.parallel.strategies import make_rules, strategy_node
from repro_torch.parallel.tensor import tensor_plan
from repro_torch.training import init_train_state, make_train_step


class StepFeed:
    """``batch_fn`` of the supervisor: ``__call__(step)`` returns step
    ``step``'s batch from a ``Prefetcher`` over ``source``, restarting the
    prefetcher at ``step`` when it has read past it (after a restore) or
    not reached it. ``step`` is the step last handed out."""

    def __init__(self, source, start_step: int = 0):
        self.source = source
        self.prefetch = Prefetcher(source, start_step=start_step)
        self.step = start_step

    def __call__(self, step: int) -> dict:
        got, batch = self.prefetch.next()
        if got != step:
            self.prefetch.close()
            self.prefetch = Prefetcher(self.source, start_step=step)
            got, batch = self.prefetch.next()
        self.step = step
        return batch

    def close(self):
        self.prefetch.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir())
                                          / "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    mesh = make_smoke_mesh()

    # control plane: resolve the decision tuple for this cell
    node = strategy_node(cfg, shape, mesh)
    decision = node.decide(DecisionContext())
    pc = decision.extra("parallel_config")
    if args.microbatches > 1:
        pc = dataclasses.replace(pc, microbatches=args.microbatches)
    rules = make_rules(mesh, cfg, shape, pc)
    print(f"[train] {cfg.name} decision: {decision.func} "
          f"scale={pc.microbatches} schedule={decision.schedule.policy} "
          f"device={device}")

    opt_cfg = OptimizerConfig(warmup_steps=10)
    with use_rules(rules):
        model = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
        if tensor_plan(rules) is not None:
            model = shard_params(model, rules)
        state = init_train_state(cfg, model)
        start = 0
        if args.resume and latest_step(args.ckpt) is not None:
            state, extra = load_checkpoint(args.ckpt, like=state)
            start = extra.get("step", 0)
            print(f"[train] resumed from step {start}")

        step_fn = make_train_step(cfg, shape, opt_cfg, pc,
                                  total_steps=args.steps,
                                  q_chunk=min(args.seq, 512),
                                  ssm_chunk=min(args.seq, 64))
        feed = StepFeed(SyntheticSource(cfg, shape, seed=1), start)
        losses = []
        clock = {"t": time.time()}

        def logging_step(st, batch):
            st, metrics = step_fn(st, batch)
            step = feed.step + 1
            if step % args.log_every == 0:
                loss = float(metrics["loss"])
                losses.append(loss)
                tput = shape.tokens_per_step * args.log_every \
                    / max(time.time() - clock["t"], 1e-9)
                clock["t"] = time.time()
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"grad_norm {float(metrics['grad_norm']):7.3f} "
                      f"tok/s {tput:,.0f}")
            return st, metrics

        sup = Supervisor(logging_step, feed, args.ckpt,
                         ckpt_every=args.ckpt_every, rules=rules)
        t0 = time.time()
        try:
            state, final = sup.run(state, args.steps, start_step=start)
        finally:
            feed.close()
        wall = time.time() - t0
        print(f"[train] finished at step {final} in {wall:.1f}s; "
              f"restarts={sup.restarts} stragglers={len(sup.stragglers)}")
        if len(losses) >= 2:
            print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                  f"({'improved' if losses[-1] < losses[0] else 'flat'})")
    return losses


if __name__ == "__main__":
    main()
