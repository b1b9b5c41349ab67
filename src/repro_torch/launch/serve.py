"""Serve from the command line: batched request serving with the adaptive
batching decision node, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 16 --max-new 8

Serves the architecture's smoke config with random weights (seed 0), as
the reference's ``launch/serve.py`` does. The engine feeds token ids only,
so the two stub-frontend architectures (internvl2, musicgen) are not
offered.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.config import Frontend
from repro_torch.device import resolve_device
from repro_torch.models import init_lm
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    servable = [a for a in ARCH_IDS
                if get_config(a).frontend == Frontend.TOKENS.value]
    ap.add_argument("--arch", default="llama3.2-3b", choices=servable)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--slo-ms", type=float, default=500.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = init_lm(cfg, device=device)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch,
                           max_seq=args.max_seq, slo_ms=args.slo_ms,
                           device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              rng.integers(4, 24)).tolist()
        engine.submit(Request(i, prompt, max_new_tokens=args.max_new))
    done = engine.run(max_steps=4096)
    wall = time.time() - t0

    occ = np.mean(engine.metrics["batch_occupancy"]) \
        if engine.metrics["batch_occupancy"] else 0.0
    print(f"[serve] {cfg.name} on {device}: {len(done)}/{args.requests} "
          f"requests, {engine.metrics['generated']} tokens in {wall:.1f}s "
          f"({engine.metrics['generated'] / wall:.1f} tok/s)")
    print(f"[serve] decode steps {engine.metrics['steps']}, prefills "
          f"{engine.metrics['prefills']}, mean batch occupancy {occ:.2f}")
    return done


if __name__ == "__main__":
    main()
