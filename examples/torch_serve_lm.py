"""Serve a small model with batched requests and the adaptive batching
decision node (the paper's §7 ML-inference use case) on the PyTorch port
(the twin of ``examples/serve_lm.py``), on the card unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 12
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_lm
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("qwen1.5-4b", smoke=True)
    model = init_lm(cfg, device=device)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch,
                           max_seq=64, slo_ms=2000.0, device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        engine.submit(Request(i, rng.integers(
            0, cfg.vocab_size, rng.integers(4, 16)).tolist(),
            max_new_tokens=args.max_new))
    done = engine.run(max_steps=2048)
    wall = time.time() - t0
    occ = float(np.mean(engine.metrics["batch_occupancy"]))
    print(f"[serve_lm] {len(done)}/{args.requests} requests, "
          f"{engine.metrics['generated']} tokens in {wall:.1f}s, "
          f"occupancy {occ:.2f} on {device}")
    print(f"[serve_lm] sample continuation req0: {done[0].output}")
    assert len(done) == args.requests
    return done


if __name__ == "__main__":
    main()
