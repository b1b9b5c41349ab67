"""Times the port's MoE combine and its whole MoE layer on one CUDA card.

For granite-moe-1b-a400m and moonshot-v1-16b-a3b at their published
widths (bf16, weights from seed 0), one MoE layer with no plan:

- ``combine``: ``models.moe._combine`` on a chunk's expert outputs, the
  step that puts each token's ``top_k`` expert outputs back together;
- ``layer``: ``models.moe.moe_parts``, router, dispatch (K2), experts and
  combine;

at two decode shapes (4 and 32 rows of one token) and one prefill wave
(4 rows of 1,024). Each time is the median over ``--iters`` calls of
the host clock around one call ended by ``torch.cuda.synchronize()``:
what a decode step waits for.

The port is imported from ``PYTHONPATH``, so one call can time several
trees of it on one card::

    for t in parent change; do
        PYTHONPATH=$t/src python tools/time_moe_combine.py --tag $t
    done

Prints one JSON object a line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
SHAPES = ((4, 1), (32, 1), (4, 1024))


def _median_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_arch(arch: str, iters: int) -> list[dict]:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    m = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = M.MoE(cfg, gen, "cuda")
    w = {k: getattr(p, k) for k in ("router", "gate", "up", "down")}
    out = []
    with torch.no_grad():
        for b, s in SHAPES:
            x = torch.randn((b, s, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            _, top_p, top_i = M.route(p, x, m.top_k)
            cap = M.capacity(s, m)
            bk = M.dispatch(top_i, m.num_experts, cap)
            buf = M._expert_ffn(w, M._scatter(x, bk, cap, 0, m.num_experts,
                                              m.num_experts))
            out.append({
                "arch": arch, "rows": b, "seq": s, "top_k": m.top_k,
                "combine_ms": _median_ms(lambda: M._combine(
                    buf, bk, top_p, s, 0, m.num_experts), iters),
                "layer_ms": _median_ms(lambda: M.moe_parts(p, x, cfg),
                                       iters)})
    del p, w
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="", help="names the tree in the output")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    for arch in ARCHS:
        for row in time_arch(arch, args.iters):
            print(json.dumps({"tag": args.tag, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
