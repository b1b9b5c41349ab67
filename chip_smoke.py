#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, one process per source, all started together) and prints the
   build seconds, each library's count of tensor-core instructions
   (``HMMA``/``HGMMA`` in ``cuobjdump -sass``, where the toolkit has it; K4's
   library must have some) and the card's name and power limit.
2. Runs the sub-query through ``execute_query_runtime`` at 2^17 fact rows
   (the workflow binds the ``fused`` plan, so K3 runs) and at 2^25 fact rows
   (403 MB, the paper's smallest table; the ``pipelined`` plan, K1 and K2
   under every shuffle write), checking each result against a vectorized
   numpy oracle and that the main path launched the kernels (the launch
   counters are set to 0 just before each query and read just after).
   Then ``sim_plane``, with the counters set to 0 just before it and read
   just after: it calibrates the simulator's six operator rates on the
   card, plans the 2^25-row tables through the large query's own workflow
   object on a 4-node ``ClusterSim`` (the skew feedback's sketch runs K1),
   requires the simulator's decision sequence to equal the runtime's and
   K1 to have launched, and replays the large query's invocation trace
   into a fresh cluster (simulated makespan beside the measured wall).
3. Serves 8 requests of 32 new tokens with ``llama3.2-3b`` at its published
   width and depth (28 layers, d_model 3072, vocab 128256, bf16, random
   weights from seed 0) through ``ServingEngine(max_batch=4,
   max_seq=1024)``: every prefill runs K4 (flash attention) and every
   decode step K5 (flash-decode, a split along the sequence and a combine)
   in each layer; every prefill must take K4's tensor-core route. Then
   feeds each finished
   sequence once through the full ``forward`` (K4) and holds its logits at
   every generated position to the logits the engine decoded there (K5).
   Serves the same requests once more on the same weights, warm: the
   yardstick for step 4's last run. Then serves the same 8 requests with
   ``granite-moe-1b-a400m`` at its published config (24 layers, d_model
   1024, 32 experts top-8, d_expert 512, vocab 49155, bf16, random weights
   from seed 0): K2 groups every MoE layer's expert assignments in every
   prefill and decode step (24 launches each), K4 on its tensor-core route
   in every prefill, K5 in every step. Its teacher-forced check holds each
   request at the generated positions below the first position that lost
   an assignment to the capacity in any layer, in its forward or in a
   prefill that held it (a decode step must lose none); at least one
   position must be held; the forward routes every token to the experts
   the engine chose for it (the router's top-k turns on bf16 rounding).
   Prints the drops.
4. Drives the worker plane and the scheduler, each with the kernel
   counters set to 0 just before it and read just after (after the serve
   phase, so that the phases before it run as they always have):
   ``process_query`` runs the large query again on its tables through the
   process worker plane (4 spawned workers, each with its own CUDA
   context), holds it to the oracle and requires the workers to have
   launched K1 and K2 (their counts come home with each task), printing
   the pool's cold starts, warm hits, function-seconds and peak size, the
   card's used memory and how the invocations' seconds split between the
   host, the workers' bodies and their waits on the host's store; ``scheduler_mix`` runs six 2^22-row queries
   (priorities 0, 0, 0, 0, 10, 10) through one ``QueryScheduler`` over one
   ``threads`` runtime under ``fifo``, ``priority`` and ``fair_share``,
   each result held to its oracle and no slot leaked, printing each
   policy's makespan and latencies. Then requires that no worker process
   outlived its invoker and serves the warm requests of step 3 again,
   printing tokens/s before and after these phases beside what is left
   running (threads, reserved card memory, processes on the card). Each
   phase prints its seconds.
5. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path launched it at so far and on edge cases: K1-K3
   bit-exact, K4 and K5 within the reference's kernel tolerances. Times
   kernel, plain version and the one PyTorch call computing the same
   function at the largest of those shapes (CUDA events around one call,
   median of 20, L2 warm), and the device time alone of the kernel and
   of that call (``torch.profiler``). Counts the device ops of one K1 call
   (must be 1), one K2 call (at most 2) and one K3 call (must be 1), times
   K2 once more with the range check that the path runs before it, and K3
   once more at N = 2^20 probe rows against 16 Ki build rows. Holds the
   MoE dispatch through K2 bit-exact against its plain version (the
   per-row stable argsort) at granite's prefill (32,768 assignments) and
   decode (32) shapes over 129 buckets, and one MoE layer's output through
   it within the bf16 tolerance of its output through the plain dispatch.
6. Re-runs the large query, and eight decode steps and one prefill wave of
   llama and granite, under ``torch.profiler`` (outside the counted runs)
   and prints their device-busy share and costliest device ops, and the
   query's device time in the partition kernels; then times granite's
   decode step with K2's range check and with it stubbed out (in turns,
   inside that measurement only). A profiler trace with no device event
   in it is taken again, up to three times, before the script fails.
   Then frees the served models and trains (``train_phase``), with the
   counters set to 0 just before each run and read just after:
   ``llama3.2-3b`` and ``granite-moe-1b-a400m`` at their published
   configs, not cut, random weights from seed 0, AdamW (lr 3e-4, no
   warmup, fp32 master weights), ``remat="block"``, on one fixed batch of
   4 x 1024 tokens from the port's ``SyntheticSource(seed=1)``: one
   untimed step whose gradients must all be finite and not all zero (every
   MoE router's among them), then 4 (llama) or 3 (granite) timed steps;
   every loss and norm finite and the loss falling; K4 twice an attention
   layer a step (forward and recompute) on its tensor-core route, K4b
   (its backward, reading the log-sum-exp K4 wrote) once on its
   tensor-core route, K2 twice a MoE layer. Prints step ms, tokens/s,
   peak memory and one profiled step (busy, idle share, top device ops,
   K4's and K4b's shares); for llama one step of two microbatches from a
   fresh state, its loss within 1e-2 of the first step's. Then holds the
   gradients of llama cut to 2 layers at full width in fp32 (1 x 256
   tokens) on the card against the CPU's (K4b's CUDA-core route), each
   leaf within 1e-3 relative, and K4b against its plain version (bf16
   within 2e-2, fp32 within 1e-4 of the gradient's largest magnitude,
   bit-equal run to run, on the route each shape names) at the train
   phases' shapes and on edges, timed with K4's log-sum-exp as the
   autograd backward calls it, beside its bound, the library's attention
   backward and the earlier CUDA-core design's time, at llama's,
   granite's, an fp32 and two ragged shapes. K4 is held with its
   log-sum-exp too: the output bit-equal to the call without it, each
   row's within 1e-4.
7. Profiles jamba and xlstm (the models of step 8, on the weights made
   from the same seed) the same way, outside the counted runs, with the
   shares of the Mamba scan, the Mamba decode step and the sLSTM loop,
   and holds jamba's MoE dispatch on K2 bit-exact at its prefill (8,192
   assignments) and decode (8) shapes over 65 buckets. Before step 8:
   every profiler trace taken after those phases came back empty.
8. The recurrent models and the stub frontends, after everything above,
   which runs as it always has; each model freed when its phase ends.
   ``serve_jamba_v0_1_52b_8l``: ``jamba-v0.1-52b`` at its published width
   (d_model 4096, 32 heads, 8 kv heads, 16 experts top-2 on every second
   layer, d_expert 14336, Mamba d_state 16, d_conv 4, expand 2, vocab
   65536, bf16), cut to one period of its block pattern (8 of 32 layers:
   32 are 103 GB of bf16 weights, one H100 holds 80 GB), random weights
   from seed 0, serves step 3's requests through the same engine, with the
   counters set to 0 just before and read just after: K4 once a wave (one
   attention layer, its tensor-core route), K5 once a step, K2 four times
   a wave and a step. ``serve_xlstm_1_3b``: ``xlstm-1.3b`` at its full
   config (48 layers, 7 mLSTM : 1 sLSTM, d_model 2048, 4 heads, vocab
   50304), the same requests; no K1-K5 launch. Each is held at the model
   level, not against the engine's tokens (the engine's padded prefill
   feeds a recurrent state its pad tokens, ROADMAP Queue 3): each
   request's prompt through ``prefill_step`` (its longest prefix that the
   mLSTM's prefill chunk of 256 takes, the rest teacher-forced), then its
   generated tokens teacher-forced through ``decode_step``, the logits at
   the 32 generated positions within ``LOGIT_TOL`` of one ``forward`` over
   the sequence (jamba drop-free and pinned to the routing its decode path
   chose), both on their weights cast to fp32: in bf16 each model's own
   forward moves by more than ``LOGIT_TOL`` between batch 1 and batch 2.
   Prints that bf16 rounding floor, whether the engine's tokens are the
   greedy continuation for one request (they are not expected to be), and
   jamba's drops. ``frontends``: ``internvl2-1b`` (256 stub patches) and
   ``musicgen-medium`` (frame embeddings) at their full configs, batch 2,
   one ``forward`` and one ``prefill_step`` each, the last position's
   logits within ``LOGIT_TOL`` of each other, K4 once a layer in each
   call. Then K2, K4 and K5 are held against their plain versions at the
   shapes these phases added.
9. Prints the ``kernels`` JSON line (K1-K5 and K4b), its launch counts summed over
   every phase above, then the seconds of each phase, the card line and,
   as its last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed. Needs a CUDA
device and the repository's ``src/`` beside this file; imports no JAX.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM peak outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
# each group sum is a float32 sum of ~10^4-10^5 products, accumulated in
# another order than the float64 oracle
QUERY_RTOL, QUERY_ATOL = 1e-4, 1e-2
NUM_GROUPS = 64
REPS = 20
# the serve phase: llama3.2-3b at full width and depth
SERVE_ARCH = "llama3.2-3b"
# the MoE serve phase: granite-moe-1b-a400m at its published config, its
# expert dispatch on K2 (same requests, batch and max_seq)
MOE_ARCH = "granite-moe-1b-a400m"
# the hybrid serve phase: jamba-v0.1-52b at its published width, cut to
# one period of its block pattern (8 of 32 layers: all 32 are 103 GB of
# bf16 weights, one H100 holds 80 GB), its experts dispatched on K2
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 8
# the recurrent serve phase: xlstm-1.3b (mLSTM and sLSTM, no attention) at
# its full config
XLSTM_ARCH = "xlstm-1.3b"
# the stub-frontend phase: each model at its full config, one forward and
# one prefill of FRONTEND_BATCH x FRONTEND_SEQ positions (internvl2's
# 256 patches among them)
FRONTEND_ARCHS = ("internvl2-1b", "musicgen-medium")
FRONTEND_BATCH, FRONTEND_SEQ = 2, 512
# (layers, d_model, heads, kv heads, head_dim, d_ff, vocab, dtype,
# (experts, top_k, d_expert) or None): the published configs
PUBLISHED = {
    SERVE_ARCH: (28, 3072, 24, 8, 128, 8192, 128256, "bfloat16", None),
    MOE_ARCH: (24, 1024, 16, 8, 64, 512, 49155, "bfloat16", (32, 8, 512)),
    # arXiv:2403.19887, ai21labs/Jamba-v0.1
    HYBRID_ARCH: (32, 4096, 32, 8, 128, 14336, 65536, "bfloat16",
                  (16, 2, 14336)),
    # src/repro/configs/xlstm_1_3b.py (arXiv:2405.04517)
    XLSTM_ARCH: (48, 2048, 4, 4, 512, 0, 50304, "bfloat16", None),
    "internvl2-1b": (24, 896, 14, 2, 64, 4864, 151655, "bfloat16", None),
    "musicgen-medium": (48, 1536, 24, 24, 64, 6144, 2048, "bfloat16", None),
}
# the rest of the recurrent and stub-frontend configs: block pattern,
# MoE every k-th layer, and the (d_state, d_conv, expand) of the Mamba
# blocks, the (sLSTM every, conv kernel, qk factor, up factor) of the xLSTM
# blocks, or the frontend and its patch count
PUBLISHED_REST = {
    HYBRID_ARCH: (("mamba",) * 3 + ("attention",) + ("mamba",) * 4, 2,
                  (16, 4, 2)),
    XLSTM_ARCH: (("mlstm",) * 7 + ("slstm",), None, (8, 4, 0.5, 2.0)),
    "internvl2-1b": (("attention",), None, ("vision", 256)),
    "musicgen-medium": (("attention",), None, ("audio", 256)),
}
# the reference's mLSTM chunk in prefill (``prefill_step`` passes it no
# chunk): a prefill's length must be under it or a multiple of it
MLSTM_PREFILL_CHUNK = 256
SERVE_REQUESTS, SERVE_NEW_TOKENS = 8, 32
SERVE_BATCH, SERVE_SEQ = 4, 1024
PROMPT_LENGTHS = (64, 512)
PROFILE_STEPS = 8
# K4/K5 against their plain versions: the reference's kernel tolerances
# (tests/test_kernels.py:15)
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# teacher-forced forward (K4) vs the engine's decode logits (K5), bf16
# model. The two paths round the bf16 residual stream differently (other
# GEMM shapes, K4 vs K5); on an H100 the |diff| over the 3.3e7 logits of the
# serve phase had rms 0.016 and max 0.098, about the 5.7 sigma expected of
# that many draws. 0.15 is ~9 sigma: room for other GEMM kernels, while a
# wrong position, mask or cache slot moves logits of spread ~1 by O(1).
LOGIT_TOL = 0.15
# the train phases: each model at its published config, not cut, on one
# fixed batch of TRAIN_BATCH x TRAIN_SEQ tokens, AdamW at TRAIN_LR
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 1024, 3e-4
TRAIN_STEPS = {SERVE_ARCH: 4, MOE_ARCH: 3}
# two microbatches against one batch: the same mean over equal token
# counts, in another order of bf16 sums
MB_LOSS_RTOL = 1e-2
# the full-width gradient hold: llama cut to 2 layers, fp32, 1 x 256
# tokens, card against CPU (both fp32; sums in other orders)
GRAD_HOLD_LAYERS, GRAD_HOLD_SEQ, GRAD_HOLD_TOL = 2, 256, 1e-3
# K4b against its plain version: max |err| over the plain gradient's
# largest magnitude (bf16 outputs round to 2^-8 of it; fp32 sums differ in
# order only)
K4B_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
# K4b's device kernels (csrc/flash_attention_bwd.cu): the delta pass, then
# dK, dV and dQ on the tensor-core route or on the CUDA-core one
K4B_KERNELS = ("delta_kernel", "dkdv_tc_kernel", "dq_tc_kernel",
               "dkdv_kernel", "dq_kernel")
# K4b's device ms a call at llama's training shape on its earlier design,
# three CUDA-core launches in fp32 (H100 80GB HBM3 at 700 W; PERF.md §6),
# printed beside the new
K4B_EARLIER_MS = 5.29
# K4's log-sum-exp against the plain one: fp32 both, sums in another order
# and exp2 / log2 on the card (values near log S)
LSE_TOL = 1e-4
# names of K1-K3's device kernels (csrc/partition.cu)
PARTITION_KERNELS = ("hist_kernel", "scatter_kernel", "fused_probe_kernel")
# empty device traces taken again before a measurement gives up (``traced``)
PROFILE_TRIES = 3
# the process phase: smoke_large's query on this many worker processes
PROCESS_WORKERS = 4
# the scheduler phase: six queries sharing one runtime, two of them urgent
MIX_QUERIES, MIX_ROWS, MIX_DIM_ROWS = 6, 1 << 22, 1 << 19
MIX_PRIORITIES = (0, 0, 0, 0, 10, 10)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def traced(body, setup=None):
    """``body(setup())`` under ``torch.profiler`` (the card's activity and
    the host's), ``setup`` running untraced before it and both ending in a
    synchronize; returns ``(profile, body's result)``. A trace that holds
    no device event at all is taken again, up to ``PROFILE_TRIES`` times:
    the profiler has been seen to hand back an empty device trace of work
    that did run on the card, and an empty trace must not pass for a call
    that launched nothing. Every trace records both activities: traces of
    the card alone, taken after traces of both, came back empty three times
    running on an H100."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA, ProfilerActivity.CPU]
    for attempt in range(1, PROFILE_TRIES + 1):
        state = setup() if setup is not None else None
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            out = body(state)
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof, out
        print(f"profiler: no device event in the trace (try {attempt} of "
              f"{PROFILE_TRIES})")
    raise AssertionError(f"the profiler traced no device event in "
                         f"{PROFILE_TRIES} tries")


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn``: the union of the device-side
    intervals of ``reps`` calls under ``torch.profiler``, over ``reps``.
    Unlike ``median_ms`` it leaves out the host's share of a call (the
    wrapper's Python and the launch), which dominates a call of a few
    microseconds of device work."""
    prof, _ = traced(lambda _: [fn() for _i in range(reps)], setup=fn)
    return device_busy(prof)[0] / 1e3 / reps


def device_ms_by_kernel(fn, reps: int = REPS) -> tuple[float, dict]:
    """``device_ms(fn)`` and, from the same trace, each device kernel's ms
    a call (by name, cut to 40 characters)."""
    from torch.autograd import DeviceType
    prof, _ = traced(lambda _: [fn() for _i in range(reps)], setup=fn)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.key[:40]] = e.self_device_time_total / 1e3 / reps
    return device_busy(prof)[0] / 1e3 / reps, by_kernel


def device_kernels(fn) -> list[tuple[str, float]]:
    """``(name, microseconds)`` of each device kernel (or copy, or fill)
    that one call of ``fn`` runs, after a warm-up call, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    prof, _ = traced(lambda _: fn(), setup=fn)
    return [(e.name[:40], e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def bound_ms(nbytes: float, ops: float = 0.0,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def tensor_core_instructions(libs: dict) -> dict:
    """``{source: {"HMMA": n, "HGMMA": n}}`` from ``cuobjdump -sass`` of each
    built library; empty where the toolkit has no ``cuobjdump``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    counts = {}
    for src, lib in libs.items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout.split()
        counts[src] = {op: sum(w.startswith(op + ".") or w == op
                               for w in sass) for op in ("HMMA", "HGMMA")}
    return counts


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def held_exact(got, want, what: str) -> float:
    """Require kernel outputs ``got`` to be bit-equal to the plain version's
    ``want`` (pairwise) and return the largest |got - want|, in float64."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape == b.shape and a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
        require(bits_equal(a, b), f"{what} (max |err| {err})")
    return err


# -- kernel checks --------------------------------------------------------------


def _largest(shapes) -> tuple:
    return max(shapes, key=lambda sh: (sh[0], sh[1:]))


def _refuses_bad_ids(dev, launch) -> None:
    """Ids outside [0, P) raise before any launch (the kernels would skip
    them where the plain versions order or reject them)."""
    import torch
    from repro_torch.kernels import partition as K
    for bad in (-1, 15):
        ids = torch.zeros((5000,), dtype=torch.int32, device=dev)
        ids[4321] = bad
        before = dict(K.LAUNCHES)
        try:
            launch(ids)
        except ValueError:
            require(K.LAUNCHES == before, "a refused call launched a kernel")
            continue
        raise AssertionError(f"partition id {bad} with P=15 was accepted")


def check_k1(dev, gen, main_shapes) -> dict:
    """K1 bit-exact at N = 2^23 (P = 512 and 15), on edges and at every
    shape the main path launched it at; timed at the largest of those."""
    import torch
    from repro_torch.kernels import partition as K, ref
    # edges: a ragged last tile, all rows in one bucket, fewer rows than a
    # tile, a two-bucket space
    cases = [(1 << 23, 512, None), (1 << 23, 15, None),
             ((1 << 23) + 777, 65, None), (1 << 23, 65, 64),
             (100, 512, None), (5000, 2, None)]
    cases += [(n, p, None) for n, p in sorted(main_shapes)]
    err = 0.0
    for n, p, fill in cases:
        ids = torch.full((n,), fill, dtype=torch.int32, device=dev) \
            if fill is not None else \
            torch.randint(0, p, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        err = max(err, held_exact(
            [K.partition_histogram(ids, p)],
            [ref.partition_histogram_ref(ids, p)],
            f"K1 differs from its plain version at N={n}, P={p}"))
    # a view one id in: not 16-byte aligned, N not a multiple of 4
    ids = torch.randint(0, 512, ((1 << 22) + 4,), generator=gen, device=dev,
                        dtype=torch.int32)[1:-2]
    err = max(err, held_exact(
        [K.partition_histogram(ids, 512)],
        [ref.partition_histogram_ref(ids, 512)],
        "K1 differs from its plain version on an unaligned view"))
    _refuses_bad_ids(dev, lambda ids: K.partition_histogram(ids, 15))
    n, p = _largest(main_shapes)
    ids = torch.randint(0, p, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    err = max(err, held_exact([K.partition_histogram(ids, p)],
                              [ref.partition_histogram_ref(ids, p)],
                              "K1 differs from its plain version (timed)"))
    ops = device_kernels(lambda: K.partition_histogram(ids, p, False))
    require(len(ops) == 1, f"a K1 call ran {len(ops)} device ops: "
            f"{ops}")
    b, by = bound_ms(n * 4 + p * 4)
    return {"name": "partition_histogram", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partition.cu",
            "replaces": "src/repro/kernels/partition.py:35",
            "max_abs_err": err,
            # timed as the sketch launches it, without the range check
            "ms": median_ms(lambda: K.partition_histogram(ids, p, False)),
            "plain_ms": median_ms(
                lambda: ref.partition_histogram_ref(ids, p)),
            "bound_ms": b, "bound_by": by,
            "library_ms": median_ms(
                lambda: torch.bincount(ids, minlength=p)),
            "device": {"ms": device_ms(
                lambda: K.partition_histogram(ids, p, False)),
                "library_ms": device_ms(
                    lambda: torch.bincount(ids, minlength=p))},
            "device_ops_per_call": ops,
            "shape": f"N={n} P={p}"}


def _grouping_input(dev, gen, n_real: int, n_pad: int, buckets: int):
    import torch
    ids = torch.randint(0, buckets - 1, (n_pad,), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[n_real:] = buckets - 1            # the padding sentinel
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)[:, None]
    return rows, ids


def hold_k2(dev, gen, n: int, p: int) -> float:
    """K2 bit-exact against its plain version at ``n`` padded rows (the
    last ``n // 97`` the padding sentinel) over ``p`` buckets; returns the
    max |err| (0)."""
    from repro_torch.kernels import partition as K, ref
    rows, ids = _grouping_input(dev, gen, n - n // 97, n, p)
    return held_exact(K.partition_scatter(rows, ids, p),
                      ref.partition_scatter_ref(rows, ids, p),
                      f"K2 differs from its plain version: n_pad={n}, "
                      f"P+1={p}")


def check_k2(dev, gen, main_shapes) -> dict:
    """K2 bit-exact at n_pad = 2^23 with P+1 = 15, on edges and at every
    main-path shape; timed at the largest main-path shape."""
    import torch
    from repro_torch.kernels import partition as K, ref

    errs = [0.0]

    def same(rows, ids, p, what):
        errs.append(held_exact(K.partition_scatter(rows, ids, p),
                               ref.partition_scatter_ref(rows, ids, p),
                               f"K2 differs from its plain version: {what}"))

    errs += [hold_k2(dev, gen, n, p)
             for n, p in [(1 << 23, 15)] + sorted(main_shapes)]
    # edges: a ragged last tile, all rows in one bucket, 3-wide float rows,
    # one bucket in all
    r2, i2 = _grouping_input(dev, gen, 3000, 3333, 65)
    same(r2, i2, 65, "ragged last tile")
    same(r2, torch.full_like(i2, 7), 65, "all rows in one bucket")
    wide = torch.randn((2053, 3), generator=gen, device=dev)
    same(wide, torch.randint(0, 9, (2053,), generator=gen, device=dev,
                             dtype=torch.int32), 9, "3-wide float rows")
    same(r2, torch.zeros_like(i2), 1, "one bucket")
    _refuses_bad_ids(dev, lambda ids: K.partition_scatter(ids[:, None], ids,
                                                          15))
    # tiles in several waves of CTAs and many chunks of the first launch,
    # with a ragged last tile; byte rows; rows too wide to stage in shared
    # memory
    r3, i3 = _grouping_input(dev, gen, 1 << 23, (1 << 23) + 777, 9)
    same(r3, i3, 9, "2^23 + 777 rows")
    same(torch.randint(0, 256, (3001, 3), generator=gen, device=dev
                       ).to(torch.uint8), i2[:3001], 65, "uint8 (n, 3)")
    same(torch.randn((3001, 250), generator=gen, device=dev), i2[:3001],
         65, "1000-byte rows")
    n, p = _largest(main_shapes)
    rows, ids = _grouping_input(dev, gen, n - n // 97, n, p)
    same(rows, ids, p, f"timed input n_pad={n}, P+1={p}")
    ops = device_kernels(lambda: K.partition_scatter(rows, ids, p, False))
    require(len(ops) <= 2, f"a K2 call ran {len(ops)} device ops: "
            f"{ops}")
    b, by = bound_ms(n * 4 + n * 4 + n * 4 + p * 4)
    return {"name": "partition_scatter", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partition.cu",
            "replaces": "src/repro/kernels/partition.py:136",
            "max_abs_err": max(errs),
            # the kernel alone: the range check's reduction and host sync
            # run once per shuffle write before it (not timed here)
            "ms": median_ms(lambda: K.partition_scatter(rows, ids, p, False)),
            "plain_ms": median_ms(
                lambda: ref.partition_scatter_ref(rows, ids, p)),
            "bound_ms": b, "bound_by": by,
            "library_ms": median_ms(
                lambda: torch.argsort(ids, stable=True)),
            "device": {"ms": device_ms(
                lambda: K.partition_scatter(rows, ids, p, False)),
                "library_ms": device_ms(
                    lambda: torch.argsort(ids, stable=True))},
            "device_ops_per_call": ops,
            # as grouping_indices calls it: with the range check's
            # reduction and host sync
            "checked_ms": median_ms(
                lambda: K.partition_scatter(rows, ids, p, True)),
            "shape": f"n_pad={n} P+1={p}"}


def check_moe_dispatch(dev, gen, res: dict) -> dict:
    """The MoE dispatch through K2 (``moe.dispatch``) bit-exact against
    its plain version (``moe.dispatch_plain``, the reference's per-row
    stable argsort) at the main path's shapes: a prefill wave's
    ``SERVE_BATCH * SERVE_SEQ * top_k`` assignments and a decode step's
    ``SERVE_BATCH * top_k``, over ``SERVE_BATCH * E + 1`` buckets, experts
    chosen by the served model's first MoE router from random inputs; and
    that layer's output through it within the bf16 tolerance of the
    reference's kernel tests (atol and rtol 2e-2) of its output through the
    plain dispatch. Both dispatches timed at each shape, call and device
    time."""
    import torch
    from repro_torch.models import moe
    cfg = res["cfg"]
    layer = next(lay.ffn for lay in res["model"].layers
                 if isinstance(getattr(lay, "ffn", None), moe.MoE))
    m = cfg.moe
    out = []
    for s in (SERVE_SEQ, 1):
        x = torch.randn((SERVE_BATCH, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        top_i = torch.topk(torch.softmax(x.float() @ layer.router, -1),
                           m.top_k, dim=-1).indices
        cap = moe.capacity(s, m)
        got = moe.dispatch(top_i, m.num_experts, cap)
        want = moe.dispatch_plain(top_i, cap)
        for name, a, b in zip(moe.Dispatch._fields, got, want):
            require(bits_equal(a, b), f"the MoE dispatch's {name} on K2 "
                    f"differs from its plain version at S={s}")
        y = moe.moe(layer, x, cfg)[0]
        dispatch = moe.dispatch
        moe.dispatch = lambda t, e, c: moe.dispatch_plain(t, c)
        try:
            y_plain = moe.moe(layer, x, cfg)[0]
        finally:
            moe.dispatch = dispatch
        err = (y.float() - y_plain.float()).abs()
        tol = ATTN_TOL["torch.bfloat16"]
        require(bool((err <= tol + tol * y_plain.float().abs()).all()),
                f"a MoE layer through K2 differs from it through the plain "
                f"dispatch at S={s}: max |err| {float(err.max())}")
        out.append({"assignments": SERVE_BATCH * s * m.top_k,
                    "buckets": SERVE_BATCH * m.num_experts + 1,
                    "capacity": cap, "dropped": int((~got.keep).sum()),
                    "layer_max_abs_err": float(err.max()),
                    "ms": median_ms(lambda: moe.dispatch(
                        top_i, m.num_experts, cap)),
                    "plain_ms": median_ms(lambda: moe.dispatch_plain(
                        top_i, cap)),
                    "device_ms": device_ms(lambda: moe.dispatch(
                        top_i, m.num_experts, cap)),
                    "plain_device_ms": device_ms(lambda: moe.dispatch_plain(
                        top_i, cap))})
    return {"shapes": out}


def range_check_cost(res: dict, dev, steps: int = PROFILE_STEPS,
                     pairs: int = 4) -> dict:
    """Decode ms per step of a full batch of the MoE model as it runs
    (K2's range check, an ``aminmax`` and a host read, in every MoE
    layer's dispatch) and with the check stubbed out inside this
    measurement only, in turns (on, off, off, on, ...: ``pairs`` of each),
    ``steps`` steps each after a prefill and a first step: what the
    check's host syncs cost a decode step."""
    import torch
    from repro_torch.kernels import partition as K
    from repro_torch.serving import Request, ServingEngine

    def step_ms() -> float:
        engine = ServingEngine(res["cfg"], res["model"],
                               max_batch=SERVE_BATCH, max_seq=SERVE_SEQ,
                               device=dev)
        for i, prompt in enumerate(res["prompts"][:SERVE_BATCH]):
            engine.submit(Request(i, prompt, max_new_tokens=steps + 1))
        engine.run(max_steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(max_steps=steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    checked = K._check_ids
    times = {"checked": [], "unchecked": []}
    for on in (True, False, False, True) * (pairs // 2):
        K._check_ids = checked if on else (lambda ids, p: None)
        try:
            times["checked" if on else "unchecked"].append(step_ms())
        finally:
            K._check_ids = checked
    return {"syncs_per_step": moe_layers(res["cfg"]),
            "ms_per_step": times}


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _colliding_keys(count: int, first: int = 0) -> np.ndarray:
    """``count`` distinct int32 keys whose multiply-shift hash under K3's
    multiplier has its top 16 bits set: K3's table (at most 2^16 slots) puts
    them all in its last slot, one chain that wraps at the table's end
    (``first`` skips that many keys)."""
    from repro_torch.kernels import partition as K
    inv = np.uint64(pow(K.FUSED_HASH_MULT, -1, 1 << 32))
    x = np.arange(count, dtype=np.uint64) + np.uint64(0xFFFF0000 + first)
    return ((x * inv) % np.uint64(1 << 32)).astype(np.uint32).view(np.int32)


def _probe_input(dev, gen, n: int, m: int, m_valid: int, zero_key: bool,
                 kind=None):
    """K3's inputs as the card tests make them (``probe_case`` in
    tests/test_torch_cuda.py), drawn on the card; ``kind`` as there."""
    import torch
    keys = torch.randperm(4 * m, generator=gen, device=dev)[:m_valid] + 1
    keys = keys.to(torch.int32)
    if zero_key:
        keys[0] = 0                       # a real build row with key 0
    if kind == "duplicates":
        keys[1::3] = keys[0::3][:len(keys[1::3])].clone()
        keys[2::9] = keys[0::9][:len(keys[2::9])].clone()
    elif kind == "extreme_keys":
        keys[:4] = torch.tensor((INT32_MIN, INT32_MAX, 0, -1), device=dev,
                                dtype=torch.int32)
    elif kind == "colliding":
        keys = torch.from_numpy(_colliding_keys(m_valid)).to(dev)
    bk = torch.zeros((m,), dtype=torch.int32, device=dev)
    bk[:m_valid] = keys                   # padding rows keep key 0
    if kind == "extreme_keys":
        bk[m_valid:] = INT32_MAX
    bc = torch.zeros_like(bk)
    bc[:m_valid] = torch.arange(m_valid, device=dev,
                                dtype=torch.int32) * 7 % 1000
    if kind == "duplicates":              # cats over all of int32: sums wrap
        bc[:m_valid] = torch.randint(INT32_MIN, INT32_MAX, (m_valid,),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
    elif kind == "negative_cats":
        bc[:m_valid] = -bc[:m_valid] - 1
        bc[0] = INT32_MIN
    bv = torch.zeros_like(bk)
    bv[:m_valid] = 0 if kind == "all_invalid" else 1
    # probe keys with duplicates, half of them hits, plenty of zeros
    pk = torch.randint(0, 8 * m, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    if kind == "colliding":               # misses that walk the whole chain
        misses = torch.from_numpy(_colliding_keys(min(n, 4096),
                                                  m_valid)).to(dev)
        pk = misses[torch.randint(0, len(misses), (n,), generator=gen,
                                  device=dev)]
    hit = torch.rand((n,), generator=gen, device=dev) < 0.5
    pick = torch.randint(0, m_valid, (n,), generator=gen, device=dev)
    pk = torch.where(hit, bk[pick], pk)
    pk[: n // 16] = 0
    if kind == "extreme_keys":
        pk[-8:] = torch.tensor((INT32_MIN, INT32_MAX, 0, -1, INT32_MIN + 1,
                                INT32_MAX - 1, 1, -2), device=dev,
                               dtype=torch.int32)
    v0 = torch.randn((n,), generator=gen, device=dev)
    v1 = torch.randn((n,), generator=gen, device=dev)
    return pk, v0, v1, bk, bc, bv


def check_k3(dev, gen, main_shapes) -> dict:
    """K3 bit-exact at N = 2^16, M = 8192, G = 64 (with padding rows whose
    key is 0, with and without a real key 0), on the edges of its contract
    (duplicate valid keys, negative cats, extreme keys, keys that collide
    under its hash, no valid row, M = 1, N = 1, G = 1 and 7, unaligned
    probe columns), at N = 2^20 with the largest build side the gate admits
    and at every main-path shape; timed at the largest main-path shape and,
    on a line of its own, at N = 2^20, M = 16 Ki."""
    import torch
    from repro_torch.kernels import partition as K, ref
    n0, m0, g0 = 1 << 16, 8192, NUM_GROUPS
    gate = K.FUSED_SMEM_ROWS
    cases = [(n0, m0, m0 - 500, False, g0, None),
             (n0, m0, m0 - 500, True, g0, None),
             (1000, 8, 5, False, g0, None),
             (4096, gate, gate - 3, True, g0, None),
             (n0, m0, m0 - 500, True, g0, "duplicates"),
             (n0, m0, m0 - 500, False, g0, "negative_cats"),
             (n0 + 3, m0, m0 - 500, False, g0, "extreme_keys"),
             (8192, 2048, 2000, False, g0, "colliding"),
             (4096, 1024, 1000, True, g0, "all_invalid"),
             (5000, 1, 1, True, g0, None),
             (1, m0, m0 - 500, False, g0, None),
             (n0, m0, m0 - 500, True, 1, None),
             (n0 + 1, m0, m0 - 500, True, 7, "negative_cats"),
             (1 << 20, gate, gate - 384, True, g0, None)]
    cases += [(n, m, m - m // 10, True, g, None)
              for n, m, g in sorted(main_shapes)]
    err = 0.0
    for n, m, mv, zero, g, kind in cases:
        args = _probe_input(dev, gen, n, m, mv, zero, kind)
        err = max(err, held_exact(
            K.fused_probe(*args, g), ref.fused_probe_ref(*args, g),
            f"K3 differs from its plain version at N={n}, M={m}, G={g}, "
            f"zero key {zero}, {kind or 'plain'} input"))
    # probe columns one element into their storage: the unaligned route
    args = _probe_input(dev, gen, n0 - 1, m0, m0 - 500, True)
    args = tuple(torch.cat([a[:1], a])[1:] for a in args[:3]) + args[3:]
    err = max(err, held_exact(K.fused_probe(*args, g0),
                              ref.fused_probe_ref(*args, g0),
                              "K3 differs from its plain version on "
                              "unaligned probe columns"))
    # the second timed shape: the most probe rows of the edges, at the gate
    n2, m2 = 1 << 20, gate
    args = _probe_input(dev, gen, n2, m2, m2 - m2 // 10, False)
    second = {"shape": f"N={n2} M={m2} G={g0}",
              "ms": median_ms(lambda: K.fused_probe(*args, g0)),
              "device_ms": device_ms(lambda: K.fused_probe(*args, g0)),
              "bound_ms": bound_ms(n2 * 12 + m2 * 12 + n2 * 8)[0]}
    n, m, g = _largest(main_shapes)
    args = _probe_input(dev, gen, n, m, m - m // 10, False)
    err = max(err, held_exact(K.fused_probe(*args, g),
                              ref.fused_probe_ref(*args, g),
                              "K3 differs from its plain version (timed)"))
    ops = device_kernels(lambda: K.fused_probe(*args, g))
    require(len(ops) == 1, f"a K3 call ran {len(ops)} device ops: {ops}")
    # bytes alone: a hash probe reads each probe and build column once and
    # writes group and weight, and needs none of the N*M compares of the
    # one-hot probe the TPU kernel does
    b, by = bound_ms(n * 12 + m * 12 + n * 8)
    return {"name": "fused_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partition.cu",
            "replaces": "src/repro/kernels/partition.py:75",
            "max_abs_err": err,
            "ms": median_ms(lambda: K.fused_probe(*args, g)),
            "plain_ms": median_ms(lambda: ref.fused_probe_ref(*args, g)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "device": {"ms": device_ms(lambda: K.fused_probe(*args, g)),
                       "library_ms": None},
            "device_ops_per_call": ops, "second": second,
            "shape": f"N={n} M={m} G={g}"}


def _dtype(name: str):
    import torch
    return {"torch.float32": torch.float32,
            "torch.bfloat16": torch.bfloat16}[name]


def _randn(gen, shape, dtype_name: str, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(_dtype(dtype_name))


def _held_close(got, want, dtype_name: str, what: str) -> float:
    err = float((got.float() - want.float()).abs().max())
    require(got.shape == want.shape and got.dtype == want.dtype
            and err <= ATTN_TOL[dtype_name],
            f"{what}: max |err| {err} > {ATTN_TOL[dtype_name]}")
    return err


def hold_k4(dev, gen, shape) -> float:
    """K4 at ``shape`` ``(B, S, H, K, hd, dtype, causal, route)`` within
    its tolerance of its plain version, on the route named; returns the
    max |err|."""
    from repro_torch.kernels import attention as A, ref
    b, s, h, kh, hd, dt, causal, route = shape
    q = _randn(gen, (b, s, h, hd), dt, dev)
    k, v = (_randn(gen, (b, s, kh, hd), dt, dev) for _ in range(2))
    A.SHAPES["flash_attention"].clear()
    out = A.flash_attention(q, k, v, causal)
    err = _held_close(
        out, ref.flash_attention_ref(q, k, v, causal), dt,
        f"K4 differs from its plain version at B={b} S={s} H={h} K={kh}"
        f" hd={hd} {dt} causal={causal}")
    # the training forward's call: the same output, and each row's lse
    out2, lse = A.flash_attention_with_lse(q, k, v, causal)
    lse_err = float((lse - ref.flash_attention_lse_ref(q, k, v, causal))
                    .abs().max())
    require(bits_equal(out, out2) and lse_err <= LSE_TOL,
            f"K4 with lse at {shape}: output bit-equal "
            f"{bits_equal(out, out2)}, lse max |err| {lse_err} > {LSE_TOL}")
    took = [sh[-1] for sh in A.SHAPES["flash_attention"]]
    require(took == [route], f"K4 took {took}, expected {route}")
    return err


def check_k4(dev, gen, main_shapes) -> dict:
    """K4 within its tolerance at every main-path shape (q with H heads, k
    and v with K) and on edges: for the tensor-core route a ragged S, S = 1,
    non-causal and head_dim 64 with ragged S; for the CUDA-core route fp32
    and head_dim 32. Timed at the largest main-path shape against its plain
    version and, as before, the library's fused attention on q and the
    expanded k, v."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as A, ref
    # (B, S, H, K, hd, dtype, causal, route)
    edges = [(1, 77, 24, 8, 128, "torch.bfloat16", True, "tc"),
             (2, 1, 24, 8, 128, "torch.bfloat16", True, "tc"),
             (1, 300, 8, 8, 128, "torch.bfloat16", False, "tc"),
             (2, 130, 6, 2, 64, "torch.bfloat16", True, "tc"),
             (1, 477, 8, 8, 64, "torch.bfloat16", False, "tc"),
             (3, 1, 6, 3, 64, "torch.bfloat16", True, "tc"),
             (1, 200, 4, 2, 128, "torch.float32", True, "simt"),
             (1, 129, 4, 4, 128, "torch.float32", False, "simt"),
             (2, 70, 6, 3, 32, "torch.bfloat16", True, "simt")]
    require(all(sh[-1] == "tc" for sh in main_shapes),
            f"a prefill took K4's CUDA-core route: {sorted(main_shapes)}")
    err = max(hold_k4(dev, gen, shape)
              for shape in sorted(main_shapes) + edges)
    b, s, h, kh, hd, dt, causal, _ = max(
        main_shapes, key=lambda sh: sh[0] * sh[1] ** 2 * sh[2])
    q = _randn(gen, (b, s, h, hd), dt, dev)
    k, v = (_randn(gen, (b, s, kh, hd), dt, dev) for _ in range(2))
    err = max(err, _held_close(A.flash_attention(q, k, v, causal),
                               ref.flash_attention_ref(q, k, v, causal), dt,
                               "K4 differs from its plain version (timed)"))
    elem = q.element_size()
    flops = (2.0 if causal else 4.0) * b * h * s * s * hd
    # q and o with H heads, k and v with K, each moved once
    bnd, by = bound_ms((2 * b * s * h + 2 * b * s * kh) * hd * elem, flops,
                       BF16_OPS_PER_S if dt == "torch.bfloat16"
                       else FP32_OPS_PER_S)
    g = h // kh
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "max_abs_err": err,
            "ms": median_ms(lambda: A.flash_attention(q, k, v, causal)),
            "plain_ms": median_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal)),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)),
            "device": {"ms": device_ms(lambda: A.flash_attention(
                q, k, v, causal)), "library_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))},
            "shape": f"B={b} S={s} H={h} K={kh} hd={hd} {dt} "
                     f"causal={causal}"}


def _k5_case(dev, gen, shape, length):
    import torch
    b, h, s, kh, hd, dt = shape
    q = _randn(gen, (b, h, hd), dt, dev)
    kc, vc = (_randn(gen, (b, s, kh, hd), dt, dev) for _ in range(2))
    return q, kc, vc, torch.as_tensor(length, dtype=torch.int32, device=dev)


def hold_k5(dev, gen, shape) -> float:
    """K5 at ``shape`` ``(B, H, S, K, hd, dtype)``, random lengths with 1
    and S among them, within its tolerance of its plain version; returns
    the max |err|."""
    import torch
    from repro_torch.kernels import attention as A, ref
    b, h, s, kh, hd, dt = shape
    length = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    length[0], length[-1] = 1, s
    args = _k5_case(dev, gen, shape, length)
    return _held_close(
        A.decode_attention(*args), ref.decode_attention_ref(*args), dt,
        f"K5 differs from its plain version at B={b} H={h} S={s} K={kh}"
        f" hd={hd} {dt}")


def check_k5(dev, gen, main_shapes, lengths) -> dict:
    """K5 within its tolerance at every main-path shape (random lengths,
    with 1 and S among them), on edges (fp32, one query head a kv head,
    S not a multiple of the chunk) and at lengths on the split's chunk
    edges and 0 (zeros); timed at the largest main-path shape with
    ``lengths``, the cache lengths of the serve phase's decode step that
    read the most keys, against its plain version and the library's fused
    attention with a length mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as A, ref
    edges = [(2, 24, 256, 8, 128, "torch.float32"),
             (2, 8, 128, 8, 64, "torch.bfloat16"),
             (3, 6, 100, 2, 128, "torch.bfloat16")]
    err = max(hold_k5(dev, gen, shape)
              for shape in sorted(main_shapes) + edges)

    def case(b, h, s, kh, hd, dt, length):
        return _k5_case(dev, gen, (b, h, s, kh, hd, dt), length)

    b, h, s, kh, hd, dt = max(main_shapes, key=lambda sh: (sh[0] * sh[2],
                                                           sh[1] * sh[4]))
    for dt_edge in (dt, "torch.float32"):
        at_edges = (0, 1, 63, 64, 65, 127, 128, 129, s - 1, s)
        args = case(len(at_edges), h, s, kh, hd, dt_edge, at_edges)
        got = A.decode_attention(*args)
        require(not bool(got[0].any()), "K5 at length 0 is not zero")
        err = max(err, _held_close(
            got, ref.decode_attention_ref(*args), dt_edge,
            f"K5 differs from its plain version at lengths {at_edges} "
            f"{dt_edge}"))
    require(len(lengths) == b, f"{len(lengths)} lengths for batch {b}")
    args = case(b, h, s, kh, hd, dt, lengths)
    err = max(err, _held_close(A.decode_attention(*args),
                               ref.decode_attention_ref(*args), dt,
                               "K5 differs from its plain version (timed)"))
    q, kc, vc, length = args
    elem = q.element_size()
    keys = int(sum(lengths))
    bnd, by = bound_ms(2 * b * h * hd * elem + 4 * b
                       + 2 * keys * kh * hd * elem,
                       4.0 * keys * h * hd, BF16_OPS_PER_S)
    mask = (torch.arange(s, device=dev)[None, :] < length[:, None])
    q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    m4 = mask[:, None, None, :]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:65",
            "max_abs_err": err,
            "ms": median_ms(lambda: A.decode_attention(*args)),
            "plain_ms": median_ms(lambda: ref.decode_attention_ref(*args)),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, enable_gqa=True)),
            "device": {"ms": device_ms(lambda: A.decode_attention(*args)),
                       "library_ms": device_ms(
                           lambda: F.scaled_dot_product_attention(
                               q4, k4, v4, attn_mask=m4,
                               enable_gqa=True))},
            "shape": f"B={b} H={h} S={s} K={kh} hd={hd} {dt} "
                     f"lengths={list(lengths)}"}


# -- query phases ---------------------------------------------------------------


def oracle(fact, dim, num_groups: int = NUM_GROUPS) -> np.ndarray:
    """Vectorized numpy oracle of the sub-query (float64 sums)."""
    from repro_torch.analytics.table import to_numpy
    f, d = fact.gather(), dim.gather()
    fk, v0, v1 = (to_numpy(f[c]) for c in ("key", "v0", "v1"))
    dk, cat = to_numpy(d["key"]), to_numpy(d["cat"])
    order = np.argsort(dk, kind="stable")
    sk = dk[order]
    pos = np.clip(np.searchsorted(sk, fk), 0, len(sk) - 1)
    hit = (sk[pos] == fk) & (v0 > 0)
    grp = cat[order][pos][hit] % num_groups
    w = v0[hit].astype(np.float64) * v1[hit].astype(np.float64)
    return np.bincount(grp, weights=w, minlength=num_groups)


def query_tables(rows: int, dim_rows: int, seed: int, fact_nodes: int,
                 dim_nodes, device):
    """The fact/dim pair of ``synth_query_tables`` (same seeds, same bytes)
    without its per-row Python oracle, which would take minutes here."""
    import torch
    from repro_torch.analytics.table import Table, distribute, synth_table
    ks = 2 * max(rows, dim_rows)
    fact = synth_table("f", rows, ks, seed=seed, device=device)
    d = synth_table("d", dim_rows, ks, seed=seed + 1, unique_keys=True,
                    device=device)
    dim = Table({**d.columns, "cat": torch.arange(
        dim_rows, dtype=torch.int32, device=device) % NUM_GROUPS})
    dim_nodes = range(dim_nodes) if isinstance(dim_nodes, int) else dim_nodes
    return (distribute(fact, range(fact_nodes), "A"),
            distribute(dim, dim_nodes, "B"))


def run_query(app: str, rows: int, dim_rows: int, device, seed: int,
              fact_nodes: int, dim_nodes, invoker: str = "threads",
              tables=None, runtime=None) -> dict:
    """One query through the port's entry point with the kernel counters
    set to 0 just before it and read just after. ``tables`` reuses an
    earlier phase's ``(fact, dim, oracle sums)``; ``runtime`` runs it on
    a runtime built by the caller (else ``execute_query_runtime`` builds
    one with ``invoker``)."""
    import torch
    from repro_torch.analytics.planner import build_query_workflow
    from repro_torch.analytics.query import (
        QueryStrategy, execute_query_runtime)
    from repro_torch.kernels import partition as K
    from repro_torch.obs.audit import get_audit_log

    t0 = time.perf_counter()
    if tables is None:
        fact, dim = query_tables(rows, dim_rows, seed, fact_nodes, dim_nodes,
                                 device)
        t1 = time.perf_counter()
        want = oracle(fact, dim)
        setup = {"synth_s": t1 - t0, "oracle_s": time.perf_counter() - t1}
    else:
        (fact, dim, want), setup = tables, {"reused_tables": True}
    strategy = QueryStrategy("static_merge")
    workflow = build_query_workflow(strategy)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    got, runtime = execute_query_runtime(
        fact, dim, strategy, app=app, invoker=invoker, runtime=runtime,
        pipeline=True, num_groups=NUM_GROUPS, workflow=workflow,
        device=None if runtime is not None else device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    require(got.shape == (NUM_GROUPS,) and np.isfinite(got).all(),
            f"{app}: result is not {NUM_GROUPS} finite sums")
    err = float(np.max(np.abs(got - want)))
    require(np.allclose(got, want, rtol=QUERY_RTOL, atol=QUERY_ATOL),
            f"{app}: result differs from the oracle by up to {err}")
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    # function-seconds per stage (summed over its invocations) and the
    # share of them spent against the shuffle store
    stages = {name: {"invocations": m.invocations,
                     "fn_s": round(m.seconds, 6),
                     "store_s": round(m.store_seconds, 6),
                     "bytes_in": m.bytes_in, "bytes_out": m.bytes_out}
              for name, m in runtime.metrics.by_stage(app).items()}
    return {"app": app, "fact_rows": rows, "dim_rows": dim_rows,
            "setup": setup, "wall_s": wall, "rows_per_s": rows / wall,
            "peak_bytes": int(peak), "max_abs_err": err,
            "launches": launches, "stages": stages,
            "sequence": get_audit_log().sequence(app), "tables": (fact, dim),
            "want": want, "runtime": runtime, "workflow": workflow,
            "decisions": list(workflow.last_run.sequence)}


def check_phase(res: dict, plan: str, kernels) -> None:
    bound = dict(res["sequence"])
    require(bound.get("pipeline") == plan,
            f"{res['app']}: pipeline bound {bound.get('pipeline')!r}, "
            f"expected {plan!r}")
    for k in kernels:
        require(res["launches"][k] > 0,
                f"{res['app']}: the main path never launched {k}")


def small_query(device) -> dict:
    res = run_query("smoke_small", 1 << 17, 1 << 13, device, seed=7,
                    fact_nodes=4, dim_nodes=[0, 1])
    check_phase(res, "fused", ("fused_probe",))
    return res


def large_query(device, rows: int = 1 << 25, dim_rows: int = 1 << 22,
                ) -> dict:
    res = run_query("smoke_large", rows, dim_rows, device, seed=1,
                    fact_nodes=4, dim_nodes=2)
    check_phase(res, "pipelined",
                ("partition_histogram", "partition_scatter"))
    return res


# -- the simulator plane, the process worker plane, the scheduler ------------------


def sim_plane(device, large: dict) -> dict:
    """The simulator plane at full size: calibrate the six operator rates on
    the card, plan ``smoke_large``'s 2^25-row tables through its own
    workflow object on a 4-node ``ClusterSim`` (the shuffle-skew feedback
    builds its sketch with K1: the counters are set to 0 just before the
    planning and read just after), require the simulator's bound decision
    sequence to equal the runtime's, then replay ``smoke_large``'s
    invocation trace into a fresh cluster."""
    from repro_torch.analytics.query import QueryStrategy, plan_query_tasks
    from repro_torch.analytics.simulator import calibrated_rates, make_cluster
    from repro_torch.core.controllers import PrivateController
    from repro_torch.kernels import partition as K

    t0 = time.perf_counter()
    rates = calibrated_rates(device=device, force=True)
    calib_s = time.perf_counter() - t0
    fact, dim = large["tables"]
    app, wf = large["app"], large["workflow"]
    gc, sim = make_cluster(4)
    K.reset_launches()
    t0 = time.perf_counter()
    plan_query_tasks(sim, PrivateController(app, gc, priority=10), fact, dim,
                     QueryStrategy("static_merge"), app=app, workflow=wf,
                     device=device)
    plan_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    seq_sim = list(wf.last_run.sequence)
    require(seq_sim == large["decisions"],
            f"sim_plane: the simulator bound {seq_sim}, the runtime "
            f"{large['decisions']}")
    require(launches["partition_histogram"] > 0,
            f"sim_plane: the planner never launched K1 ({launches})")
    planned = sim.run()["completion"][app]
    _, replay = make_cluster(4)
    tasks = large["runtime"].replay_into(replay, app=app)
    require(tasks > 0, "sim_plane: the trace replayed no task")
    replayed = replay.run()["completion"][app]
    return {"rates": rates, "calibrate_s": calib_s, "plan_s": plan_s,
            "launches": launches,
            "sequence": [(st, d.func) for st, d in seq_sim],
            "planned_makespan_s": planned, "replayed_tasks": tasks,
            "replayed_makespan_s": replayed,
            "measured_wall_s": large["wall_s"]}


class MemorySampler:
    """The card's used memory (``nvidia-smi``, MiB) sampled every
    ``period`` seconds on a thread until ``stop()``; ``peak_mib`` is the
    most it saw."""

    def __init__(self, period: float = 0.5):
        import threading
        self.peak_mib = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period,),
                                        daemon=True)
        self._thread.start()

    def _run(self, period: float) -> None:
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True).stdout.split()
            if out:
                self.peak_mib = max(self.peak_mib, int(out[0]))
            self._stop.wait(period)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(30)
        return self.peak_mib


def process_query(device, large: dict, workers: int = PROCESS_WORKERS) -> dict:
    """``smoke_large``'s query again, on its tables, through the process
    worker plane (``invoker="process"``, up to ``workers`` spawned workers,
    each with its own CUDA context), held to the same oracle. The workers'
    kernel launches come home in their task metrics
    (``worker_launches``)."""
    from repro_torch.core.controllers import GlobalController
    from repro_torch.obs import get_tracer
    from repro_torch.runtime import Runtime

    fact, dim = large["tables"]
    runtime = Runtime(GlobalController({n: 8 for n in range(4)}),
                      invoker="process", max_workers=workers, device=device)
    sampler = MemorySampler()
    t0 = time.perf_counter()
    try:
        res = run_query("smoke_process", large["fact_rows"],
                        large["dim_rows"], device, seed=1, fact_nodes=4,
                        dim_nodes=2, tables=(fact, dim, large["want"]),
                        runtime=runtime)
        pool = runtime.invoker.pool.stats()
        launches = dict(runtime.invoker.worker_launches)
        gc_used = sum(runtime.gc.used.values())
    finally:
        peak_mib = sampler.stop()
        runtime.invoker.shutdown()
    res.pop("runtime")
    check_phase(res, "pipelined", ())
    for k in ("partition_histogram", "partition_scatter"):
        require(launches.get(k, 0) > 0,
                f"smoke_process: no worker launched {k} ({launches})")
    require(gc_used == 0, f"smoke_process: {gc_used} slots leaked")
    # where the invocations' seconds went: the host's span of each
    # (send, store RPCs, results back), the body in the worker, and the
    # body's wait on the host for store reads (tables through the pipe)
    bodies = [sp for sp in get_tracer().spans() if sp.start >= t0
              and sp.attrs.get("kind") == "worker_body"]
    res["split"] = {"invocations": len(bodies),
                    "host_s": sum(sp.seconds for sp in bodies),
                    "worker_body_s": sum(sp.attrs["busy_s"] for sp in bodies),
                    "worker_rpc_wait_s": sum(sp.attrs["rpc_s"]
                                             for sp in bodies)}
    res.update(worker_launches=launches, pool=pool,
               gpu_memory_used_peak_mib=peak_mib,
               mean_cold_start_s=pool["provision_seconds"]
               / max(1, pool["cold_starts"]))
    return res


def scheduler_mix(device) -> dict:
    """Six queries at 2^22 fact rows (priorities 0, 0, 0, 0, 10, 10;
    strategies cycling static_hash, dynamic, static_merge, as in
    ``examples/multi_tenant.py`` part 3) through one ``QueryScheduler`` over
    one ``threads`` runtime on the card, once per policy. Every result is
    held to its oracle and no slot may leak; the kernel counters are set to
    0 before each policy's run and read after it."""
    import torch
    from repro_torch.core.controllers import GlobalController
    from repro_torch.kernels import partition as K
    from repro_torch.runtime import QueryJob, QueryScheduler, Runtime

    t0 = time.perf_counter()
    queries = []
    for i in range(MIX_QUERIES):
        fact, dim = query_tables(MIX_ROWS, MIX_DIM_ROWS, 100 + 7 * i, 4, 2,
                                 device)
        queries.append((fact, dim, oracle(fact, dim)))
    out = {"setup_s": time.perf_counter() - t0, "policies": {}}
    for policy in ("fifo", "priority", "fair_share"):
        gc = GlobalController({n: 8 for n in range(4)})
        runtime = Runtime(gc, invoker="threads", max_workers=8,
                          device=device)
        sched = QueryScheduler(runtime, policy=policy)
        for i, (fact, dim, _) in enumerate(queries):
            sched.submit(QueryJob(
                f"{policy}_q{i}", fact, dim,
                ("static_hash", "dynamic", "static_merge")[i % 3],
                priority=MIX_PRIORITIES[i], num_groups=NUM_GROUPS))
        torch.cuda.synchronize()
        K.reset_launches()
        results = sched.run()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        errs = []
        for i, (_, _, want) in enumerate(queries):
            res = results[f"{policy}_q{i}"]
            require(res.ok, f"scheduler_mix {policy} q{i}: {res.error!r}")
            require(np.allclose(res.sums, want, rtol=QUERY_RTOL,
                                atol=QUERY_ATOL),
                    f"scheduler_mix {policy} q{i} differs from its oracle")
            errs.append(float(np.max(np.abs(res.sums - want))))
        used = sum(gc.used.values())
        require(used == 0, f"scheduler_mix {policy}: {used} slots leaked")
        require(runtime.invoker.gate is None,
                f"scheduler_mix {policy}: the gate stayed on the invoker")
        out["policies"][policy] = {
            "makespan_s": sched.makespan(),
            "hi_latencies_s": sched.latencies(min_priority=10),
            "all_latencies_s": sched.latencies(),
            "max_abs_err": max(errs), "launches": launches}
    return out


def leftovers() -> dict:
    """What the phases so far left running in this process: its live child
    processes and threads, the card memory its allocator holds, and the
    other processes ``nvidia-smi`` lists with a context on the card (a
    container may hide them)."""
    import multiprocessing
    import os
    import threading

    import torch
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.split()
    return {"children": [p.pid for p in multiprocessing.active_children()],
            "threads": threading.active_count(),
            "reserved_bytes": int(torch.cuda.memory_reserved()),
            "card_processes": sorted(int(p) for p in apps
                                     if p.isdigit() and int(p) != os.getpid())}


def serve_rate(res: dict) -> dict:
    return {"tokens_per_s": res["generated"] / res["wall_s"],
            "decode_median_ms": float(np.median(res["decode_ms"])),
            "wall_s": res["wall_s"]}


def device_busy(prof, top: int = 12) -> tuple[float, dict]:
    """Device-busy microseconds of a ``torch.profiler`` trace and its
    ``top`` costliest device kernels (ms). Only device-side events count:
    an ATen op and the kernel it launches are one interval, not two, and
    intervals that overlap (two streams) count once."""
    from torch.autograd import DeviceType
    # a ``record_function`` range (``LoopSpans``) also shows on the device
    # timeline, spanning its kernels and the gaps between them: not work
    notes = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name not in notes)
    require(bool(spans), "the profiler traced no device events")
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in notes]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return busy, {e.key[:60]: e.self_device_time_total / 1e3
                  for e in kernels[:top]}


def profile_query(device, fact, dim) -> dict:
    """Re-run a query on its tables under ``torch.profiler`` (outside the
    counted run) and split its wall into device-busy and idle time."""
    import torch
    from repro_torch.analytics.query import (
        QueryStrategy, execute_query_runtime)

    def query(_):
        t0 = time.perf_counter()
        execute_query_runtime(fact, dim, QueryStrategy("static_merge"),
                              app="smoke_profile", invoker="threads",
                              pipeline=True, num_groups=NUM_GROUPS,
                              device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, wall = traced(query)
    device_us, top = device_busy(prof)
    from torch.autograd import DeviceType
    partition_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and any(k in e.key for k in PARTITION_KERNELS))
    return {"wall_s": wall, "device_busy_s": device_us / 1e6,
            "idle_share": 1.0 - device_us / 1e6 / wall,
            "partition_kernels_ms": partition_us / 1e3,
            "partition_kernels_share": partition_us / device_us,
            "top_device_ms": top}


# -- serve phase ------------------------------------------------------------------


def serve_config(arch: str = SERVE_ARCH):
    """``arch``'s published config (``PUBLISHED``, and ``PUBLISHED_REST``
    where it has an entry), checked."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    moe = None if cfg.moe is None else (cfg.moe.num_experts, cfg.moe.top_k,
                                        cfg.moe.d_expert)
    require((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype, moe)
            == PUBLISHED[arch], f"{arch} is not the published config: {cfg}")
    if arch in PUBLISHED_REST:
        if cfg.ssm is not None:
            block = (cfg.ssm.d_state, cfg.ssm.d_conv, cfg.ssm.expand)
        elif cfg.xlstm is not None:
            x = cfg.xlstm
            block = (x.slstm_every, x.conv_kernel, x.qk_dim_factor,
                     x.proj_factor)
        else:
            block = (cfg.frontend, cfg.stub_patches)
        rest = (tuple(cfg.block_pattern),
                cfg.moe.every_k_layers if cfg.moe else None, block)
        require(rest == PUBLISHED_REST[arch],
                f"{arch} is not the published config: {cfg}")
    return cfg


def moe_layers(cfg) -> int:
    return sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))


def attention_layers(cfg) -> int:
    return sum(cfg.block_kind(i).value == "attention"
               for i in range(cfg.num_layers))


class MoeRecorder:
    """While entered, wraps the MoE router and dispatch
    (``repro_torch.models.moe.route`` and ``.dispatch``) and keeps, under
    the ``label`` of the moment, each layer's expert choices ``top_i`` and
    each dispatch's sequence length and bookkeeping: no device work is
    added to the run."""

    def __init__(self):
        self.label = None
        self.routes: list = []
        self.calls: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self._route, self._dispatch = moe.route, moe.dispatch

        def recording_route(p, x, top_k):
            out = self._route(p, x, top_k)
            self.routes.append((self.label, out[2]))
            return out

        def recording_dispatch(top_i, num_experts, cap):
            bk = self._dispatch(top_i, num_experts, cap)
            self.calls.append((self.label, top_i.shape[1], bk.token_src,
                               bk.keep))
            return bk

        moe.route, moe.dispatch = recording_route, recording_dispatch
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route, moe.dispatch = self._route, self._dispatch

    def top_i(self, label) -> list:
        """The label's expert choices, one ``(R, S, k)`` a MoE layer."""
        return [t for lab, t in self.routes if lab == label]

    def lost(self, label, calls: int):
        """The ``(R, S)`` count of assignments each token lost to the
        capacity over the label's dispatches, which must be ``calls``: one
        a MoE layer, so that no sequence was cut into chunks (whose token
        positions would not line up)."""
        import torch
        mine = [c for c in self.calls if c[0] == label]
        require(len(mine) == calls,
                f"{label}: {len(mine)} MoE dispatches, expected {calls}")
        total = None
        for _, s, token_src, keep in mine:
            counts = torch.zeros((token_src.shape[0], s), dtype=torch.int64,
                                 device=token_src.device).scatter_add_(
                1, token_src, (~keep).long())
            total = counts if total is None else total + counts
        return total


def first_lost(counts_row, upto: int) -> int | None:
    """The first position below ``upto`` whose token lost an assignment,
    or None."""
    hit = counts_row[:upto].nonzero()
    return int(hit[0, 0]) if hit.numel() else None


class PinnedRouting:
    """While entered, the MoE router keeps its probabilities but routes
    each token of each layer, in call order, to ``pinned[layer]`` ``(B, S,
    k)``, with those experts' probabilities renormalized, and counts the
    (token, layer) pairs whose own top-k set differs."""

    def __init__(self, pinned: list):
        self.pinned, self.layer, self.differ = pinned, 0, 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._route = moe.route

        def pinned_route(p, x, top_k):
            probs, _, own = self._route(p, x, top_k)
            top_i = self.pinned[self.layer].to(own.device)
            self.layer += 1
            chosen = torch.zeros_like(probs, dtype=torch.bool)
            self.differ += int((chosen.scatter(-1, own, True)
                                != chosen.scatter(-1, top_i, True)).any(-1)
                               .sum())
            top_p = probs.gather(-1, top_i)
            return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i

        moe.route = pinned_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def engine_routing(res: dict, req) -> list:
    """The experts the engine chose for each token of ``req``'s sequence
    (its prompt and every generated token but the last), one ``(1, L, k)``
    a MoE layer: at positions below its last prefill's length less one,
    that prefill's choices; from there on, the decode steps' (each step
    re-feeds and routes the position it decodes from)."""
    import torch
    rec, last = res["recorder"], res["drops"]["last_prefill"][req.req_id]
    n = len(req.tokens)
    cut = last["tokens"] - 1
    pre = rec.top_i(("prefill", last["wave"]))
    rows = res["where"][req.req_id][cut - (n - 1):]
    steps = {}
    for step, _ in rows:
        if step not in steps:
            steps[step] = rec.top_i(("decode", step))
    return [torch.cat([pre[layer][last["slot"], :cut]]
                      + [steps[step][layer][slot] for step, slot in rows])[None]
            for layer in range(len(pre))]


def prefill_drops(rec: MoeRecorder, waves, layers: int) -> dict:
    """What the prefill waves lost to the MoE capacity: per wave the
    assignments dropped at every position (the padding included) and at
    the real tokens' positions, and per request the last wave that held it
    (its slot, its tokens then and the first of them that lost an
    assignment, or None)."""
    per_wave, last = [], {}
    for w, slots in enumerate(waves):
        counts = rec.lost(("prefill", w), layers)
        require(counts.shape == (SERVE_BATCH, SERVE_SEQ),
                f"prefill wave {w}: drop counts of shape {counts.shape}")
        real = 0
        for slot, held in enumerate(slots):
            if held is None:
                continue
            rid, n = held
            real += int(counts[slot, :n].sum())
            last[rid] = {"wave": w, "slot": slot, "tokens": n,
                         "first_lost": first_lost(counts[slot], n)}
        per_wave.append({"dropped": int(counts.sum()), "dropped_real": real,
                         "requests": [h and h[0] for h in slots]})
    return {"waves": per_wave, "last_prefill": last}


def serve_prompts(cfg) -> list:
    """The serve phases' ``SERVE_REQUESTS`` prompts, their lengths drawn
    from ``PROMPT_LENGTHS``, from seed 0."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_LENGTHS[0], PROMPT_LENGTHS[1] + 1,
                           SERVE_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in lengths]


def serve_phase(dev, cfg, model=None, rec: MoeRecorder | None = None
                ) -> dict:
    """Serve 8 requests with ``cfg`` (a served model at its published
    config, jamba cut in depth) through the port's ``ServingEngine``, with
    the attention and partition launch counters set to 0 just before and
    read just after: K4 once an attention layer a prefill wave, K5 once an
    attention layer a decode step, K2 once a MoE layer in both, and K1 and
    K3 never. The engine's decode
    logits are kept (on the card) for the teacher-forced check. ``model``
    serves the same requests again on weights made by an earlier call.
    ``rec`` records the MoE routing and dispatch of every prefill wave and
    decode step (decode steps must drop no assignment)."""
    import torch
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.models import init_lm
    from repro_torch.serving import Request, ServingEngine

    t0 = time.perf_counter()
    if model is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = init_lm(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg)

    engine = ServingEngine(cfg, model, max_batch=SERVE_BATCH,
                           max_seq=SERVE_SEQ, device=dev)
    # keep each step's logits and cache positions and, per request,
    # (step, slot) of each token
    steps: list = []
    step_pos: list = []
    where: dict[int, list[tuple[int, int]]] = {}
    decode = engine._decode
    # per prefill wave, (request id, tokens held) in each slot
    waves: list = []

    def recording_decode(model_, state, tokens):
        step_pos.append(state["pos"])
        if rec is not None:
            rec.label = ("decode", len(steps))
        logits, state = decode(model_, state, tokens)
        for slot, req in enumerate(engine.active):
            if req is not None:
                where.setdefault(req.req_id, []).append((len(steps), slot))
        steps.append(logits[:, 0, :cfg.vocab_size])
        return logits, state

    engine._decode = recording_decode
    if rec is not None:
        prefill = engine._prefill

        def recording_prefill(model_, state, inputs):
            rec.label = ("prefill", len(waves))
            waves.append([None if r is None else
                          (r.req_id, len(r.tokens) + len(r.output))
                          for r in engine.active])
            return prefill(model_, state, inputs)

        engine._prefill = recording_prefill
    for i, prompt in enumerate(prompts):
        engine.submit(Request(i, prompt, max_new_tokens=SERVE_NEW_TOKENS))
    torch.cuda.synchronize()
    start_bytes = int(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    K.reset_launches()
    t0 = time.perf_counter()
    if rec is None:
        done = engine.run(max_steps=4096)
    else:
        with rec:
            done = engine.run(max_steps=4096)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**A.LAUNCHES, **K.LAUNCHES}
    m = engine.metrics
    require(len(done) == SERVE_REQUESTS
            and all(len(r.output) == SERVE_NEW_TOKENS for r in done),
            f"served {len(done)} requests, outputs "
            f"{[len(r.output) for r in done]}")
    attn = attention_layers(cfg)
    require(launches["flash_attention"] == attn * m["prefills"]
            and launches["decode_attention"] == attn * m["steps"]
            and launches["partition_scatter"]
            == moe_layers(cfg) * (m["prefills"] + m["steps"])
            and launches["partition_histogram"] == 0
            and launches["fused_probe"] == 0,
            f"launches {launches} for {m['prefills']} prefills and "
            f"{m['steps']} decode steps of {cfg.num_layers} layers, {attn} "
            f"of them attention and {moe_layers(cfg)} MoE")
    # K5's lengths (pos + 1) at the decode step that read the most keys
    decode_lengths = max(((p + 1).tolist() for p in step_pos), key=sum)
    out = {}
    if rec is not None:
        out = {"drops": prefill_drops(rec, waves, moe_layers(cfg)),
               "recorder": rec}
        decode_lost = sum(int(rec.lost(("decode", i), moe_layers(cfg))
                              .sum()) for i in range(len(steps)))
        require(decode_lost == 0, f"decode steps dropped {decode_lost} "
                "assignments (one token gives an expert one at most)")
    return {**out, "cfg": cfg, "model": model, "done": done,
            "prompts": prompts,
            "decode_lengths": decode_lengths,
            "steps": steps, "where": where, "init_s": init_s, "wall_s": wall,
            "generated": m["generated"], "decode_steps": m["steps"],
            "prefills": m["prefills"], "decode_ms": list(m["decode_ms"]),
            "prefill_ms": list(m["prefill_ms"]),
            "peak_bytes": int(torch.cuda.max_memory_allocated()),
            "start_bytes": start_bytes,
            "launches": launches}


def check_served_tokens(res: dict, dev) -> dict:
    """Teacher forcing: each finished sequence once through ``forward``
    (K4); its logits at every generated position must agree with the
    engine's decode logits (K5) within ``LOGIT_TOL``, and their argmax with
    the served token wherever the forward's top-2 margin exceeds twice
    that.

    For a MoE model (``res["drops"]`` set by ``serve_phase``) the forward
    is made to compute what the engine computed, up to rounding:

    - A dropped assignment changes its token's output and every later
      position's K/V. A decode step drops nothing (one token gives an
      expert one assignment at most), so the forward drops nothing either
      (the capacity factor raised to ``E / top_k``), and each request is
      held only at generated positions below the first position that lost
      an assignment in its last prefill (capacity that of ``SERVE_SEQ``
      tokens, padding included), and only at tokens decoded after it.
    - The router's top-k turns on bf16 rounding: on an H100 with the
      seed-0 weights the forward's own choices differ from the engine's for
      5–25 % of (token, layer) pairs, from the first token on, and the
      reroutes move later logits by up to ~0.45. So the forward routes each token
      to the experts the engine chose for it (``PinnedRouting``), with its
      own probabilities, and prints how many pairs that changed.

    Over all requests at least one position must be held. A forward at
    the model's own capacity, unpinned, runs too, uncompared, for its drop
    counts."""
    import torch
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.models import forward

    cfg, steps = res["cfg"], res["steps"]
    model, passes = res["model"], 1
    moe = "drops" in res
    if moe:
        passes = 2
        layers = moe_layers(cfg)
        no_drops = drop_free(cfg)
        rec = MoeRecorder()
    A.reset_launches()
    K.reset_launches()
    max_err, checked, sure_total = 0.0, 0, 0
    deltas, peak_logit, held = [], 0.0, {}
    for req in res["done"]:
        n, new = len(req.tokens), len(req.output)
        seq = torch.tensor([req.tokens + req.output[:-1]], device=dev)
        if not moe:
            logits, _ = forward(model, {"tokens": seq})
        else:
            pin = PinnedRouting(engine_routing(res, req))
            with rec:
                rec.label = ("forward", req.req_id)
                forward(model, {"tokens": seq})
                rec.label = ("forward_pinned", req.req_id)
                model.cfg = no_drops
                try:
                    with pin:
                        logits, _ = forward(model, {"tokens": seq})
                finally:
                    model.cfg = cfg
        tf = logits[0, n - 1:n - 1 + new, :cfg.vocab_size]
        rows = res["where"][req.req_id]
        require(len(rows) == new, f"request {req.req_id}: {len(rows)} "
                f"decode rows for {new} tokens")
        served = req.output
        if moe:
            require(int(rec.lost(rec.label, layers).sum()) == 0,
                    f"request {req.req_id}: the forward at capacity factor "
                    f"{no_drops.moe.capacity_factor} dropped assignments")
            lost = rec.lost(("forward", req.req_id), layers)[0]
            last = res["drops"]["last_prefill"][req.req_id]
            first = last["tokens"] - n          # decoded after that prefill
            upto = new if last["first_lost"] is None \
                else max(first, min(new, last["first_lost"] - (n - 1)))
            held[req.req_id] = {
                "prompt": n, "held": upto - first,
                "prefill_first_lost": last["first_lost"],
                "forward_dropped": int(lost.sum()),
                "forward_first_lost": first_lost(lost, seq.shape[1]),
                "rerouted_by_pinning": pin.differ,
                "of": layers * seq.shape[1]}
            tf, rows, served = (tf[first:upto], rows[first:upto],
                                served[first:upto])
            if not len(rows):
                continue
        eng = torch.stack([steps[s][slot] for s, slot in rows])
        require(bool(torch.isfinite(tf).all() & torch.isfinite(eng).all()),
                f"request {req.req_id}: non-finite logits")
        delta = (tf - eng).abs()
        max_err = max(max_err, float(delta.max()))
        peak_logit = max(peak_logit, float(tf.abs().max()))
        deltas.append(delta.flatten()[::97])   # a strided sample of |diff|
        top2 = tf.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        served = torch.tensor(served, device=dev)
        require(bool((eng.argmax(-1) == served).all()),
                f"request {req.req_id}: served tokens are not the argmax of "
                f"the engine's own logits")
        require(bool((tf.argmax(-1)[sure] == served[sure]).all()),
                f"request {req.req_id}: teacher-forced argmax differs where "
                f"the margin exceeds {2 * LOGIT_TOL}")
        checked += len(rows)
        sure_total += int(sure.sum())
    torch.cuda.synchronize()
    launches = {**A.LAUNCHES, **K.LAUNCHES}
    require(checked > 0, f"no generated position was held: {held}")
    sample = torch.cat(deltas).double()
    quant = torch.quantile(sample[:1 << 24],
                           torch.tensor([0.5, 0.99, 0.9999],
                                        dtype=torch.float64,
                                        device=sample.device)).tolist()
    require(max_err <= LOGIT_TOL, f"teacher-forced logits differ from the "
            f"engine's by up to {max_err} > {LOGIT_TOL}")
    require(launches["flash_attention"]
            == passes * cfg.num_layers * len(res["done"])
            and launches["decode_attention"] == 0
            and launches["partition_scatter"]
            == passes * moe_layers(cfg) * len(res["done"]),
            f"teacher forcing launched {launches}")
    out = {"held_by_request": held} if moe else {}
    return {**out, "max_abs_logit_err": max_err, "positions": checked,
            "logits": checked * cfg.vocab_size,
            "abs_err_rms": float(sample.square().mean().sqrt()),
            "abs_err_p50_p99_p9999": quant, "max_abs_logit": peak_logit,
            "argmax_checked": sure_total, "launches": launches}


class LoopSpans:
    """While entered, each call of the recurrent loops, the Mamba chunk
    scan (``ssm._scan_chunk``, prefill), the Mamba decode step
    (``ssm.mamba_step``, through the LM's step table) and the sLSTM
    recurrence (``xlstm._slstm_scan``, prefill and decode), runs inside a
    ``torch.profiler.record_function`` range of its label, between two CUDA
    events on the current stream. ``shares`` gives each label's device time
    (the kernels launched inside its ranges: the range's host-side event's
    ``device_time_total``) and its stream span (the events' elapsed time,
    idle gaps included), each beside its share of the trace's device-busy
    time and wall."""

    def __init__(self):
        import torch
        from repro_torch.core.config import BlockKind
        from repro_torch.models import lm, ssm, xlstm
        self.targets = [(ssm, "_scan_chunk", "mamba_scan"),
                        (lm._STEP, BlockKind.MAMBA, "mamba_step"),
                        (xlstm, "_slstm_scan", "slstm_loop")]
        self.events: dict = {label: [] for *_, label in self.targets}
        self._torch = torch

    @staticmethod
    def _get(where, key):
        return where[key] if isinstance(where, dict) else getattr(where, key)

    @staticmethod
    def _set(where, key, fn) -> None:
        if isinstance(where, dict):
            where[key] = fn
        else:
            setattr(where, key, fn)

    def __enter__(self):
        torch = self._torch
        self._saved = []
        for where, key, label in self.targets:
            fn = self._get(where, key)
            self._saved.append((where, key, fn))

            def spanned(*args, _fn=fn, _label=label, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                with torch.profiler.record_function(_label):
                    out = _fn(*args, **kw)
                stop.record()
                self.events[_label].append((start, stop))
                return out

            self._set(where, key, spanned)
        return self

    def __exit__(self, *exc):
        for where, key, fn in self._saved:
            self._set(where, key, fn)

    def shares(self, prof, device_us: float, wall_s: float) -> dict:
        from torch.autograd import DeviceType
        self._torch.cuda.synchronize()
        out = {}
        for label, spans in self.events.items():
            if not spans:
                continue
            dev_us = sum(e.device_time_total for e in prof.events()
                         if e.name == label
                         and e.device_type == DeviceType.CPU)
            span_ms = sum(a.elapsed_time(b) for a, b in spans)
            out[label] = {"calls": len(spans), "device_ms": dev_us / 1e3,
                          "device_share": dev_us / device_us,
                          "span_ms": span_ms,
                          "wall_share": span_ms / 1e3 / wall_s}
        return out


def profile_decode(res: dict, dev) -> dict:
    """Eight decode steps of a full batch (after its prefill and a first
    step, outside the trace) under ``torch.profiler``: the step's wall,
    its device-busy time, its costliest device ops and the recurrent
    loops' shares (``LoopSpans``)."""
    import torch
    from repro_torch.serving import Request, ServingEngine

    def prefilled():
        engine = ServingEngine(res["cfg"], res["model"],
                               max_batch=SERVE_BATCH, max_seq=SERVE_SEQ,
                               device=dev)
        for i, prompt in enumerate(res["prompts"][:SERVE_BATCH]):
            engine.submit(Request(i, prompt,
                                  max_new_tokens=PROFILE_STEPS + 1))
        engine.run(max_steps=1)
        return engine

    def steps(engine):
        with LoopSpans() as loops:
            t0 = time.perf_counter()
            engine.run(max_steps=PROFILE_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        require(engine.metrics["steps"] == PROFILE_STEPS + 1,
                f"profiled {engine.metrics['steps'] - 1} steps")
        return wall, loops

    prof, (wall, loops) = traced(steps, setup=prefilled)
    device_us, top = device_busy(prof)
    return {"steps": PROFILE_STEPS, "wall_ms_per_step": wall / PROFILE_STEPS
            * 1e3, "device_busy_ms_per_step": device_us / 1e3
            / PROFILE_STEPS, "idle_share": 1.0 - device_us / 1e6 / wall,
            "top_device_ms_per_step": {k: v / PROFILE_STEPS
                                       for k, v in top.items()},
            "loops": loops.shares(prof, device_us, wall)}


def profile_prefill(res: dict, dev) -> dict:
    """One prefill wave as the engine runs it (fresh caches, then
    ``prefill_step`` over ``SERVE_BATCH`` x ``SERVE_SEQ`` tokens), after an
    untraced one, under ``torch.profiler``: its wall, device-busy time,
    costliest device ops and the recurrent loops' shares
    (``LoopSpans``)."""
    import torch
    from repro_torch.models import init_decode_state, prefill_step

    cfg = res["cfg"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ))).to(dev)

    def wave():
        state = init_decode_state(cfg, SERVE_BATCH, SERVE_SEQ, dev)
        prefill_step(res["model"], state, {"tokens": tokens})

    def timed_wave(_):
        with LoopSpans() as loops:
            t0 = time.perf_counter()
            wave()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return wall, loops

    prof, (wall, loops) = traced(timed_wave, setup=wave)
    device_us, top = device_busy(prof)
    return {"wall_ms": wall * 1e3, "device_busy_ms": device_us / 1e3,
            "idle_share": 1.0 - device_us / 1e6 / wall,
            "top_device_ms": top,
            "loops": loops.shares(prof, device_us, wall)}


def prefill_length(cfg, n: int) -> int:
    """The longest prefix of an ``n``-token prompt that ``prefill_step``
    takes whole at a Mamba chunk of its own length: with mLSTM layers (a
    fixed prefill chunk of ``MLSTM_PREFILL_CHUNK``) a length under the
    chunk or a multiple of it, else all ``n``."""
    if "mlstm" in cfg.block_pattern and n > MLSTM_PREFILL_CHUNK:
        return n - n % MLSTM_PREFILL_CHUNK
    return n


def routing_of(rec: MoeRecorder, cut: int, row: int, length: int) -> list:
    """The experts that the teacher-forced run chose for each token of row
    ``row`` (its prefill of ``cut`` tokens, then its decode steps up to
    position ``length - 1``), one ``(1, length, k)`` a MoE layer."""
    import torch
    pre = rec.top_i(("prefill", cut))
    steps = [rec.top_i(("decode", cut, pos)) for pos in range(cut, length)]
    return [torch.cat([pre[layer][row]] + [st[layer][row] for st in steps])
            [None] for layer in range(len(pre))]


def check_recurrent(res: dict, dev) -> dict:
    """The model-level check of a recurrent model (the engine's padded
    prefill is not the greedy continuation for these, ROADMAP Queue 3):
    each finished request's sequence (prompt and generated tokens but the
    last) goes through ``prefill_step`` at batch 1 up to its longest
    prefix that the mLSTM's prefill chunk allows (``prefill_length``), at a
    Mamba chunk of that length, then through ``decode_step`` teacher-forced
    token by token; requests with the same prefix length run as one batch.
    The logits at the 32 generated positions must agree with one
    ``forward`` over the whole sequence (Mamba and mLSTM chunk its length)
    within ``LOGIT_TOL``. A MoE model runs drop-free throughout (capacity
    factor E / top_k; a decode step drops nothing either) and the forward
    routes each token to the experts that the prefill and decode chose for
    it (``PinnedRouting``; the top-k turns on bf16 rounding)."""
    import contextlib

    import torch
    from repro_torch.models import (
        decode_step,
        forward,
        init_decode_state,
        prefill_step,
    )

    cfg, model = res["cfg"], res["model"]
    moe = cfg.moe is not None
    rec = MoeRecorder() if moe else contextlib.nullcontext()
    model.cfg = drop_free(cfg)
    groups: dict = {}
    for req in res["done"]:
        groups.setdefault(prefill_length(cfg, len(req.tokens)), []).append(req)
    t0 = time.perf_counter()
    max_err, deltas, held, decoded, rerouted = 0.0, [], {}, 0, 0
    try:
        with rec:
            for cut, reqs in sorted(groups.items()):
                seqs = [r.tokens + r.output[:-1] for r in reqs]
                longest = max(map(len, seqs))
                toks = torch.zeros((len(reqs), longest), dtype=torch.int32)
                for i, seq in enumerate(seqs):
                    toks[i, :len(seq)] = torch.tensor(seq)
                toks = toks.to(dev)
                state = init_decode_state(cfg, len(reqs), longest, dev)
                if moe:
                    rec.label = ("prefill", cut)
                lg, state = prefill_step(model, state,
                                         {"tokens": toks[:, :cut]},
                                         ssm_chunk=cut)
                # position cut - 1 + j at index j; rows past their end feed
                # their pad tokens, whose logits no row reads
                logits = [lg[:, 0, :cfg.vocab_size]]
                for pos in range(cut, longest):
                    if moe:
                        rec.label = ("decode", cut, pos)
                    lg, state = decode_step(model, state,
                                            toks[:, pos:pos + 1])
                    logits.append(lg[:, 0, :cfg.vocab_size])
                decoded += longest - cut
                logits = torch.stack(logits, dim=1)
                for i, req in enumerate(reqs):
                    n, seq = len(req.tokens), seqs[i]
                    mine = logits[i, n - cut:n - cut + SERVE_NEW_TOKENS]
                    pin = PinnedRouting(routing_of(rec, cut, i, len(seq))) \
                        if moe else contextlib.nullcontext()
                    if moe:
                        rec.label = ("forward", req.req_id)
                    with pin:
                        fw, _ = forward(model, {"tokens": torch.tensor(
                            [seq], device=dev)}, ssm_chunk=len(seq))
                    want = fw[0, n - 1:n - 1 + SERVE_NEW_TOKENS,
                              :cfg.vocab_size]
                    require(mine.shape == want.shape
                            and bool(torch.isfinite(mine).all()
                                     & torch.isfinite(want).all()),
                            f"request {req.req_id}: logits {mine.shape} "
                            f"against {want.shape}, or not finite")
                    delta = (mine - want).abs()
                    max_err = max(max_err, float(delta.max()))
                    deltas.append(delta.flatten()[::97])
                    held[req.req_id] = {"prompt": n, "prefill": cut,
                                        "teacher_forced": len(seq) - cut,
                                        "max_abs_err": float(delta.max())}
                    if moe:
                        rerouted += pin.differ
                        lost = int(rec.lost(("forward", req.req_id),
                                            moe_layers(cfg)).sum())
                        require(lost == 0, f"request {req.req_id}: the "
                                f"drop-free forward dropped {lost}")
            if moe:
                for cut in groups:
                    lost = int(rec.lost(("prefill", cut),
                                        moe_layers(cfg)).sum())
                    require(lost == 0, f"the drop-free prefill of length "
                            f"{cut} dropped {lost} assignments")
    finally:
        model.cfg = cfg
    torch.cuda.synchronize()
    sample = torch.cat(deltas).double()
    require(max_err <= LOGIT_TOL, f"teacher-forced decode differs from the "
            f"forward by up to {max_err} > {LOGIT_TOL}")
    out = {"max_abs_logit_err": max_err,
           "abs_err_rms": float(sample.square().mean().sqrt()),
           "positions": SERVE_NEW_TOKENS * len(held),
           "prefill_batches": {str(c): len(r) for c, r in
                               sorted(groups.items())},
           "decode_steps": decoded, "seconds": time.perf_counter() - t0,
           "held_by_request": held}
    if moe:
        out["rerouted_by_pinning"] = rerouted
    return out


def greedy_check(res: dict, dev) -> dict:
    """For the request with the shortest prompt: the greedy continuation
    of its prompt (``prefill_step`` of its longest allowed prefix, the rest
    of the prompt teacher-forced, then its own argmax fed back) beside the
    engine's tokens. They are not expected to be equal for a recurrent
    model (the padded prefill, ROADMAP Queue 3)."""
    import torch
    from repro_torch.models import decode_step, init_decode_state, \
        prefill_step
    cfg, model = res["cfg"], res["model"]
    req = min(res["done"], key=lambda r: len(r.tokens))
    n = len(req.tokens)
    cut = prefill_length(cfg, n)
    toks = torch.tensor([req.tokens], dtype=torch.int32, device=dev)
    state = init_decode_state(cfg, 1, n + SERVE_NEW_TOKENS, dev)
    lg, state = prefill_step(model, state, {"tokens": toks[:, :cut]},
                             ssm_chunk=cut)
    for pos in range(cut, n):
        lg, state = decode_step(model, state, toks[:, pos:pos + 1])
    greedy = []
    for _ in range(SERVE_NEW_TOKENS):
        nxt = lg[:, -1, :cfg.vocab_size].argmax(-1)
        greedy.append(int(nxt))
        lg, state = decode_step(model, state,
                                nxt[:, None].to(torch.int32))
    first = next((i for i, (a, b) in enumerate(zip(greedy, req.output))
                  if a != b), None)
    return {"request": req.req_id, "prompt": n, "equal": greedy == req.output,
            "first_difference": first, "engine_first8": req.output[:8],
            "greedy_first8": greedy[:8]}


def drop_free(cfg):
    """``cfg`` with a MoE capacity factor of E / top_k: no assignment is
    dropped (``cfg`` itself without MoE)."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def rounding_floor(res: dict, dev) -> dict:
    """How far the served model's own ``forward`` moves with the batch it
    runs in: the request with the shortest prompt alone and beside its
    reversed copy (other GEMM shapes, the same arithmetic), max |Δ| and rms
    of the logits at its generated positions. A MoE model runs drop-free
    and unpinned, so a top-k that flips counts too."""
    import torch
    from repro_torch.models import forward
    cfg, model = res["cfg"], res["model"]
    req = min(res["done"], key=lambda r: len(r.tokens))
    n, seq = len(req.tokens), req.tokens + req.output[:-1]
    toks = torch.tensor([seq, seq[::-1]], device=dev)
    model.cfg = drop_free(cfg)
    try:
        alone, _ = forward(model, {"tokens": toks[:1]}, ssm_chunk=len(seq))
        pair, _ = forward(model, {"tokens": toks}, ssm_chunk=len(seq))
    finally:
        model.cfg = cfg
    held = slice(n - 1, n - 1 + SERVE_NEW_TOKENS)
    delta = (alone[0, held, :cfg.vocab_size]
             - pair[0, held, :cfg.vocab_size]).abs()
    return {"request": req.req_id, "max_abs": float(delta.max()),
            "rms": float(delta.square().mean().sqrt())}


def recurrent_phase(dev, cfg, card: str, name: str) -> dict:
    """Serve the 8 requests with a recurrent model (jamba cut to one
    pattern period, or xlstm) through ``serve_phase`` (launches counted
    there), check K4's route, print the greedy line, the model's bf16
    rounding floor (``rounding_floor``) and, for a MoE model, the drops;
    then cast the model to fp32 (exactly: every bf16 value is an fp32
    value), hold it at the model level there (``check_recurrent``) and
    free it. Returns the phase's numbers without the model.

    Why fp32: in bf16 the two paths the check compares differ by bf16
    rounding amplified through the layers, which at random weights reaches
    the tolerance. On an H100 jamba's bf16 check gave 0.143 and 0.156 in
    two builds and xlstm's 1.59, while each model's own bf16 forward moved
    by 1.35-3.09 (jamba, unpinned) and 1.16-3.95 (xlstm) between batch 1
    and batch 2 of one sequence (``rounding_floor``, printed in every run).
    In fp32 jamba's check gave 5.5e-5 and xlstm's 0.0127."""
    import dataclasses

    import torch
    from repro_torch.kernels import attention as A
    moe = cfg.moe is not None
    before = {k: set(v) for k, v in A.SHAPES.items()}
    seconds, t0 = {}, time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t0
        seconds[what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    res = serve_phase(dev, cfg, rec=MoeRecorder() if moe else None)
    lap("serve")
    shapes = {k: A.SHAPES[k] - before[k] for k in A.SHAPES}
    require(all(sh[-1] == "tc" for sh in shapes["flash_attention"]),
            f"a {name} prefill took K4's CUDA-core route: "
            f"{sorted(shapes['flash_attention'])}")
    greedy = greedy_check(res, dev)
    print(f"serve {name} greedy: the engine's tokens against the greedy "
          f"continuation of the prompt (not expected equal: the engine "
          f"prefills padded to max_seq, ROADMAP Queue 3): "
          f"{json.dumps(greedy)}")
    lap("greedy")
    floor = rounding_floor(res, dev)
    print(f"serve {name} bf16 rounding floor (its forward at batch 1 against"
          f" batch 2): {json.dumps(floor)} [{card}]")
    lap("rounding_floor")
    if moe:
        print(f"serve {name} capacity drops: {json.dumps(res['drops'])} (a "
              f"decode step dropped none) [{card}]")
    print(f"serve {name} attention shapes: "
          f"{ {k: sorted(v) for k, v in shapes.items()} }")
    res["model"] = res["model"].float()
    res["model"].cfg = res["cfg"] = dataclasses.replace(cfg, dtype="float32")
    tf = check_recurrent(res, dev)
    lap("check")
    res["cfg"] = cfg
    print_serve(res, tf, f"serve {name}", f"{name} model-level (fp32) ",
                card)
    print(f"serve {name}: {cfg.num_layers} of {PUBLISHED[cfg.name][0]} "
          f"layers; seconds by part {json.dumps(seconds)} [{card}]")
    for k in ("model", "recorder", "steps"):
        res.pop(k, None)
    # the engine and serve_phase's recording hooks hold each other (and
    # the model): a cycle, which only the collector frees
    gc.collect()
    torch.cuda.empty_cache()
    return res


def recurrent_profiles(dev, cfg, name: str, card: str) -> None:
    """A recurrent model on the weights ``serve_phase`` makes for it (seed
    0), outside the counted runs: eight decode steps and one prefill wave
    under ``torch.profiler`` (``profile_decode``, ``profile_prefill``)
    and, for a MoE model, its dispatch on K2 held bit-exact and timed at
    its shapes (``check_moe_dispatch``); the model freed after. The
    script runs these before the recurrent phases: on an H100 every
    profiler trace taken after those phases came back empty (after jamba's
    fp32 check at once and for good; K2, K4 and K5 at that check's shapes
    alone, or a full card, left the profiler working)."""
    import torch
    from repro_torch.models import init_lm
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"cfg": cfg, "model": init_lm(cfg, gen, dev),
           "prompts": serve_prompts(cfg)}
    for what, fn in (("decode", profile_decode), ("prefill",
                                                  profile_prefill)):
        t0 = time.perf_counter()
        prof = fn(res, dev)
        print(f"profile serve {name} {what} ({SERVE_BATCH}x"
              f"{SERVE_SEQ if what == 'prefill' else 1} tokens, profiler "
              f"on, {time.perf_counter() - t0:.2f} s): {json.dumps(prof)} "
              f"[{card}]")
    if cfg.moe is not None:
        gen.manual_seed(1)
        print(f"moe dispatch on K2 ({name}): bit-exact against its plain "
              f"version, its layer within bf16 tolerance: "
              f"{json.dumps(check_moe_dispatch(dev, gen, res))} [{card}]")
    del res
    torch.cuda.empty_cache()


# -- train phase ------------------------------------------------------------------


def _k4b_case(dev, gen, shape):
    """K4b's inputs at ``(B, S, H, K, hd, dtype, causal[, route])``: random
    q, k, v and d_out, and ``out`` and each row's ``lse`` from one K4 call,
    as the training forward saves them: ``(q, k, v, out, d_out, causal,
    lse)``, the autograd backward's call."""
    from repro_torch.kernels import attention as A
    b, s, h, kh, hd, dt, causal = shape[:7]
    q, d_out = (_randn(gen, (b, s, h, hd), dt, dev) for _ in range(2))
    k, v = (_randn(gen, (b, s, kh, hd), dt, dev) for _ in range(2))
    out, lse = A.flash_attention_with_lse(q, k, v, causal)
    return q, k, v, out, d_out, causal, lse


def hold_k4b(dev, gen, shape) -> tuple[float, float]:
    """K4b at ``shape`` against its plain version on the same inputs: each
    of dq, dk, dv within ``K4B_TOL`` times the plain gradient's largest
    magnitude, on the route the shape names (where it names one); two calls
    bit-equal. Returns (max |err|, the largest error over that
    magnitude)."""
    from repro_torch.kernels import attention as A, ref
    args = _k4b_case(dev, gen, shape)
    A.SHAPES["flash_attention_bwd"].clear()
    got = A.flash_attention_bwd(*args)
    took = [sh[-1] for sh in A.SHAPES["flash_attention_bwd"]]
    require(len(shape) < 8 or took == [shape[7]],
            f"K4b took {took} at {shape}")
    again = A.flash_attention_bwd(*args)
    require(all(bits_equal(a, b) for a, b in zip(got, again)),
            f"K4b's gradients at {shape} differ between two calls")
    want = ref.flash_attention_bwd_ref(*args[:6])
    err, rel = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"K4b {name}: {g.shape} {g.dtype}, plain {w.shape} {w.dtype}")
        e = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        err, rel = max(err, e), max(rel, e / scale)
        require(e <= K4B_TOL[shape[5]] * scale,
                f"K4b {name} differs from its plain version at {shape}: max "
                f"|err| {e} > {K4B_TOL[shape[5]]} x {scale}")
    return err, rel


def _k4b_bound(shape) -> tuple[float, str]:
    """K4b's bound: its five products (Q K^T recomputed, dO V^T, P^T dO,
    dS K, dS^T Q; 5 x 2 B H S^2 hd, halved when causal) at the rate of the
    dtype, or its bytes (q, o, dO read and dq written with H heads, k, v
    read and dk, dv written with K) at the memory rate."""
    b, s, h, kh, hd, dt, causal = shape[:7]
    elem = 2 if dt == "torch.bfloat16" else 4
    flops = 5 * 2.0 * b * h * s * s * hd / (2 if causal else 1)
    nbytes = (4 * b * s * h + 4 * b * s * kh) * hd * elem
    return bound_ms(nbytes, flops, BF16_OPS_PER_S if elem == 2
                    else FP32_OPS_PER_S)


def _sdpa_backward(args):
    """The library's attention backward alone on K4b's inputs: SDPA's
    forward (outside the timed window) and a function that runs its
    backward."""
    import torch
    import torch.nn.functional as F
    q, k, v, _, d_out, causal = args[:6]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)
    go = d_out.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                       retain_graph=True)


def check_k4b(dev, gen, main_shapes, card: str) -> dict:
    """K4b within ``K4B_TOL`` of its plain version, on the route each shape
    names and bit-equal run to run, at the train phases' shapes and at
    llama's and granite's training shapes, one fp32 case at hd 128 and
    ragged S (causal and full) on both routes; each of the last five timed
    as the autograd backward calls it, with K4's lse got once outside the
    window (call ms, median of 20; device ms), beside its bound, the
    library's attention backward and the earlier design's time. Returns the
    kernel row at llama's shape."""
    from repro_torch.kernels import attention as A, ref
    cases = [(4, 1024, 24, 8, 128, "torch.bfloat16", True, "tc"),
             (4, 1024, 16, 8, 64, "torch.bfloat16", True, "tc"),
             (1, 512, 8, 4, 128, "torch.float32", True, "simt"),
             (2, 200, 6, 2, 128, "torch.bfloat16", True, "tc"),
             (1, 300, 4, 4, 64, "torch.bfloat16", False, "tc")]
    edges = [(3, 130, 6, 2, 32, "torch.bfloat16", True, "simt"),
             (1, 77, 2, 2, 8, "torch.float32", False, "simt"),
             (2, 65, 3, 1, 16, "torch.float32", True, "simt"),
             (1, 3, 3, 1, 128, "torch.bfloat16", True, "tc"),
             (2, 129, 6, 3, 64, "torch.bfloat16", False, "tc")]
    err = 0.0
    for shape in sorted(main_shapes) + edges:
        err = max(err, hold_k4b(dev, gen, shape)[0])
    row = None
    for shape in cases:
        e, rel = hold_k4b(dev, gen, shape)
        err = max(err, e)
        args = _k4b_case(dev, gen, shape)
        lib = _sdpa_backward(args)
        bnd, by = _k4b_bound(shape)
        dev_ms, by_kernel = device_ms_by_kernel(
            lambda: A.flash_attention_bwd(*args))
        r = {"ms": median_ms(lambda: A.flash_attention_bwd(*args)),
             "device_ms": dev_ms,
             "plain_ms": median_ms(
                 lambda: ref.flash_attention_bwd_ref(*args[:6])),
             "library_ms": median_ms(lib), "library_device_ms": device_ms(lib),
             "bound_ms": bnd, "bound_by": by, "rel_err": rel}
        b, s, h, kh, hd, dt, causal, route = shape
        earlier = (f", {K4B_EARLIER_MS} device ms on the CUDA cores before"
                   if shape == cases[0] else "")
        print(f"kernel flash_attention_bwd (B={b} S={s} H={h} K={kh} hd={hd}"
              f" {dt} causal={causal}, route {route}): {r['ms']:.4f} ms, "
              f"device time {r['device_ms']:.4f} ms{earlier}, plain "
              f"{r['plain_ms']:.4f} ms, library backward "
              f"{r['library_ms']:.4f} ms (device "
              f"{r['library_device_ms']:.4f} ms), bound {bnd:.4f} ms ({by}), "
              f"max |err| / max |grad| {rel:.3g}, device ms a call by "
              f"kernel {json.dumps(by_kernel)} [{card}]")
        if row is None:
            row = {"name": "flash_attention_bwd", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/"
                             "flash_attention_bwd.cu",
                   # the kernel whose gradient it is: the reference has
                   # no Pallas backward (XLA differentiates its attention)
                   "replaces": "src/repro/kernels/flash_attention.py:72",
                   "ms": r["ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": bnd, "bound_by": by,
                   "library_ms": r["library_ms"],
                   "device": {"ms": r["device_ms"],
                              "library_ms": r["library_device_ms"]},
                   "shape": f"B={b} S={s} H={h} K={kh} hd={hd} {dt} "
                            f"causal={causal}"}
    row["max_abs_err"] = err
    return row


def _train_inputs(cfg, dev, batch: int, seq: int):
    """A ``ShapeConfig`` of ``batch`` x ``seq`` and batch 0 of the port's
    ``SyntheticSource(seed=1)`` on ``dev``."""
    import torch
    from repro_torch.core.config import ShapeConfig
    from repro_torch.data import SyntheticSource
    shape = ShapeConfig("chip_train", seq, batch, "train")
    src = SyntheticSource(cfg, shape, seed=1)
    return shape, {k: torch.from_numpy(v).to(dev)
                   for k, v in src.batch(0).items()}


def _fresh_state(cfg, dev) -> dict:
    """The model at ``cfg`` with random weights from seed 0 on ``dev``, its
    gradients on, and a fresh AdamW state."""
    import torch
    from repro_torch.models import init_lm
    from repro_torch.training import init_train_state
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return init_train_state(cfg, init_lm(cfg, gen, dev))


def _release() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def profile_train_step(step, state, batch) -> dict:
    """One more train step under ``torch.profiler``: its wall, device-busy
    time, idle share, costliest device ops, and K4's and K4b's shares of
    the busy time."""
    import torch
    from torch.autograd import DeviceType

    def body(_):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, wall = traced(body)
    busy_us, top = device_busy(prof, top=8)

    def share(names) -> float:
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(n in e.key for n in names))
        return us / busy_us

    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "k4_share": share(("flash_tc_kernel", "flash_kernel")),
            "k4b_share": share(K4B_KERNELS), "top_device_ms": top}


def train_phase(dev, arch: str, steps: int, card: str,
                microbatch_check: bool = False) -> dict:
    """Train ``arch`` at its published config, not cut (random weights from
    seed 0, AdamW at lr 3e-4 with no warmup, ``remat="block"``) on one
    fixed batch of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, with the
    counters set to 0 just before and read just after: one untimed step
    whose gradients are held (every leaf finite and not all zero), then
    ``steps`` timed ones (host clock ending in a synchronize). K4 runs
    twice an attention layer a step (forward and recompute) on its
    tensor-core route, K4b once, K2 twice a MoE layer. Every loss and norm
    finite, the loss falling. Then one profiled step and, with
    ``microbatch_check``, one step of two microbatches from a fresh state,
    whose loss must be the first step's within ``MB_LOSS_RTOL``. Frees
    the model."""
    import torch
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.training import apply_updates, make_train_step
    from repro_torch.training.train_step import make_grad_fn

    cfg = serve_config(arch)
    shape, batch = _train_inputs(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=0)
    pc = ParallelConfig(remat="block")
    t0 = time.perf_counter()
    state = _fresh_state(cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state["params"]
    named = dict(model.named_parameters())
    step = make_train_step(cfg, shape, opt_cfg, pc)
    before = {k: set(v) for k, v in A.SHAPES.items()}
    start_bytes = int(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    K.reset_launches()
    loss, metrics, grads = make_grad_fn(cfg, pc)(model, batch)
    bad = [k for k, g in grads.items()
           if not (bool(torch.isfinite(g).all()) and bool(g.any()))]
    require(not bad, f"{arch}: leaves whose first gradient is not finite or "
            f"all zero: {bad}")
    routers = [k for k in grads if k.endswith("ffn.router")]
    require(len(routers) == moe_layers(cfg),
            f"{arch}: {len(routers)} routers for {moe_layers(cfg)} MoE "
            f"layers")
    _, state["opt"], opt_metrics = apply_updates(named, grads, state["opt"],
                                                 opt_cfg)
    del grads
    losses = [float(loss)]
    norms = [float(opt_metrics["grad_norm"])]
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = {**A.LAUNCHES, **K.LAUNCHES}
    peak = int(torch.cuda.max_memory_allocated())
    n, attn, moe = steps + 1, attention_layers(cfg), moe_layers(cfg)
    want = {"flash_attention": 2 * attn * n, "flash_attention_bwd": attn * n,
            "decode_attention": 0, "partition_scatter": 2 * moe * n,
            "partition_histogram": 0, "fused_probe": 0}
    require(launches == want, f"{arch} training: launches {launches} for "
            f"{n} steps, expected {want}")
    shapes = {k: A.SHAPES[k] - before[k] for k in A.SHAPES}
    require(all(sh[-1] == "tc" for name in ("flash_attention",
                                            "flash_attention_bwd")
                for sh in shapes[name]),
            f"{arch} training took a CUDA-core route: {shapes}")
    # K4b's launches at the step's attention shape all took the tensor cores
    key = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, "torch.bfloat16", True)
    took = {sh[-1] for sh in A.SHAPES["flash_attention_bwd"] if sh[:7] == key}
    require(took == {"tc"}, f"{arch} training: K4b at {key} took {took}")
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"{arch}: losses {losses}, grad norms {norms}")
    require(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
            f"{losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_ms": step_ms,
           "tokens_per_s": tokens / (np.median(step_ms) / 1e3),
           "peak_bytes": peak, "start_bytes": start_bytes,
           "launches": launches, "shapes": shapes}
    res["profile"] = profile_train_step(step, state, batch)
    del state, model, named, step, metrics
    _release()
    if microbatch_check:
        state = _fresh_state(cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        step2 = make_train_step(cfg, shape, opt_cfg, ParallelConfig(
            remat="block", microbatches=2))
        _, m2 = step2(state, batch)
        loss2 = float(m2["loss"])
        res["microbatches_2"] = {
            "loss": loss2, "first_step_loss": losses[0],
            "rel_diff": abs(loss2 - losses[0]) / abs(losses[0]),
            "peak_bytes": int(torch.cuda.max_memory_allocated())}
        require(res["microbatches_2"]["rel_diff"] <= MB_LOSS_RTOL,
                f"{arch}: two microbatches' loss {loss2} against one "
                f"batch's {losses[0]}")
        del state, step2, m2
        _release()
    print(f"train {arch}: {n} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens "
          f"(the first untimed), step ms {[round(x, 2) for x in step_ms]}, "
          f"{res['tokens_per_s']:.1f} tokens/s at the median step, peak "
          f"max_memory_allocated {peak} B ({start_bytes} B allocated with "
          f"the weights and optimizer state), init {init_s:.2f} s [{card}]")
    print(f"train {arch} losses {[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 5) for x in norms]}, launches {launches} [{card}]")
    print(f"train {arch} profiled step: {json.dumps(res['profile'])} "
          f"[{card}]")
    if microbatch_check:
        print(f"train {arch} two microbatches from a fresh state: "
              f"{json.dumps(res['microbatches_2'])} [{card}]")
    return res


def grad_hold(dev, card: str) -> dict:
    """llama3.2-3b at full width cut to ``GRAD_HOLD_LAYERS`` layers, in
    fp32, one batch of 1 x ``GRAD_HOLD_SEQ`` tokens: the card's gradients
    (K4's and K4b's fp32 CUDA-core routes, ``remat="block"``) against the
    same model's on the CPU through the plain versions, each leaf within
    ``GRAD_HOLD_TOL`` relative (|g_card - g_cpu| / |g_cpu|, Frobenius).
    Outside the counted runs: the shapes it launches at are not kept."""
    import copy
    import dataclasses

    import torch
    from repro_torch.core.config import ParallelConfig
    from repro_torch.kernels import attention as A
    from repro_torch.models import init_lm
    from repro_torch.training.train_step import make_grad_fn

    cfg = dataclasses.replace(serve_config(SERVE_ARCH),
                              num_layers=GRAD_HOLD_LAYERS, dtype="float32")
    saved = shape_sets()
    cpu_model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    for m in (cpu_model, card_model):
        for p in m.parameters():
            p.requires_grad_(True)
    _, batch = _train_inputs(cfg, "cpu", 1, GRAD_HOLD_SEQ)
    grad_fn = make_grad_fn(cfg, ParallelConfig(remat="block"))
    t0 = time.perf_counter()
    loss_cpu, _, g_cpu = grad_fn(cpu_model, batch)
    cpu_s = time.perf_counter() - t0
    bwd_before = set(A.SHAPES["flash_attention_bwd"])
    loss_card, _, g_card = grad_fn(card_model, batch)
    took = A.SHAPES["flash_attention_bwd"] - bwd_before
    require(took and all(sh[-1] == "simt" for sh in took),
            f"the fp32 gradient hold's K4b launches took {sorted(took)}, "
            f"not its CUDA-core route")
    rel = {k: float((g_card[k].cpu().double() - g.double()).norm()
                    / g.double().norm()) for k, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    res = {"layers": GRAD_HOLD_LAYERS, "seq": GRAD_HOLD_SEQ,
           "loss_cpu": float(loss_cpu), "loss_card": float(loss_card),
           "max_rel_err": rel[worst], "leaf": worst, "leaves": len(rel),
           "cpu_s": cpu_s}
    print(f"train grad hold (llama3.2-3b, {GRAD_HOLD_LAYERS} layers at full "
          f"width, fp32): {json.dumps(res)} (tolerance {GRAD_HOLD_TOL}) "
          f"[{card}]")
    require(rel[worst] <= GRAD_HOLD_TOL,
            f"the card's gradient of {worst} differs from the CPU's by "
            f"{rel[worst]}")
    del cpu_model, card_model, g_cpu, g_card
    restore_shape_sets(saved)
    _release()
    return res


def shape_sets() -> dict:
    """A copy of every kernel's recorded launch shapes (K1-K5)."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    return {k: set(v) for k, v in {**K.SHAPES, **A.SHAPES}.items()}


def restore_shape_sets(saved: dict) -> None:
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    for shapes in (K.SHAPES, A.SHAPES):
        for k in shapes:
            shapes[k].clear()
            shapes[k] |= saved[k]


def hold_late_shapes(dev, gen, late: dict) -> dict:
    """K2, K4, K4b and K5 held against their plain versions at the shapes
    in ``late`` (the recurrent and frontends phases' launches; they launch
    no K1, K3 or K4b); the max |err| of each kernel."""
    require(not late["partition_histogram"] and not late["fused_probe"],
            f"K1 or K3 launched: {late}")
    return {"partition_histogram": 0.0, "fused_probe": 0.0,
            "partition_scatter": max(
                [0.0] + [hold_k2(dev, gen, n, p)
                         for n, p in sorted(late["partition_scatter"])]),
            "flash_attention": max(
                [0.0] + [hold_k4(dev, gen, sh)
                         for sh in sorted(late["flash_attention"])]),
            "flash_attention_bwd": max(
                [0.0] + [hold_k4b(dev, gen, sh)[0]
                         for sh in sorted(late["flash_attention_bwd"])]),
            "decode_attention": max(
                [0.0] + [hold_k5(dev, gen, sh)
                         for sh in sorted(late["decode_attention"])])}


def frontends_phase(dev, card: str) -> dict:
    """internvl2-1b (256 stub patches before 256 tokens) and
    musicgen-medium (frame embeddings added to 512 tokens), each at its
    full config with random weights from seed 0: one ``forward`` and one
    ``prefill_step`` of ``FRONTEND_BATCH`` sequences on the card, with the
    attention launch counters set to 0 before each call and read after it
    (K4 once a layer, on its tensor-core route, K5 never); the prefill's
    last-position logits held to the forward's within ``LOGIT_TOL``, both
    finite. Each model is freed when it is done."""
    import torch
    from repro_torch.configs.common import concrete_inputs
    from repro_torch.core.config import ShapeConfig
    from repro_torch.kernels import attention as A
    from repro_torch.models import forward, init_decode_state, init_lm, \
        prefill_step
    out = {"launches": {k: 0 for k in A.LAUNCHES},
           "shapes": {k: set() for k in A.SHAPES}}
    shape = ShapeConfig("frontends", FRONTEND_SEQ, FRONTEND_BATCH, "prefill")
    for arch in FRONTEND_ARCHS:
        cfg = serve_config(arch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = init_lm(cfg, gen, dev)
        inputs = concrete_inputs(cfg, shape, gen, dev)
        before = {k: set(v) for k, v in A.SHAPES.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = {}
        for what in ("forward", "prefill"):
            A.reset_launches()
            t0 = time.perf_counter()
            if what == "forward":
                logits, _ = forward(model, inputs)
                last = logits[:, -1]
            else:
                state = init_decode_state(cfg, FRONTEND_BATCH, FRONTEND_SEQ,
                                          dev)
                logits, state = prefill_step(model, state, inputs)
                last = logits[:, 0]
                require(bool((state["pos"] == FRONTEND_SEQ).all()),
                        f"{arch}: prefill left positions {state['pos']}")
            torch.cuda.synchronize()
            row[f"{what}_ms"] = (time.perf_counter() - t0) * 1e3
            launches = dict(A.LAUNCHES)
            require(launches == {"flash_attention": cfg.num_layers,
                                 "flash_attention_bwd": 0,
                                 "decode_attention": 0},
                    f"{arch} {what}: launches {launches}")
            for k, v in launches.items():
                out["launches"][k] += v
            row[what] = last[:, :cfg.vocab_size].float()
        require(logits.shape[0] == FRONTEND_BATCH, f"{arch}: {logits.shape}")
        shapes = {k: A.SHAPES[k] - before[k] for k in A.SHAPES}
        require(all(sh[-1] == "tc" for sh in shapes["flash_attention"]),
                f"{arch} took K4's CUDA-core route: {shapes}")
        for k in shapes:
            out["shapes"][k] |= shapes[k]
        f, p = row.pop("forward"), row.pop("prefill")
        require(bool(torch.isfinite(f).all() & torch.isfinite(p).all()),
                f"{arch}: non-finite logits")
        err = float((f - p).abs().max())
        require(err <= LOGIT_TOL, f"{arch}: prefill's last logits differ "
                f"from the forward's by {err} > {LOGIT_TOL}")
        row.update(max_abs_err=err, k4_per_call=cfg.num_layers,
                   peak_bytes=int(torch.cuda.max_memory_allocated()),
                   inputs={k: list(v.shape) for k, v in inputs.items()})
        print(f"frontends {arch}: {json.dumps(row)} (tolerance {LOGIT_TOL})"
              f" [{card}]")
        del model, inputs, logits, state, f, p, last
        torch.cuda.empty_cache()
    return out


def print_serve(res: dict, tf: dict, prefix: str, tf_prefix: str,
                card: str) -> None:
    dms = np.asarray(res["decode_ms"])
    print(f"serve {res['cfg'].name}: {len(res['done'])} requests finished, "
          f"{res['generated']} tokens in {res['wall_s']:.3f} s, "
          f"{res['generated'] / res['wall_s']:.1f} tokens/s "
          f"(init {res['init_s']:.2f} s, not timed) [{card}]")
    print(f"{prefix} decode: {res['decode_steps']} steps, median "
          f"{np.median(dms):.3f} ms/step, p90 {np.percentile(dms, 90):.3f} "
          f"ms/step [{card}]")
    print(f"{prefix} prefill: {res['prefills']} waves of {SERVE_BATCH}x"
          f"{SERVE_SEQ} tokens, ms per wave "
          f"{[round(x, 3) for x in res['prefill_ms']]} [{card}]")
    print(f"{prefix} peak max_memory_allocated: {res['peak_bytes']} B "
          f"({res['start_bytes']} B allocated when the run began) [{card}]")
    print(f"{prefix} launches: {res['launches']} [{card}]")
    print(f"{tf_prefix}teacher-forced check: {json.dumps(tf)} (tolerance "
          f"{LOGIT_TOL}) [{card}]")


def print_kernel_rows(rows, card: str) -> None:
    for r in rows:
        lib = r["device"]["library_ms"]
        extra = f", device time {r['device']['ms']:.4f} ms (library " + (
            "none)" if lib is None else f"{lib:.4f} ms)")
        if "device_ops_per_call" in r:
            extra += (f", device ops a call {len(r['device_ops_per_call'])}:"
                      f" {r['device_ops_per_call']}")
        if "checked_ms" in r:
            extra += f", with check_ids {r['checked_ms']:.4f} ms"
        if "second" in r:
            sec = r["second"]
            print(f"kernel {r['name']} ({sec['shape']}): {sec['ms']:.4f} ms, "
                  f"device time {sec['device_ms']:.4f} ms, bound "
                  f"{sec['bound_ms']:.4f} ms (bytes) [{card}]")
        print(f"kernel {r['name']} ({r['shape']}): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3g}{extra} [{card}]")


def print_query(res: dict, card: str) -> None:
    print(f"query {res['app']}: {res['fact_rows']} fact rows, wall "
          f"{res['wall_s']:.3f} s, {res['rows_per_s']:.0f} rows/s, peak "
          f"{res['peak_bytes']} B, max |err| {res['max_abs_err']:.3g}, "
          f"launches {res['launches']} [{card}]")
    print(f"  setup (not timed): {res['setup']}")
    print(f"  sequence: {res['sequence']}")
    print(f"  stages: {json.dumps(res['stages'])}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    # the run drives one card; the last line reports the cards it saw
    require(torch.cuda.device_count() == 1,
            f"needs exactly one visible card, sees {torch.cuda.device_count()}"
            " (set CUDA_VISIBLE_DEVICES)")
    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, log in build.BUILD_LOGS.items():
        print(f"nvcc {src}:\n{log.strip()}")
    sass = tensor_core_instructions(libs)
    print(f"tensor-core instructions in the SASS: {json.dumps(sass)}")
    if sass:
        require(sum(sass["flash_attention.cu"].values()) > 0,
                "K4's library has no HMMA or HGMMA instruction")
    card = card_line()
    print(f"card: {card}")

    from repro_torch.kernels import partition as K
    partition_before = {k: set(v) for k, v in K.SHAPES.items()}
    seconds = {}
    t0 = time.perf_counter()
    phases = [small_query(dev), large_query(dev)]
    seconds["queries"] = time.perf_counter() - t0
    for res in phases:
        print_query(res, card)
    print(f"phase queries: {seconds['queries']:.2f} s")

    t0 = time.perf_counter()
    sim = sim_plane(dev, phases[1])
    for res in phases:             # the large one's trace is replayed
        del res["runtime"]
    seconds["sim_plane"] = time.perf_counter() - t0
    print(f"sim_plane: calibrated rates (bytes/s) "
          f"{json.dumps(sim['rates'])} in {sim['calibrate_s']:.3f} s "
          f"[{card}]")
    print(f"sim_plane: planned smoke_large's 2^25-row tables in "
          f"{sim['plan_s']:.3f} s, launches {sim['launches']}, decisions "
          f"equal the runtime's: {sim['sequence']} [{card}]")
    print(f"sim_plane: simulated makespan {sim['planned_makespan_s']:.6f} s "
          f"(calibrated rates); trace replay of {sim['replayed_tasks']} "
          f"invocations: simulated makespan "
          f"{sim['replayed_makespan_s']:.6f} s against the measured wall "
          f"{sim['measured_wall_s']:.6f} s [{card}]")
    print(f"phase sim_plane: {seconds['sim_plane']:.2f} s")

    from repro_torch.kernels import attention as A
    before = {k: set(v) for k, v in A.SHAPES.items()}
    t0 = time.perf_counter()
    serve = serve_phase(dev, serve_config())
    tf = check_served_tokens(serve, dev)
    seconds["serve"] = time.perf_counter() - t0
    attn_shapes = {k: A.SHAPES[k] - before[k] for k in A.SHAPES}
    print_serve(serve, tf, "serve", "", card)
    print(f"main-path attention shapes: "
          f"{ {k: sorted(v) for k, v in attn_shapes.items()} }")
    print(f"phase serve: {seconds['serve']:.2f} s")
    # the same requests again on the same weights, now warm: the yardstick
    # of the serve run after the worker and scheduler phases below
    warm = serve_rate(serve_phase(dev, serve["cfg"], serve["model"]))
    warm.update(leftovers())

    # granite-moe-1b-a400m: K2 dispatches every MoE layer's experts
    before = {k: set(v) for k, v in A.SHAPES.items()}
    t0 = time.perf_counter()
    granite = serve_phase(dev, serve_config(MOE_ARCH), rec=MoeRecorder())
    granite_tf = check_served_tokens(granite, dev)
    seconds["serve_granite_moe_1b_a400m"] = time.perf_counter() - t0
    moe_shapes = {k: A.SHAPES[k] - before[k] for k in A.SHAPES}
    require(all(sh[-1] == "tc" for sh in moe_shapes["flash_attention"]),
            f"a {MOE_ARCH} prefill took K4's CUDA-core route: "
            f"{sorted(moe_shapes['flash_attention'])}")
    print_serve(granite, granite_tf, f"serve {MOE_ARCH}", f"{MOE_ARCH} ",
                card)
    print(f"serve {MOE_ARCH} capacity drops: {json.dumps(granite['drops'])}"
          f" (a decode step dropped none) [{card}]")
    print(f"serve {MOE_ARCH} attention shapes: "
          f"{ {k: sorted(v) for k, v in moe_shapes.items()} }")
    print(f"phase serve_granite_moe_1b_a400m: "
          f"{seconds['serve_granite_moe_1b_a400m']:.2f} s")
    for k in attn_shapes:
        attn_shapes[k] |= moe_shapes[k]

    t0 = time.perf_counter()
    proc = process_query(dev, phases[1])
    seconds["process_query"] = time.perf_counter() - t0
    print_query(proc, card)
    pool = proc["pool"]
    print(f"process_query: {PROCESS_WORKERS} workers at most, peak pool "
          f"{pool['peak_size']}, cold starts {pool['cold_starts']} (mean "
          f"{proc['mean_cold_start_s']:.3f} s), warm hits "
          f"{pool['warm_hits']}, function-seconds "
          f"{pool['cost_function_seconds']:.3f} (busy "
          f"{pool['busy_seconds']:.3f}, provision "
          f"{pool['provision_seconds']:.3f}), worker launches "
          f"{proc['worker_launches']}, card memory used at most "
          f"{proc['gpu_memory_used_peak_mib']} MiB; threads wall "
          f"{phases[1]['wall_s']:.3f} s [{card}]")
    print(f"process_query split: {json.dumps(proc['split'])} [{card}]")
    print(f"phase process_query: {seconds['process_query']:.2f} s")

    t0 = time.perf_counter()
    mix = scheduler_mix(dev)
    seconds["scheduler_mix"] = time.perf_counter() - t0
    print(f"scheduler_mix: {MIX_QUERIES} queries of {MIX_ROWS} fact rows, "
          f"priorities {list(MIX_PRIORITIES)} (tables and oracles "
          f"{mix['setup_s']:.2f} s, not timed) [{card}]")
    for policy, r in mix["policies"].items():
        print(f"scheduler_mix {policy}: makespan {r['makespan_s']:.4f} s, "
              f"priority-10 latencies "
              f"{[round(x, 4) for x in r['hi_latencies_s']]} s, all "
              f"{[round(x, 4) for x in r['all_latencies_s']]} s, max |err| "
              f"{r['max_abs_err']:.3g}, launches {r['launches']} [{card}]")
    print(f"phase scheduler_mix: {seconds['scheduler_mix']:.2f} s")
    # does anything the worker and scheduler phases leave behind slow
    # later work? The same warm serve run again, in this process
    after = leftovers()
    require(not after["children"],
            f"worker processes outlived their invoker: {after['children']}")
    t0 = time.perf_counter()
    after.update(serve_rate(serve_phase(dev, serve["cfg"], serve["model"])))
    seconds["serve_again"] = time.perf_counter() - t0
    print(f"serve again: warm before the worker and scheduler phases "
          f"{json.dumps(warm)}; after them {json.dumps(after)}; ratio of "
          f"tokens/s {after['tokens_per_s'] / warm['tokens_per_s']:.4f} "
          f"[{card}]")
    main_shapes = {k: K.SHAPES[k] - partition_before[k] for k in K.SHAPES}
    print(f"main-path kernel shapes: "
          f"{ {k: sorted(v) for k, v in main_shapes.items()} }")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = [check_k1(dev, gen, main_shapes["partition_histogram"]),
            check_k2(dev, gen, main_shapes["partition_scatter"]),
            check_k3(dev, gen, main_shapes["fused_probe"]),
            check_k4(dev, gen, attn_shapes["flash_attention"]),
            check_k5(dev, gen, attn_shapes["decode_attention"],
                     serve["decode_lengths"])]
    print_kernel_rows(rows, card)
    moe_check = check_moe_dispatch(dev, gen, granite)
    print(f"moe dispatch on K2 ({MOE_ARCH}): bit-exact against its plain "
          f"version, its layer within bf16 tolerance: "
          f"{json.dumps(moe_check)} [{card}]")
    prof = profile_query(dev, *phases[1]["tables"])
    print(f"profile smoke_large (second run, profiler on): "
          f"{json.dumps(prof)} [{card}]")
    prof = profile_decode(serve, dev)
    print(f"profile serve decode ({SERVE_BATCH} sequences, profiler on): "
          f"{json.dumps(prof)} [{card}]")
    prof = profile_prefill(serve, dev)
    print(f"profile serve prefill ({SERVE_BATCH}x{SERVE_SEQ} tokens, profiler "
          f"on): {json.dumps(prof)} [{card}]")
    prof = profile_decode(granite, dev)
    print(f"profile serve {MOE_ARCH} decode ({SERVE_BATCH} sequences, "
          f"profiler on): {json.dumps(prof)} [{card}]")
    prof = profile_prefill(granite, dev)
    print(f"profile serve {MOE_ARCH} prefill ({SERVE_BATCH}x{SERVE_SEQ} "
          f"tokens, profiler on): {json.dumps(prof)} [{card}]")
    cost = range_check_cost(granite, dev)
    print(f"serve {MOE_ARCH} range check: {json.dumps(cost)} [{card}]")

    # training: llama and granite at their published configs, after the
    # served models are freed and before the recurrent phases (after which
    # profiler traces came back empty)
    for res in (serve, granite):
        for k in ("model", "recorder", "steps"):
            res.pop(k, None)
    _release()
    train = {}
    for arch, mb_check in ((SERVE_ARCH, True), (MOE_ARCH, False)):
        t0 = time.perf_counter()
        train[arch] = train_phase(dev, arch, TRAIN_STEPS[arch], card,
                                  microbatch_check=mb_check)
        name = "train_" + arch.replace("-", "_").replace(".", "_")
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.2f} s")
    t0 = time.perf_counter()
    grad_hold(dev, card)
    seconds["train_grad_hold"] = time.perf_counter() - t0
    print(f"phase train_grad_hold: {seconds['train_grad_hold']:.2f} s")
    t0 = time.perf_counter()
    train_shapes = {k: set().union(*(t["shapes"][k] for t in train.values()))
                    for k in A.SHAPES}
    print(f"main-path attention shapes of the train phases: "
          f"{ {k: sorted(v) for k, v in train_shapes.items()} }")
    k4_new = train_shapes["flash_attention"] - attn_shapes["flash_attention"]
    rows[3]["max_abs_err"] = max([rows[3]["max_abs_err"]] + [
        hold_k4(dev, gen, sh) for sh in sorted(k4_new)])
    rows.append(check_k4b(dev, gen, train_shapes["flash_attention_bwd"],
                          card))
    print_kernel_rows(rows[-1:], card)
    seconds["train_kernel_checks"] = time.perf_counter() - t0

    # jamba at full width, one period of its pattern (Mamba, attention, MoE
    # on K2), then xlstm (mLSTM and sLSTM), then the stub frontends: after
    # everything above, which runs as it did before these existed; each
    # model freed at its phase's end. Their profiles come first, on the
    # weights made from seed 0 once more, and leave no shape behind
    # (``recurrent_profiles``): every profiler trace taken after these
    # phases came back empty on an H100
    import dataclasses
    recurrent_cfgs = {}
    for arch, cut in ((HYBRID_ARCH, HYBRID_LAYERS), (XLSTM_ARCH, None)):
        cfg = serve_config(arch)
        name = "serve_" + arch.replace("-", "_").replace(".", "_")
        if cut is not None:
            cfg = dataclasses.replace(cfg, num_layers=cut)
            name += f"_{cut}l"
        recurrent_cfgs[name] = (arch, cfg)
    before = shape_sets()
    for name, (arch, cfg) in recurrent_cfgs.items():
        t0 = time.perf_counter()
        recurrent_profiles(dev, cfg, arch, card)
        seconds[f"{name}_profiles"] = time.perf_counter() - t0
    restore_shape_sets(before)
    recurrent = {}
    for name, (arch, cfg) in recurrent_cfgs.items():
        t0 = time.perf_counter()
        recurrent[name] = recurrent_phase(dev, cfg, card, arch)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.2f} s")
    t0 = time.perf_counter()
    fronts = frontends_phase(dev, card)
    seconds["frontends"] = time.perf_counter() - t0
    print(f"phase frontends: {seconds['frontends']:.2f} s")
    # each kernel held against its plain version at every new shape these
    # phases launched it at (their checks' own among them)
    late = {k: v - before[k] for k, v in shape_sets().items()}
    print(f"main-path kernel shapes of the recurrent and frontends phases: "
          f"{ {k: sorted(v) for k, v in late.items()} }")
    late_err = hold_late_shapes(dev, gen, late)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"], late_err[r["name"]])

    # the main path's launches: the queries, the simulator's planning, the
    # process workers', the scheduler's, the serve phases and the frontends
    # (the teacher-forced checks' own are on their lines above)
    counted = [res["launches"] for res in phases] + [
        sim["launches"], proc["worker_launches"]] + [
        r["launches"] for r in mix["policies"].values()] + [
        serve["launches"], granite["launches"], fronts["launches"]] + [
        r["launches"] for r in recurrent.values()] + [
        t["launches"] for t in train.values()]
    for r in rows:
        r["launches"] = sum(c.get(r["name"], 0) for c in counted)
        for extra in ("shape", "device", "device_ops_per_call", "checked_ms",
                      "second"):
            r.pop(extra, None)
    print(json.dumps({"kernels": rows}))
    print(f"phase seconds: {json.dumps(seconds)}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
