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
   Then ``ckpt_train_llama3_2_3b``, with the counters set to 0 just
   before and read just after: ``llama3.2-3b`` at full width cut to 2 of
   its 28 layers, 4 x 1024 tokens a step from ``SyntheticSource(seed=1)``,
   6 steps uninterrupted and then from the same start under
   ``repro_torch.ckpt.Supervisor`` (a checkpoint every 3 steps, 2 kept,
   the starting state's first; a fault at step 4, so one restore of step
   3's), into a fresh temporary directory that must have room for three
   checkpoints and is removed after; every parameter and optimizer leaf
   held bit-equal to the uninterrupted run's, K4 twice and K4b once an
   attention layer a step. Prints the checkpoint's bytes, the host copy's,
   the write's and the load's seconds and GB/s and the free disk. Then
   ``repro_torch.launch.train.main`` at its smoke config (12 steps, a loss
   every 4, a checkpoint every 6), and ``--steps 6`` then ``--resume
   --steps 12``: the resumed losses of steps 8 and 12 bit-equal to the
   uninterrupted run's.
   Then the planner and the data plane of the mesh, each with the
   counters set to 0 just before its counted run and read just after:
   ``plan_cells`` runs the port's decision workflow
   (``parallel.strategies.build_workflow``) for all ten archs x the four
   ``SHAPES`` on the reference's 16 x 16 and 2 x 16 x 16 planning meshes
   and on this one card, priced with the H100's figures and the card's
   own memory, and requires every ``ParallelConfig`` field resolved
   (``mlp_mode`` as ``make_rules`` resolves it); one ``plan`` line per
   arch. ``plan_train_llama3_2_3b`` plans ``llama3.2-3b`` at its
   published config at 64 x 1024 tokens on this card, checks the rules
   executable and trains under the plan (its microbatch count the
   planner's): one untimed and two timed steps, K4 and K4b counted,
   every loss and norm finite, peak memory printed beside the plan's
   estimate, the plan's budget (``TRAIN_HBM_SHARE`` of the card's
   memory) and the card's memory; the peak must lie under the budget.
   ``dp_granite_moe_1b_a400m`` (granite cut to 2 of its 24 layers)
   spawns two ranks that share the card through ``gloo`` (a ``file://``
   rendezvous; ``data=2, model=1``), each planning the cell, taking 2 of
   the train phases' 4 x 1024 rows and running one untimed and one timed
   data-parallel step; held against one rank's step on the whole batch
   in this process (loss and global grad norm within 1e-2, both ranks'
   parameters bit-equal after the update); each rank's aux within 1e-5
   of the whole batch's aux of the ranks' router statistics gathered
   from the same forward, and one rank's own rows' aux outside 1e-5 of
   it; and the
   int8 all-reduce of each rank's gradients within 0.02 of each leaf's
   largest magnitude of the exact one, the ranks agreeing to 1e-6.
   Then tensor, sequence and ZeRO-3 parallelism, each phase two ranks
   that share the card through ``gloo`` (any rank's failure fails the
   run), each printing its step or decode ms, its collectives' calls,
   bytes and ms by kind, each rank's peak and its launches:
   ``tp_train_llama3_2_3b``: llama at full width cut to 2 of its 28
   layers (cut from 8 to keep the script inside its time since the
   expert-parallel and inner-split phases came in), the train phases' batch, ``data=1, model=2``: one step under
   ``seq_tp`` with ``mlp=model`` and one under ``mlp_seq`` with the int8
   KV wire (``kv_compress``), each held against the unsharded step on the
   same weights (loss and grad norm within 1e-2, the leaves each rank holds
   whole bit-equal across the ranks, the updated weights gathered within
   2 lr + 2^-7 of each leaf's largest weight, ``tp_param_bound``); K4 and
   K4b at query offsets 0 and 512 against 1024 keys. Then four ranks, one
   step under each of four hand-written layouts the reference runs
   (``TP_TRAIN_LAYOUTS``, ``sharding.LAYOUTS``: the sequence and the
   vocab over ``model`` beside the heads, kv heads and mlp over ``data``;
   the mlp over the batch's own ``data``; the heads and kv heads over
   ``("data", "model")`` beside the batch over ``data``; the kv heads over
   ``data`` beside the query heads over ``model``), held alike
   (``par_train_phase``). ``tp_decode_llama3_2_3b``: llama at its published config, four prompts
   of 64-512 tokens padded to 512, prefilled under ``seq_tp`` and decoded
   16 greedy steps under ``decode_kv_shard`` (heads, kv heads, ``mlp``,
   vocab and the cache's sequence over ``model``; K5 with its
   log-sum-exp on each rank's half of the cache), fed one rank's tokens
   and held to its logits (within 0.15, the argmax where its top two lie
   more than 0.3 apart). ``zero3_train_llama3_2_3b``: the 2-layer llama
   under ``pure_dp`` on ``data=2`` (``w_embed`` over both ranks), one
   step, and one under ``zero2`` with ``regather`` at 2 microbatches, each
   held against the unsharded step at the same microbatch count (loss and
   grad norm within 1e-2, each rank's slice of the fp32 master weights
   within 2 lr of the same slice). ``pp_tp_train_llama3_2_3b``: the
   GPipe pipeline over ``pod=2`` with splits inside its stages, four
   ranks sharing the card, llama cut to 2 layers (one a stage) on 8 x 1024
   tokens in 4 microbatches, one step under the rules of the planner's
   plan of llama's packing cell (``train_4k`` on 2 x 16 x 16 with the
   pipeline's pod role) on ``pod=2, model=2`` under the optimized
   profile (``seq_tp``, ``mlp_seq``) and the baseline one (``seq_tp``,
   ``mlp``), and one on ``pod=2, data=2`` with ``fsdp="on"`` (ZeRO-3
   inside the stages); each held against the unsharded step (loss and
   grad norm within 1e-2, every rank's shards within ``tp_param_bound``,
   every leaf held whole bit-equal on the ranks that hold it); the
   shifts are ``collective_permute``s. Then K4 and K4b at a query offset
   and K5 with its log-sum-exp are timed beside their default calls.
   K2, K4, K4b and K5 are then held at the shapes these phases added.
7. Profiles jamba and xlstm (the models of step 8, on the weights made
   from the same seed) the same way (xlstm's decode steps only),
   outside the counted runs, with the
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
   a wave and a step. ``serve_xlstm_1_3b_16l``: ``xlstm-1.3b`` at its
   full width cut to 16 of its 48 layers (two periods of 7 mLSTM : 1
   sLSTM, d_model 2048, 4 heads, vocab 50304), the same requests; no K1-K5 launch. Each is held at the model
   level: each request's prompt through ``prefill_step`` (its longest prefix that the
   mLSTM's prefill chunk of 256 takes, the rest teacher-forced), then its
   generated tokens teacher-forced through ``decode_step``, the logits at
   the 32 generated positions within ``LOGIT_TOL`` of one ``forward`` over
   the sequence (jamba drop-free and pinned to the routing its decode path
   chose), both on their weights cast to fp32: in bf16 each model's own
   forward moves by more than ``LOGIT_TOL`` between batch 1 and batch 2.
   Prints that bf16 rounding floor, whether the bf16 engine's tokens are
   the greedy continuation for one request, and jamba's drops. Then, on
   the fp32 weights, the engine (its padded prefill passing each row's
   length) serves that request alone, 8 new tokens, each held to the
   argmax of one teacher-forced ``forward`` wherever its top two logits
   lie more than 0.3 apart. ``frontends``: ``internvl2-1b`` (256 stub patches) and
   ``musicgen-medium`` (frame embeddings) at their full configs, batch 2,
   one ``forward`` and one ``prefill_step`` each, the last position's
   logits within ``LOGIT_TOL`` of each other, K4 once a layer in each
   call. Then K2, K4 and K5 are held against their plain versions at the
   shapes these phases added.
9. Expert parallelism and the Mamba / xLSTM inner split, last: each phase
   two ranks sharing the card through ``gloo``, held against one rank on
   the same weights, printing its step, prefill or decode ms, its
   collectives by kind (``all_to_all`` among them), each rank's peak and
   launches. ``ep_train_granite_moe_1b_a400m``: granite at full width cut
   to 2 of its 24 layers, drop-free (capacity factor E / top_k), the train phases'
   batch, one step under its 2 x 16 x 16 ``train_4k`` layout on ``data=1,
   model=2`` (``seq_tp``, ``mlp_seq``, vocab and experts over ``model``,
   the all-to-all dispatch on K2), one under its 16 x 16 ``pure_dp``
   layout on ``data=2`` (``shard_map_local``, ZeRO-3 over both ranks),
   one under its baseline ``all_to_all``, one with the experts on their
   mlp dimension, and on four ranks one with ``expert_act`` over ``data``
   beside the experts over ``model`` and one with the experts over the
   batch's own ``data`` (the last three hand-written layouts), held as
   ``tp_train`` holds llama, each rank's updated shards
   against the same shards of the unsharded step's; the drops of one
   forward at the model's capacity factor 1.25 printed, unsharded and
   under each layout, and the first MoE layer's drops on one input held
   to the unsharded layer's where the layout computes its chunks. ``ep_decode_moonshot_v1_16b_a3b``: moonshot at full width cut
   to 4 of its 48 layers, in fp32, prompts of 64-512 padded to 512,
   prefilled and decoded 32 steps under its ``decode_32k`` layout (the
   ``gather`` plane, K5 with its log-sum-exp). ``inner_tp_jamba_v0_1_52b``:
   jamba at full width cut to layers 0-3 of its period, in fp32, four
   prompts of 512: ``forward`` and ``prefill_step`` under its
   ``prefill_32k`` layout (``seq_tp``, ``inner``, the all-to-all), 16
   decode steps under its ``decode_32k`` one. Both held as ``tp_decode``
   (and the forward's logits within 0.15), with the bf16 one-rank run's
   distance from the fp32 one printed (the rounding floor).
   ``inner_tp_train_xlstm_1_3b``: xlstm at full width cut to 8 of its 48
   layers (one period of its pattern), in fp32, one step under ``vocab`` and ``inner`` over ``model``,
   one under ``pure_dp`` on ``data=2`` and, on four ranks, one with
   ``inner`` over ``model`` beside the sequence over ``data`` and one with
   ``inner`` over the batch's own ``data``, held as ``tp_train``, the
   bf16 one-rank step printed beside. K2, K4, K4b and K5 are then held
   against their plain versions at the shapes these phases added.
10. Prints the ``kernels`` JSON line (K1-K5 and K4b), its launch counts summed over
   every phase above, then the seconds of each phase, the script's
   seconds from the build's start, the card line and,
   as its last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed. Needs a CUDA
device and the repository's ``src/`` beside this file; imports no JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
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
# its full width, cut to two periods of its block pattern (16 of 48 layers;
# all 48 until the pipeline's phase came in)
XLSTM_ARCH, XLSTM_SERVE_LAYERS = "xlstm-1.3b", 16
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
# the recurrent models whose prefill wave is profiled: xlstm's took 76 s
# of the profiler's parsing (its sLSTM's ~1,000 steps of ~13 ops), left
# out since the expert-parallel and inner-split phases came in
PREFILL_PROFILED = ("jamba-v0.1-52b",)
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
# the tensor, sequence and ZeRO-3 phases: TP_RANKS gloo ranks sharing the
# card. Training: llama at full width cut to TP_LAYERS of its 28 layers
# (8 until the expert-parallel and inner-split phases came in, 4 until the
# hand-written layouts' four-rank steps came in; two ranks' weights, AdamW
# state and fp32 accumulators share one card's 80 GB), the
# train phases' batch, one step a variant, held to the
# unsharded step within TP_RTOL (bf16 sums in other orders). Decoding:
# llama at its published config, TP_PROMPT_LENGTHS prompts padded to the
# longest, TP_DECODE_STEPS steps into a cache of TP_MAX_SEQ positions
# split along its sequence; logits held to one rank's within LOGIT_TOL,
# the argmax where one rank's top two lie more than TP_MARGIN apart (the
# serve bound of PERF.md section 2)
TP_RANKS, TP_LAYERS, TP_RTOL = 2, 2, 1e-2
TP_TRAIN_VARIANTS = {
    "seq_tp_mlp": dict(attn_strategy="seq_tp", mlp_mode="tp",
                       kv_compress=False, fsdp="off", layout="tp",
                       remat="block"),
    "seq_tp_mlp_seq_int8": dict(attn_strategy="seq_tp", mlp_mode="seq",
                                kv_compress=True, fsdp="off", layout="tp",
                                remat="block")}
# hand-written layouts of the tp_train phase on PP_RANKS ranks
# (``par_train_phase``): the sequence and vocab over model beside the
# heads, kv heads and mlp over data; the mlp over the batch's own axis
# (its weights gathered, ZeRO-3's); the heads and kv heads over data and
# model beside the batch over data (24 query and 8 kv heads in 4 blocks,
# each rank computing model's block of them); the kv heads over data
# beside the query heads over model (the kv projections gathered)
TP_TRAIN_LAYOUTS = {
    "seq_beside_heads": ({"data": 2, "model": 2}, "seq_beside_heads"),
    "mlp_over_batch": ({"data": 2, "model": 2}, "mlp_over_batch"),
    "heads_mixed_batch": ({"data": 2, "model": 2}, "heads_mixed_batch"),
    "kv_heads_off_heads": ({"data": 2, "model": 2}, "kv_heads_off_heads")}
ZERO_VARIANTS = {
    "zero3": (dict(layout="pure_dp", attn_strategy="replicated",
                   fsdp="off", remat="block"), None),
    "zero2_regather_mb2": (dict(layout="pure_dp",
                                attn_strategy="replicated", fsdp="off",
                                remat="block", zero2=True,
                                microbatches=2), True)}
TP_PROMPT_LENGTHS = (64, 192, 320, 512)
# the pipeline with splits inside its stages: PP_RANKS gloo ranks sharing
# the card, llama at full width cut to PP_LAYERS of its 28 layers (two a
# stage, so that a stage chains layers under its splits: the residual
# carried from layer to layer, a bucket of several layers' gradients),
# PP_BATCH x TRAIN_SEQ tokens in the
# packing cell's PP_MICROBATCHES microbatches, one step a variant under the
# rules of the planner's plan of llama's packing cell (train_4k on
# 2 x 16 x 16 with the pipeline's pod role, under the variant's profile and
# overrides) laid on the variant's mesh; held to one rank's unsharded step
# on the whole batch as tp_train is
PP_RANKS, PP_LAYERS, PP_BATCH, PP_MICROBATCHES = 4, 4, 8, 4
PP_TP_VARIANTS = {
    "seq_tp_mlp_seq": ({"pod": 2, "data": 1, "model": 2}, "optimized", {}),
    "seq_tp_mlp": ({"pod": 2, "data": 1, "model": 2}, "baseline", {}),
    "zero3_data": ({"pod": 2, "data": 2, "model": 1}, "optimized",
                   {"fsdp": "on"})}
# expert parallelism and the inner split: PAR_RANKS gloo ranks sharing the
# card, each phase held against one rank on the same weights (the bounds
# of the tp phases). ep_train: granite at full width cut to 2 of its 24
# layers (24 until the baseline variant came in: its all-to-alls move a
# whole chunk's buffer; 12 until the pipeline's phase came in, 8 until the
# hand-written layouts came in, 4 until the script's time on slower hosts
# called for more), one step under its 2 x 16 x 16 train_4k
# layout on data=1 x model=2, one under its 16 x 16 pure_dp layout on
# data=2, one under its baseline-profile train_4k layout on data=1 x
# model=2 (GSPMD's all_to_all plane) and one under each hand-written
# layout, drop-free (E / top_k), the drops at 1.25 printed beside.
# ep_decode:
# moonshot at full width cut to 4 of its 48 layers (all 48 are 56.1 GB of
# bf16 weights, and each rank builds the whole model before it keeps its
# shards; 12 until the pipeline's phase came in, 6 until the layouts over
# the batch's axes came in), one forward under its baseline-profile prefill_32k layout
# (head_tp, all_to_all), its decode_32k layout for the prefill and the
# decode steps. inner_tp_jamba: jamba at full width cut to
# layers 0-3 of its period (three Mamba layers, one attention layer, MoE
# FFNs on layers 1 and 3), in fp32 (its bf16 forward moves by more than the
# bound, PERF.md section 2), forward and prefill under its prefill_32k
# layout, decode steps under its decode_32k one. inner_tp_train: xlstm at
# full width cut to 8 of its 48 layers (one period, 7 mLSTM and 1 sLSTM;
# 16 until the checkpoint phase came in), one step under its
# 2 x 16 x 16 layout (vocab and inner over model) and one under pure_dp on
# data=2
PAR_RANKS = 2
EP_TRAIN_LAYERS = 2
PUBLISHED["moonshot-v1-16b-a3b"] = (48, 2048, 16, 16, 128, 1408, 163840,
                                    "bfloat16", (64, 6, 1408))
EP_TRAIN_VARIANTS = {
    "seq_tp_a2a": ({"data": 1, "model": 2},
                   dict(attn_strategy="seq_tp", moe_strategy="shard_map_a2a",
                        mlp_mode="seq", fsdp="off", layout="tp",
                        remat="block")),
    "pure_dp_local": ({"data": 2, "model": 1},
                      dict(layout="pure_dp", attn_strategy="replicated",
                           fsdp="off", remat="dots")),
    # the planner's baseline profile's train_4k layout: GSPMD's all_to_all
    # plane (expert_act over model), the unsharded layer's chunks
    "seq_tp_all_to_all": ({"data": 1, "model": 2},
                          dict(attn_strategy="seq_tp",
                               moe_strategy="all_to_all", layout="tp",
                               mlp_mode="tp", fsdp="off", remat="block")),
    # hand-written layouts (``sharding.LAYOUTS``): the experts on their mlp
    # dimension (``make_rules``' own where model does not divide the
    # experts), and expert_act over data beside the experts over model on
    # PP_RANKS ranks
    "experts_on_mlp": ({"data": 1, "model": 2}, "experts_on_mlp"),
    "expert_act_data": ({"data": 2, "model": 2}, "expert_act_data"),
    # the experts over the batch's own axis (GShard's): gathered, the local
    # plane on each rank's rows
    "experts_over_batch": ({"data": 2, "model": 2}, "experts_over_batch")}
# the variants whose planes compute the unsharded layer's chunks: their
# first MoE layer's drops on one input are held to the unsharded layer's
DROPS_HELD = ("seq_tp_all_to_all", "experts_on_mlp", "expert_act_data",
              "experts_over_batch")
DECODE_PC = dict(attn_strategy="decode_kv_shard", moe_strategy="gather",
                 fsdp="off")
EP_DECODE = {"arch": "moonshot-v1-16b-a3b", "layers": 4,
             "dtype": "float32", "build_dtype": "bfloat16",
             "lengths": TP_PROMPT_LENGTHS, "steps": 32,
             # the baseline profile's prefill_32k layout: head_tp, GSPMD's
             # all_to_all plane
             "forward": dict(attn_strategy="head_tp",
                             moe_strategy="all_to_all", layout="tp",
                             mlp_mode="tp", fsdp="off"),
             # drop-free, each rank's dispatch buffer holds every expert's
             # capacity of a chunk, S slots: at 4 x 512 tokens 1.07 GB of
             # fp32 an all-to-all through host memory; 2 x 64 is 67 MB
             "forward_lengths": (32, 64),
             "prefill": DECODE_PC, "decode": DECODE_PC}
INNER_JAMBA = {"arch": HYBRID_ARCH, "layers": 4, "dtype": "float32",
               "build_dtype": "bfloat16", "lengths": (512,) * 4,
               "steps": 16, "forward": True,
               "prefill": dict(attn_strategy="seq_tp",
                               moe_strategy="shard_map_a2a", mlp_mode="seq",
                               fsdp="off"),
               "decode": DECODE_PC}
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_DTYPE = 8, "float32"
XLSTM_TRAIN_VARIANTS = {
    "vocab_inner": ({"data": 1, "model": 2},
                    dict(fsdp="off", layout="tp", remat="block")),
    "pure_dp": ({"data": 2, "model": 1},
                dict(layout="pure_dp", attn_strategy="replicated",
                     fsdp="off", remat="dots")),
    # the inner split over model beside the sequence over data, and over
    # the batch's own axis (the inner weights gathered), on PP_RANKS ranks
    "inner_beside_seq": ({"data": 2, "model": 2}, "inner_beside_seq"),
    "inner_over_batch": ({"data": 2, "model": 2}, "inner_over_batch")}
TP_MAX_SEQ, TP_DECODE_STEPS, TP_MARGIN = 1024, 16, 0.3
# the planned train phase: llama3.2-3b at 64 x 1024 tokens on this card,
# its microbatch count the planner's
PLAN_TRAIN_SHAPE = ("card_b64_s1024", 1024, 64)
PLAN_TRAIN_STEPS = 2
# the dry-run phase: the traced peak of the plan_train cell against the
# peak that phase measured (max_memory_allocated: blocks rounded up to 512
# bytes, and cuBLAS's workspaces, which the trace does not see)
DRYRUN_PEAK_RTOL = 0.05
# the data-parallel phase: granite on DP_RANKS gloo ranks sharing the card,
# the train phases' batch split over them; one untimed and DP_STEPS timed
# steps. Held against one rank on the whole batch: loss and grad norm
# (bf16 sums in another order); the int8 all-reduce (the reference test's
# bound) and the ranks' agreement. The aux is held within one forward:
# each rank's against the whole batch's aux of the ranks'
# gathered router statistics, which differ only in fp32 rounding, while
# one rank's own rows' aux (the fault the hold is for) lies far outside
# granite cut to DP_LAYERS of its 24 layers (the int8 all-reduce's hold
# moves its gradients through host memory four times), since the
# expert-parallel and inner-split phases came in (6 since the pipeline's
# phase came in, 4 since the hand-written layouts' four-rank steps, 2
# since the layouts over the batch's axes)
DP_RANKS, DP_STEPS, DP_LAYERS = 2, 1, 2
DP_RTOL, DP_AUX_RTOL = 1e-2, 1e-5
COMPRESSED_BOUND, COMPRESSED_AGREE = 0.02, 1e-6
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
# empty device traces taken again before a measurement gives up (``traced``;
# after the phases that spawn ranks on the card about half the tries came
# back empty on an H100)
PROFILE_TRIES = 5
# the checkpoint phase: llama at full width cut to CKPT_LAYERS layers (its
# checkpoint 8.33 GB: bf16 weights and fp32 master, m and v), CKPT_STEPS
# steps uninterrupted and again under the supervisor, a checkpoint every
# CKPT_EVERY steps (CKPT_KEEP kept) and a fault at step CKPT_FAULT_AT
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_KEEP, CKPT_FAULT_AT = 2, 6, 3, 2, 4
# the training CLI on the card: the contract of its CPU test
CLI_ARGS = ("--batch", "2", "--seq", "32", "--log-every", "4",
            "--ckpt-every", "6")
# the repaired padded prefill on the card: one request's new tokens held
# to the greedy continuation where the top two logits lie this far apart
ENGINE_NEW_TOKENS, GREEDY_MARGIN = 8, 0.3
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


def work_bound(work: tuple[float, float],
               ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """``bound_ms`` of a kernel's ``(FLOPs, bytes)``, as its kernel module
    gives them (``partition.*_work``, ``attention.*_work``: the one source
    the dry-run's count reads too)."""
    flops, nbytes = work
    return bound_ms(nbytes, flops, ops_per_s)


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
    """``a`` and ``b`` bit for bit (floats compared as integers of their
    width, so that -0.0, +0.0 and NaNs are told apart)."""
    import torch
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
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
    b, by = work_bound(K.histogram_work(n, p))
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
    b, by = work_bound(K.scatter_work(n, p))
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
        moe.dispatch = lambda t, e, c, start=None: moe.dispatch_plain(
            t, c, start)
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
              "bound_ms": work_bound(K.fused_probe_work(n2, m2))[0]}
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
    b, by = work_bound(K.fused_probe_work(n, m))
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


def _offset(shape) -> tuple[int, int]:
    """``(S_k, q_offset)`` of a K4 / K4b shape: the fields after the route,
    or the query rows and 0."""
    return tuple(shape[8:10]) if len(shape) > 8 else (shape[1], 0)


def hold_k4(dev, gen, shape) -> float:
    """K4 at ``shape`` ``(B, S, H, K, hd, dtype, causal, route[, S_k,
    q_offset])`` within its tolerance of its plain version, on the route
    named; returns the max |err|."""
    from repro_torch.kernels import attention as A, ref
    b, s, h, kh, hd, dt, causal, route = shape[:8]
    s_k, off = _offset(shape)
    q = _randn(gen, (b, s, h, hd), dt, dev)
    k, v = (_randn(gen, (b, s_k, kh, hd), dt, dev) for _ in range(2))
    A.SHAPES["flash_attention"].clear()
    out = A.flash_attention(q, k, v, causal, off)
    err = _held_close(
        out, ref.flash_attention_ref(q, k, v, causal, off), dt,
        f"K4 differs from its plain version at B={b} S={s} H={h} K={kh}"
        f" hd={hd} {dt} causal={causal} S_k={s_k} q_offset={off}")
    # the training forward's call: the same output, and each row's lse
    out2, lse = A.flash_attention_with_lse(q, k, v, causal, off)
    lse_err = float((lse - ref.flash_attention_lse_ref(q, k, v, causal, off))
                    .abs().max())
    require(bits_equal(out, out2) and lse_err <= LSE_TOL,
            f"K4 with lse at {shape}: output bit-equal "
            f"{bits_equal(out, out2)}, lse max |err| {lse_err} > {LSE_TOL}")
    took = [sh[7] for sh in A.SHAPES["flash_attention"]]
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
    bnd, by = work_bound(
        A.flash_attention_work(b, s, h, kh, hd, q.element_size(), causal),
        BF16_OPS_PER_S if dt == "torch.bfloat16" else FP32_OPS_PER_S)
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
    """K5 at ``shape`` ``(B, H, S, K, hd, dtype[, "lse"])``, random lengths
    with 1 and S among them (and 0 where it writes its log-sum-exp), within
    its tolerance of its plain version, the log-sum-exp within
    ``LSE_TOL``; returns the max |err|."""
    import torch
    from repro_torch.kernels import attention as A, ref
    b, h, s, kh, hd, dt = shape[:6]
    with_lse = shape[6:] == ("lse",)
    length = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    length[0], length[-1] = 1, s
    if with_lse and b > 2:
        length[1] = 0
    args = _k5_case(dev, gen, shape[:6], length)
    what = (f"K5 differs from its plain version at B={b} H={h} S={s} K={kh}"
            f" hd={hd} {dt} lse={with_lse}")
    if not with_lse:
        return _held_close(A.decode_attention(*args),
                           ref.decode_attention_ref(*args), dt, what)
    out, lse = A.decode_attention(*args, return_lse=True)
    want, want_lse = ref.decode_attention_ref(*args, return_lse=True)
    valid = length > 0
    lse_err = float((lse[valid] - want_lse[valid]).abs().max())
    require(bool(torch.isneginf(lse[~valid]).all()) and lse_err <= LSE_TOL,
            f"{what}: lse max |err| {lse_err} > {LSE_TOL}, or not -inf at "
            f"length 0")
    return _held_close(out, want, dt, what)


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
    bnd, by = work_bound(A.decode_attention_work(
        b, h, kh, hd, q.element_size(), int(sum(lengths))), BF16_OPS_PER_S)
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

        def recording_route(p, x, top_k, router=None):
            out = self._route(p, x, top_k, router)
            self.routes.append((self.label, out[2]))
            return out

        def recording_dispatch(top_i, num_experts, cap, start=None):
            bk = self._dispatch(top_i, num_experts, cap, start)
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

        def pinned_route(p, x, top_k, router=None):
            probs, _, own = self._route(p, x, top_k, router)
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

        def recording_prefill(model_, state, inputs, **kw):
            rec.label = ("prefill", len(waves))
            waves.append([None if r is None else
                          (r.req_id, len(r.tokens) + len(r.output))
                          for r in engine.active])
            return prefill(model_, state, inputs, **kw)

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
    engine's tokens, in the served bf16 model: printed, not held (the two
    paths round bf16 in other orders; ``engine_greedy_hold`` holds the
    engine in fp32)."""
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


def engine_greedy_hold(res: dict, dev) -> dict:
    """The repaired padded prefill on the card: the engine serves the
    request with the shortest prompt alone, ``ENGINE_NEW_TOKENS`` new
    tokens at a ``max_seq`` of the next multiple of the mLSTM's prefill
    chunk (the prompt padded to it, each row's length passed), on the
    model the caller built (its fp32 weights; a MoE drop-free). Its tokens
    must be the greedy continuation of one teacher-forced ``forward`` over
    the prompt and the tokens: the argmax at every generated position
    where ``forward``'s top two logits lie more than ``GREEDY_MARGIN``
    apart (at least one such position)."""
    import torch
    from repro_torch.models import forward
    from repro_torch.serving import Request, ServingEngine
    cfg, model = res["cfg"], res["model"]
    req = min(res["done"], key=lambda r: len(r.tokens))
    n = len(req.tokens)
    max_seq = -(-(n + ENGINE_NEW_TOKENS) // MLSTM_PREFILL_CHUNK) \
        * MLSTM_PREFILL_CHUNK
    model.cfg = drop_free(cfg)
    t0 = time.perf_counter()
    try:
        engine = ServingEngine(model.cfg, model, max_batch=1,
                               max_seq=max_seq, device=dev)
        engine.submit(Request(req.req_id, list(req.tokens),
                              max_new_tokens=ENGINE_NEW_TOKENS))
        out = engine.run(max_steps=4 * ENGINE_NEW_TOKENS)[0].output
        seq = req.tokens + out[:-1]
        lg, _ = forward(model, {"tokens": torch.tensor([seq], device=dev)},
                        ssm_chunk=len(seq))
    finally:
        model.cfg = cfg
    top = lg[0, n - 1:n - 1 + ENGINE_NEW_TOKENS, :cfg.vocab_size].topk(2)
    margin = (top.values[:, 0] - top.values[:, 1]).cpu()
    argmax = top.indices[:, 0].cpu()
    held = margin > GREEDY_MARGIN
    wrong = [j for j in range(len(out))
             if held[j] and int(argmax[j]) != out[j]]
    got = {"request": req.req_id, "prompt": n, "max_seq": max_seq,
           "tokens": out, "greedy": argmax.tolist(),
           "held_positions": int(held.sum()),
           "min_margin": float(margin.min()),
           "seconds": time.perf_counter() - t0}
    require(len(out) == ENGINE_NEW_TOKENS and bool(held.any())
            and not wrong, f"the engine's tokens are not the greedy "
            f"continuation at positions {wrong}: {json.dumps(got)}")
    return got


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
    print(f"serve {name} greedy (bf16, printed): the engine's tokens "
          f"against the greedy continuation of the prompt: "
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
    engine = engine_greedy_hold(res, dev)
    print(f"serve {name} engine greedy (fp32, held where the top two "
          f"logits lie more than {GREEDY_MARGIN} apart): "
          f"{json.dumps(engine)} [{card}]")
    lap("engine_greedy")
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
    0), outside the counted runs: eight decode steps and, for the models
    in ``PREFILL_PROFILED``, one prefill wave under ``torch.profiler``
    (``profile_decode``, ``profile_prefill``)
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
    kinds = [("decode", profile_decode)]
    if name in PREFILL_PROFILED:
        kinds.append(("prefill", profile_prefill))
    for what, fn in kinds:
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
    """K4b's inputs at ``(B, S, H, K, hd, dtype, causal[, route[, S_k,
    q_offset]])``: random q, k, v and d_out, and ``out`` and each row's
    ``lse`` from one K4 call, as the training forward saves them: ``(q, k,
    v, out, d_out, causal, lse, q_offset)``, the autograd backward's
    call."""
    from repro_torch.kernels import attention as A
    b, s, h, kh, hd, dt, causal = shape[:7]
    s_k, off = _offset(shape)
    q, d_out = (_randn(gen, (b, s, h, hd), dt, dev) for _ in range(2))
    k, v = (_randn(gen, (b, s_k, kh, hd), dt, dev) for _ in range(2))
    out, lse = A.flash_attention_with_lse(q, k, v, causal, off)
    return q, k, v, out, d_out, causal, lse, off


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
    took = [sh[7] for sh in A.SHAPES["flash_attention_bwd"]]
    require(len(shape) < 8 or took == [shape[7]],
            f"K4b took {took} at {shape}")
    again = A.flash_attention_bwd(*args)
    require(all(bits_equal(a, b) for a, b in zip(got, again)),
            f"K4b's gradients at {shape} differ between two calls")
    want = ref.flash_attention_bwd_ref(*args[:6], q_offset=args[7])
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
    """K4b's bound (``attention.flash_attention_bwd_work``: its five
    products at the rate of the dtype, or its bytes at the memory rate)."""
    from repro_torch.kernels import attention as A
    b, s, h, kh, hd, dt, causal = shape[:7]
    elem = 2 if dt == "torch.bfloat16" else 4
    return work_bound(A.flash_attention_bwd_work(b, s, h, kh, hd, elem,
                                                 causal),
                      BF16_OPS_PER_S if elem == 2 else FP32_OPS_PER_S)


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
        b, s, h, kh, hd, dt, causal, route = shape[:8]
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


def train_leaves(state) -> dict:
    """``{name: tensor}`` of every parameter and optimizer leaf of a port
    train state."""
    out = {f"params.{k}": p.detach()
           for k, p in state["params"].named_parameters()}
    out["opt.step"] = state["opt"]["step"]
    for key in ("master", "m", "v"):
        out.update({f"opt.{key}.{k}": t
                    for k, t in state["opt"][key].items()})
    return out


def ckpt_cli(dev, root: Path, card: str) -> dict:
    """``repro_torch.launch.train.main`` on the card at its smoke config
    under the contract of its CPU test (``CLI_ARGS``: 12 steps of 2 x 32
    tokens, a loss every 4, a checkpoint every 6), then ``--steps 6`` and
    ``--resume --steps 12`` in another directory: the resumed run's
    losses at steps 8 and 12 must equal the uninterrupted run's, bit for
    bit."""
    from repro_torch.launch.train import main as train_main
    t0 = time.perf_counter()
    whole = train_main([*CLI_ARGS, "--steps", "12", "--ckpt",
                        str(root / "cli_whole")])
    first = train_main([*CLI_ARGS, "--steps", "6", "--ckpt",
                        str(root / "cli_split")])
    rest = train_main([*CLI_ARGS, "--steps", "12", "--resume", "--ckpt",
                       str(root / "cli_split")])
    out = {"losses": whole, "resumed": first + rest,
           "seconds": time.perf_counter() - t0}
    print(f"ckpt cli: {json.dumps(out)} [{card}]")
    require(len(whole) == 3 and all(np.isfinite(whole)),
            f"the CLI logged {whole}")
    require(first == whole[:1] and rest == whole[1:],
            f"the resumed CLI's losses {first} + {rest} against the "
            f"uninterrupted run's {whole}")
    return out


def ckpt_phase(dev, card: str) -> dict:
    """Checkpoint and restart on the card (``repro_torch.ckpt``), with the
    counters set to 0 just before and read just after: llama3.2-3b at its
    published width cut to ``CKPT_LAYERS`` of its 28 layers, random
    weights from seed 0, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens a step
    from ``SyntheticSource(seed=1)`` (step ``i``'s batch at step ``i``),
    AdamW at ``TRAIN_LR``, ``remat="block"``. ``CKPT_STEPS`` steps of the
    plain train step, uninterrupted; then the same start under the
    ``Supervisor`` (a checkpoint every ``CKPT_EVERY`` steps, ``CKPT_KEEP``
    kept, the starting state's before the first step) with a fault raised
    at step ``CKPT_FAULT_AT``, so that it restores step ``CKPT_EVERY``'s.
    The checkpoints go to a fresh temporary directory on local disk, which
    must have room for three of them first, and which is removed after.
    Held: one restart, and every parameter and optimizer leaf bit-equal to
    the uninterrupted run's (K4b on its tensor-core route sums in a fixed
    order: no atomics). Prints the checkpoint's bytes, the seconds and
    GB/s of the host copy on the train thread, of the write and of the
    load, and the free disk space. Then the training CLI (``ckpt_cli``)."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.ckpt import Supervisor
    from repro_torch.core.config import (OptimizerConfig, ParallelConfig,
                                         ShapeConfig)
    from repro_torch.data import SyntheticSource
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.training import make_train_step

    cfg = dataclasses.replace(serve_config(SERVE_ARCH),
                              num_layers=CKPT_LAYERS)
    shape = ShapeConfig("chip_ckpt", TRAIN_SEQ, TRAIN_BATCH, "train")
    source = SyntheticSource(cfg, shape, seed=1)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in source.batch(i).items()}
               for i in range(CKPT_STEPS)]
    step = make_train_step(cfg, shape, OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=0), ParallelConfig(remat="block"),
        total_steps=CKPT_STEPS)
    before = {k: set(v) for k, v in A.SHAPES.items()}
    A.reset_launches()
    K.reset_launches()
    t0 = time.perf_counter()
    whole = _fresh_state(cfg, dev)
    for i in range(CKPT_STEPS):
        whole, _ = step(whole, batches[i])
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size()
                 for t in train_leaves(whole).values())
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        free = shutil.disk_usage(root).free
        print(f"ckpt: a checkpoint of {CKPT_LAYERS} layers takes {nbytes} "
              f"B; {free} B free on the disk of {root} [{card}]")
        require(free >= 3 * nbytes, f"{free} B free under {root}, less "
                f"than three checkpoints of {nbytes} B")
        armed = {"on": True}

        def fault(i):
            if i == CKPT_FAULT_AT and armed["on"]:
                armed["on"] = False
                raise RuntimeError("simulated node failure")

        sup = Supervisor(step, lambda i: batches[i], str(root / "sup"),
                         ckpt_every=CKPT_EVERY, keep=CKPT_KEEP)
        t0 = time.perf_counter()
        state, final = sup.run(_fresh_state(cfg, dev), CKPT_STEPS,
                               fault_hook=fault)
        torch.cuda.synchronize()
        sup_s = time.perf_counter() - t0
        kept = sorted(p.name for p in (root / "sup").iterdir())
        require(final == CKPT_STEPS and sup.restarts == 1,
                f"the supervised run ended at step {final} after "
                f"{sup.restarts} restarts")
        require(kept == [f"step_{s:09d}" for s in
                         (CKPT_STEPS - CKPT_EVERY, CKPT_STEPS)],
                f"checkpoints kept: {kept}")
        got, want = train_leaves(state), train_leaves(whole)
        differ = [k for k in want if not bits_equal(got[k], want[k])]
        require(not differ, f"the restored run differs from the "
                f"uninterrupted one in {len(differ)} leaves: {differ[:8]}")
        n_leaves = len(want)
        # K4 twice an attention layer a step (forward and recompute), K4b
        # once: the uninterrupted steps, and the supervised ones with the
        # steps from the restored checkpoint to the fault run again
        n = 2 * CKPT_STEPS + CKPT_FAULT_AT - CKPT_EVERY
        launches = {**A.LAUNCHES, **K.LAUNCHES}
        want_launches = {"flash_attention": 2 * CKPT_LAYERS * n,
                         "flash_attention_bwd": CKPT_LAYERS * n,
                         "decode_attention": 0, "partition_scatter": 0,
                         "partition_histogram": 0, "fused_probe": 0}
        require(launches == want_launches, f"checkpoint phase launches "
                f"{launches} for {n} steps, expected {want_launches}")
        del state, whole, got, want
        _release()
        cli = ckpt_cli(dev, root, card)
        launches = {**A.LAUNCHES, **K.LAUNCHES}
        cli["launches"] = {k: v - want_launches[k]
                           for k, v in launches.items()}
        require(cli["launches"]["flash_attention"] > 0
                and cli["launches"]["flash_attention_bwd"] > 0,
                f"the CLI launched {cli['launches']}")
    finally:
        shutil.rmtree(root)
    saves = sup.checkpointer.stats
    gb = nbytes / 1e9
    res = {"layers": CKPT_LAYERS, "checkpoint_bytes": nbytes,
           "free_disk_bytes": free, "uninterrupted_s": whole_s,
           "supervised_s": sup_s, "restarts": sup.restarts,
           "step_ms": [x * 1e3 for x in sup.step_times],
           "saves": [{"step": r["step"], "copy_s": r["copy_s"],
                      "copy_gb_per_s": gb / r["copy_s"],
                      "write_s": r["write_s"],
                      "write_gb_per_s": gb / r["write_s"]} for r in saves],
           "load_s": sup.restore_seconds,
           "load_gb_per_s": [gb / x for x in sup.restore_seconds],
           "leaves_bit_equal": n_leaves,
           "launches": launches, "cli": cli,
           "shapes": {k: A.SHAPES[k] - before[k] for k in A.SHAPES}}
    shown = {k: v for k, v in res.items() if k not in ("shapes", "cli")}
    print(f"ckpt_train_llama3_2_3b: {json.dumps(shown)} [{card}]")
    return res


def card_hardware():
    """``H100_SXM`` with the card's own memory (``total_memory``)."""
    import dataclasses

    import torch
    from repro_torch.device import H100_SXM
    return dataclasses.replace(
        H100_SXM, hbm_bytes=torch.cuda.get_device_properties(0).total_memory)


def resolved_plan(cfg, shape, mesh, pc, hw) -> tuple:
    """``(pc with mlp_mode as make_rules resolves it, the rules)``: the
    planner leaves ``mlp_mode`` at ``auto`` for ``make_rules``, as the
    reference's does."""
    import dataclasses

    from repro_torch.parallel.strategies import make_rules
    rules = make_rules(mesh, cfg, shape, pc, hw)
    if pc.mlp_mode == "auto":
        pc = dataclasses.replace(
            pc, mlp_mode="seq" if rules.rules["mlp_seq"] else "tp")
    return pc, rules


def plan_cells(card: str) -> dict:
    """Every arch x the four ``SHAPES`` through the port's decision
    workflow on the reference's 16 x 16 and 2 x 16 x 16 planning meshes
    and on this one card, priced with the card's figures: one ``plan``
    line per arch; every field resolved."""
    import dataclasses

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.config import SHAPES
    from repro_torch.core.decisions import DecisionContext
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_smoke_mesh)
    from repro_torch.parallel.strategies import build_workflow

    hw = card_hardware()
    meshes = {"16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True),
              "1card": make_smoke_mesh()}
    t0 = time.perf_counter()
    plans = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        row = {}
        for sname, shape in SHAPES.items():
            for mname, mesh in meshes.items():
                wf = build_workflow(cfg, shape, mesh, hw)
                (decision,) = wf.run(DecisionContext(),
                                     lambda *_: None).values()
                pc, _ = resolved_plan(cfg, shape, mesh,
                                      decision.extra("parallel_config"), hw)
                auto = [k for k, v in dataclasses.asdict(pc).items()
                        if v == "auto"]
                require(not auto, f"{arch} {sname} {mname}: {auto} left "
                        f"unresolved")
                row[f"{sname}@{mname}"] = (
                    f"{pc.attn_strategy}/{pc.moe_strategy}/{pc.layout}/"
                    f"fsdp={pc.fsdp}/mb={pc.microbatches}/"
                    f"{decision.schedule.policy}")
        plans[arch] = row
    plan_s = time.perf_counter() - t0
    for arch, row in plans.items():
        print(f"plan {arch}: {json.dumps(row)} [{card}]")
    print(f"plan_cells: {len(plans) * len(SHAPES) * len(meshes)} cells "
          f"planned in {plan_s:.3f} s with hbm_bytes {hw.hbm_bytes} [{card}]")
    return {"plan_s": plan_s, "cells": len(plans) * len(SHAPES) * len(meshes)}


def plan_train_phase(dev, card: str) -> dict:
    """llama3.2-3b at its published config at ``PLAN_TRAIN_SHAPE`` on this
    card, planned by the port's decision workflow with the card's figures,
    checked executable, then trained under the plan (random weights from
    seed 0, AdamW at lr 3e-4, no warmup): one untimed and
    ``PLAN_TRAIN_STEPS`` timed steps, counters set to 0 just before and
    read just after. Every loss and norm finite; peak memory beside the
    planner's fixed and activation bytes, its budget and the card's
    memory."""
    import torch
    from repro_torch.core.config import OptimizerConfig, ShapeConfig
    from repro_torch.core.decisions import DecisionContext
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.parallel.strategies import (TRAIN_HBM_SHARE,
                                                 build_workflow,
                                                 estimate_activation_bytes,
                                                 exact_param_bytes_per_chip,
                                                 state_multiplier)
    from repro_torch.training import make_train_step

    hw = card_hardware()
    cfg = serve_config(SERVE_ARCH)
    name, seq, batch_rows = PLAN_TRAIN_SHAPE
    _, batch = _train_inputs(cfg, dev, batch_rows, seq)
    shape = ShapeConfig(name, seq, batch_rows, "train")
    mesh = make_smoke_mesh()
    (decision,) = build_workflow(cfg, shape, mesh, hw).run(
        DecisionContext(), lambda *_: None).values()
    pc, rules = resolved_plan(cfg, shape, mesh,
                              decision.extra("parallel_config"), hw)
    require_executable(rules, cfg=cfg)
    fixed = exact_param_bytes_per_chip(cfg, rules) * state_multiplier(shape,
                                                                      hw)
    act = estimate_activation_bytes(cfg, shape, 1, 1, pc.microbatches,
                                    pc.sequence_sharded_residual)
    state = _fresh_state(cfg, dev)
    step = make_train_step(cfg, shape, OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=0), pc, rules=rules)
    before = {k: set(v) for k, v in A.SHAPES.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    K.reset_launches()
    losses, norms, step_ms = [], [], []
    for i in range(PLAN_TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = {**A.LAUNCHES, **K.LAUNCHES}
    peak = int(torch.cuda.max_memory_allocated())
    n, attn = PLAN_TRAIN_STEPS + 1, attention_layers(cfg)
    mb = pc.microbatches
    want = {"flash_attention": 2 * attn * mb * n,
            "flash_attention_bwd": attn * mb * n, "decode_attention": 0,
            "partition_scatter": 0, "partition_histogram": 0,
            "fused_probe": 0}
    require(launches == want, f"planned training: launches {launches}, "
            f"expected {want}")
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"planned training: losses {losses}, grad norms {norms}")
    tokens = batch_rows * seq
    res = {"plan": {"attn": pc.attn_strategy, "layout": pc.layout,
                    "fsdp": pc.fsdp, "microbatches": mb, "remat": pc.remat,
                    "schedule": decision.schedule.policy},
           "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "tokens_per_s": tokens / (np.median(step_ms) / 1e3),
           "peak_bytes": peak, "planned_fixed_bytes": fixed,
           "planned_activation_bytes": act,
           "planned_bytes": fixed + act,
           "planned_budget_bytes": TRAIN_HBM_SHARE * hw.hbm_bytes,
           "card_bytes": hw.hbm_bytes,
           "launches": launches,
           "shapes": {k: A.SHAPES[k] - before[k] for k in A.SHAPES},
           "pc": pc, "rules": rules, "shape": shape}
    print(f"plan_train {SERVE_ARCH} at {name} ({batch_rows}x{seq}) on one "
          f"card: plan {json.dumps(res['plan'])} [{card}]")
    print(f"plan_train {SERVE_ARCH}: step ms "
          f"{[round(x, 2) for x in step_ms]} (one untimed before), "
          f"{res['tokens_per_s']:.1f} tokens/s at the median step; peak "
          f"max_memory_allocated {peak} B against the plan's {fixed:.4g} "
          f"fixed + {act:.4g} activation = {fixed + act:.4g} B, its budget "
          f"{res['planned_budget_bytes']:.4g} B (peak under it by "
          f"{res['planned_budget_bytes'] - peak:.4g} B) and the "
          f"card's {hw.hbm_bytes} B; losses "
          f"{[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 5) for x in norms]}, launches {launches} [{card}]")
    require(peak < res["planned_budget_bytes"],
            f"planned training peaked at {peak} B, over the plan's budget "
            f"{res['planned_budget_bytes']} B")
    del state, step, metrics
    _release()
    return res


def dp_rank(rank: int, world: int, root: str, arch: str, steps: int,
            device: str):
    """One of ``world`` ranks sharing the card through ``gloo``: the
    data-parallel step of ``arch`` (published config, weights from seed
    0) on its rows of the train phases' batch, planned on a
    ``data=world, model=1`` mesh (its ``pure_dp`` plan overridden: this
    phase holds data parallelism; ``ep_train`` runs ``pure_dp``); then the
    int8 all-reduce of its own gradients against the exact one. Writes
    its results to ``root/rank{rank}.json``."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.launch.mesh import init_distributed, make_smoke_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import use_rules
    from repro_torch.parallel.strategies import plan_cell
    from repro_torch.training import make_train_step
    from repro_torch.training.train_step import (_rows, make_grad_fn,
                                                 text_tokens)

    backend = init_distributed(rank, world, f"file://{root}/rendezvous",
                               device)
    dev = torch.device(device)
    cfg = dataclasses.replace(serve_config(arch), num_layers=DP_LAYERS)
    shape, batch = _train_inputs(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    mesh = make_smoke_mesh(model=1)
    hw = card_hardware()
    planned = plan_cell(cfg, shape, mesh, hw=hw)
    pc, overridden = planned, []
    if planned.layout == "pure_dp" or planned.fsdp == "on":
        pc = plan_cell(cfg, shape, mesh, ParallelConfig(layout="tp",
                                                        fsdp="off"), hw=hw)
        overridden = ["layout=tp", "fsdp=off"]
    pc, rules = resolved_plan(cfg, shape, mesh, pc, hw)
    state = _fresh_state(cfg, dev)
    step = make_train_step(cfg, shape, OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=0), pc, rules=rules)
    before = shape_sets()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    K.reset_launches()
    out = {"rank": rank, "backend": backend, "plan": dataclasses.asdict(
        planned), "run_plan": dataclasses.asdict(pc),
        "overridden": overridden, "step_ms": [], "losses": [], "norms": []}
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_moe_stats() if i == 0 else contextlib.nullcontext() \
                as stats:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(metrics["loss"]))
        out["norms"].append(float(metrics["grad_norm"]))
        if i == 0:
            # the last microbatch's forward gives the step's aux
            out["aux"] = float(metrics["aux"])
            out["moe_stats"] = [t.double().cpu().tolist()
                                for t in stats[-moe_layers(cfg):]]
    out["launches"] = {**A.LAUNCHES, **K.LAUNCHES}
    out["shapes"] = {k: sorted(v - before[k])
                     for k, v in shape_sets().items()}
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    digest = hashlib.sha256()
    for _, p in state["params"].named_parameters():
        digest.update(p.detach().view(-1).view(torch.uint8).cpu().numpy())
    out["params_sha256"] = digest.hexdigest()

    # this rank's own gradients (its rows' share of the batch's loss)
    group = mesh.group("data")
    part = _rows(batch, mesh.axes_index("data"), world)
    with use_rules(rules):
        _, _, grads = make_grad_fn(cfg, pc)(state["params"], part,
                                            text_tokens(batch))
    flat = [g.float() for g in grads.values()]
    del grads
    nbytes = sum(g.numel() * 4 for g in flat)
    copy = [g.clone() for g in flat]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.flat_all_reduce_(copy, group)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
    out["allreduce_bytes"] = nbytes
    del copy
    reduce = C.make_compressed_grad_allreduce(mesh, "data")
    worst, disagree = 0.0, 0.0
    sign = 1.0 if rank == 0 else -1.0
    for g in flat:
        exact = C.all_reduce_(g.clone(), group) / world
        comp = reduce({"g": g})["g"]
        worst = max(worst, float((comp - exact).abs().max()
                                 / exact.abs().max().clamp(min=1e-30)))
        diff = C.all_reduce_(comp * sign, group)   # rank 0's minus rank 1's
        disagree = max(disagree, float(diff.abs().max()))
    out["compressed_rel_err"] = worst
    out["compressed_ranks_disagree"] = disagree
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def recording_moe_stats():
    """Within the block, every MoE layer's router statistics (``moe_parts``'
    ``(2, E)`` fraction routed first and mean probability over this rank's
    tokens) as ``moe.aux_loss`` receives them, in call order."""
    from repro_torch.models import moe as M
    plain, seen = M.aux_loss, []

    def recording(stats, cfg, group=None):
        seen.append(stats.detach().clone())
        return plain(stats, cfg, group)

    M.aux_loss = recording
    try:
        yield seen
    finally:
        M.aux_loss = plain


def aux_readings(ranks: list, experts: int) -> dict:
    """From one forward's router statistics of every rank: the aux of the
    whole batch (each layer's two means over the ranks, as the reference
    takes them), each rank's step aux relative to it, and the aux of one
    rank's own rows relative to it (what a rank that skipped the
    statistics' all-reduce would report)."""
    stats = np.array([r["moe_stats"] for r in ranks])     # (R, L, 2, E)
    whole = experts * float((stats.mean(0)[:, 0] * stats.mean(0)[:, 1])
                            .sum())
    own = [experts * float((s[:, 0] * s[:, 1]).sum()) for s in stats]
    return {"whole_batch_aux": whole,
            "rank_aux_rel": max(abs(r["aux"] - whole) / whole
                                for r in ranks),
            "own_rows_aux_rel": min(abs(a - whole) / whole for a in own)}


def dp_phase(dev, card: str) -> dict:
    """granite-moe-1b-a400m's data-parallel step (cut to ``DP_LAYERS``
    layers) on ``DP_RANKS`` spawned
    ranks sharing this card through ``gloo`` (``dp_rank``), held against
    the one-rank step on the whole batch in this process: loss and global
    grad norm within ``DP_RTOL``; every rank's aux within ``DP_AUX_RTOL``
    of the whole batch's from the same forward (``aux_readings``), and one
    rank's own rows' aux outside it; the ranks' parameters bit-equal after
    the update, the int8 all-reduce within
    ``COMPRESSED_BOUND`` of each leaf's largest magnitude of the exact one
    and the ranks agreeing to ``COMPRESSED_AGREE``. A rank that fails
    fails the phase."""
    import dataclasses
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.training import make_train_step
    from repro_torch.training.optimizer import global_norm

    cfg = dataclasses.replace(serve_config(MOE_ARCH), num_layers=DP_LAYERS)
    shape, batch = _train_inputs(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    saved = shape_sets()
    state = _fresh_state(cfg, dev)
    step = make_train_step(cfg, shape, OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=0), ParallelConfig(remat="block"))
    loss, metrics, grads = step.grad_step(state["params"], batch)
    one = {"loss": float(loss), "aux": float(metrics["aux"]),
           "grad_norm": float(global_norm(grads))}
    del state, step, grads, metrics
    restore_shape_sets(saved)
    _release()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(DP_RANKS, root, MOE_ARCH, DP_STEPS,
                                dev.type), nprocs=DP_RANKS, join=True)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(f"{root}/rank{r}.json") as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    held = {"loss": r0["losses"][0], "one_rank_loss": one["loss"],
            "grad_norm": r0["norms"][0],
            "one_rank_grad_norm": one["grad_norm"], "aux": r0["aux"],
            "one_rank_aux": one["aux"],
            **aux_readings(ranks, cfg.moe.num_experts),
            "compressed_rel_err": max(r["compressed_rel_err"]
                                      for r in ranks),
            "compressed_ranks_disagree": max(
                r["compressed_ranks_disagree"] for r in ranks)}
    plan = {k: r0["plan"][k] for k in ("attn_strategy", "moe_strategy",
                                        "layout", "fsdp", "microbatches")}
    print(f"dp {MOE_ARCH} ({DP_LAYERS} of 24 layers): {DP_RANKS} ranks on "
          f"one card ({r0['backend']}), "
          f"planned {json.dumps(plan)}, overridden "
          f"{r0['overridden'] or 'nothing'} [{card}]")
    print(f"dp {MOE_ARCH}: held {json.dumps(held)} (loss and grad norm "
          f"within {DP_RTOL}, each rank's aux within {DP_AUX_RTOL} of the "
          f"whole batch's from the same forward and one rank's own rows' "
          f"aux outside it, int8 {COMPRESSED_BOUND} of "
          f"each leaf's largest magnitude, ranks {COMPRESSED_AGREE}) "
          f"[{card}]")
    for r in ranks:
        print(f"dp {MOE_ARCH} rank {r['rank']}: step ms "
              f"{[round(x, 2) for x in r['step_ms']]} (the first untimed), "
              f"all-reduce {r['allreduce_ms']:.2f} ms of "
              f"{r['allreduce_bytes']} B, peak max_memory_allocated "
              f"{r['peak_bytes']} B, losses "
              f"{[round(x, 5) for x in r['losses']]}, launches "
              f"{r['launches']} [{card}]")
    rel = lambda a, b: abs(a - b) / abs(b)
    require(rel(held["loss"], one["loss"]) <= DP_RTOL,
            f"dp loss {held['loss']} against one rank's {one['loss']}")
    require(rel(held["grad_norm"], one["grad_norm"]) <= DP_RTOL,
            f"dp grad norm {held['grad_norm']} against {one['grad_norm']}")
    require(held["rank_aux_rel"] <= DP_AUX_RTOL,
            f"dp aux {held['aux']} off the whole batch's "
            f"{held['whole_batch_aux']} by {held['rank_aux_rel']}")
    require(held["own_rows_aux_rel"] > DP_AUX_RTOL,
            f"one rank's own rows' aux is within {DP_AUX_RTOL} of the whole "
            f"batch's ({held['own_rows_aux_rel']}): the hold cannot tell "
            f"them apart")
    require(len({r["params_sha256"] for r in ranks}) == 1,
            "the ranks' parameters differ after the update")
    require(held["compressed_rel_err"] <= COMPRESSED_BOUND,
            f"int8 all-reduce off by {held['compressed_rel_err']}")
    require(held["compressed_ranks_disagree"] <= COMPRESSED_AGREE,
            f"ranks' int8 all-reduce differ by "
            f"{held['compressed_ranks_disagree']}")
    n, attn, moe = DP_STEPS + 1, attention_layers(cfg), moe_layers(cfg)
    want = {"flash_attention": 2 * attn * n, "flash_attention_bwd": attn * n,
            "decode_attention": 0, "partition_scatter": 2 * moe * n,
            "partition_histogram": 0, "fused_probe": 0}
    for r in ranks:
        require(r["launches"] == want, f"dp rank {r['rank']}: launches "
                f"{r['launches']}, expected {want}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in want}
    shapes = {k: {tuple(s) for r in ranks for s in r["shapes"][k]}
              for k in r0["shapes"]}
    return {"wall_s": wall, "held": held, "launches": launches,
            "shapes": shapes, "ranks": ranks}


# -- tensor, sequence and ZeRO-3 parallelism: ranks sharing the card -----------


def _rank_setup(rank: int, world: int, root: str, layers,
                rows: int = TRAIN_BATCH):
    """Join the ``gloo`` group of ranks sharing the card; ``(dev, cfg,
    shape, batch)`` of llama at its published width (``layers`` of them,
    all where ``None``) and the train phases' batch (``rows`` x
    ``TRAIN_SEQ`` tokens)."""
    import dataclasses

    import torch
    from repro_torch.launch.mesh import init_distributed
    init_distributed(rank, world, f"file://{root}/rendezvous", "cuda")
    dev = torch.device("cuda")
    cfg = serve_config(SERVE_ARCH)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape, batch = _train_inputs(cfg, dev, rows, TRAIN_SEQ)
    return dev, cfg, shape, batch


def _par_inputs(arch: str, layers, dtype, dev, rows: int = TRAIN_BATCH):
    """``(cfg, low_cfg, shape, batch)`` of a rank phase: ``arch`` at its
    published width (``layers`` of its layers where given; drop-free where
    it has experts, ``drop_free``) in ``dtype`` where given, the published
    config as ``low_cfg`` where ``dtype`` differs from its dtype (else
    ``None``), and the train phases' batch of ``rows`` rows."""
    import dataclasses
    cfg = drop_free(serve_config(arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape, batch = _train_inputs(cfg, dev, rows, TRAIN_SEQ)
    if dtype is None or dtype == cfg.dtype:
        return cfg, None, shape, batch
    return dataclasses.replace(cfg, dtype=dtype), cfg, shape, batch


def _unsharded_step(dev, arch: str, layers, dtype=None, drops: bool = False,
                    rows: int = TRAIN_BATCH) -> dict:
    """A rank phase's unsharded step (``_par_inputs``), which the phase
    runs once in this process before it spawns its ranks and leaves in a
    file every rank loads (``_save_unsharded``): ``{"one":
    _one_rank_step's result less the master weights}``; with ``drops``
    also the assignments one forward drops at the capacity factor 1.25
    (``one_drops``) and those of the first MoE layer alone on one input
    (``one_layer_drops``); with a ``dtype`` other than the published one
    also the published dtype's step on the same weights rounded, its loss
    and grad norm (``one_low``: the rounding floor)."""
    cfg, low_cfg, shape, batch = _par_inputs(arch, layers, dtype, dev, rows)
    shared = {}
    if low_cfg is not None:
        low = _one_rank_step(low_cfg, dev, shape, batch)
        shared["one_low"] = {"dtype": low_cfg.dtype, "loss": low["loss"],
                             "grad_norm": low["grad_norm"]}
        del low
        _release()
    if drops:
        state = _fresh_state(cfg, dev)
        shared["one_drops"] = _drops_at(state["params"], cfg, batch)
        shared["one_layer_drops"] = _layer_drops(state["params"], cfg)
        del state
        _release()
    one = _one_rank_step(cfg, dev, shape, batch)
    one.pop("master")
    shared["one"] = one
    return shared


def _save_unsharded(root: str, shared: dict) -> None:
    import torch
    torch.save(shared, f"{root}/one.pt")
    _release()


def _load_unsharded(root: str) -> dict:
    import torch
    return torch.load(f"{root}/one.pt")


def _one_rank_step(cfg, dev, shape, batch, microbatches: int = 1):
    """The unsharded step on the whole batch from seed 0's weights: its
    loss and grad norm, and the updated parameters and master weights on
    the host."""
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.training import make_train_step
    state = _fresh_state(cfg, dev)
    step = make_train_step(cfg, shape, OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=0), ParallelConfig(
        remat="block", microbatches=microbatches))
    state, metrics = step(state, batch)
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "params": {k: p.detach().cpu() for k, p in
                      state["params"].named_parameters()},
           "master": {k: m.cpu() for k, m in state["opt"]["master"].items()}}
    del state, step, metrics
    _release()
    return out


def _sharded_state(cfg, dev, rules) -> dict:
    """This rank's shards of seed 0's weights under ``rules`` and their
    AdamW state."""
    import torch
    from repro_torch.models import init_lm
    from repro_torch.models.convert import shard_params
    from repro_torch.training import init_train_state
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    full = init_lm(cfg, gen, dev)
    local = shard_params(full, rules)
    del full
    _release()
    return init_train_state(cfg, local)


def _timed_step(step, state, batch) -> tuple:
    """One step with the kernel and collective counters set to 0 just
    before it: ``(state, metrics, its record)``."""
    import torch
    from repro_torch.kernels import attention as A
    from repro_torch.parallel import collectives as C
    with own_shapes() as shapes:
        A.reset_launches()
        C.reset_collective_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    rec = {"step_ms": (time.perf_counter() - t0) * 1e3,
           "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "launches": dict(A.LAUNCHES),
           "collectives": {k: dict(v) for k, v in
                           C.COLLECTIVE_STATS.items()},
           "peak_bytes": int(torch.cuda.max_memory_allocated()),
           "shapes": {k: sorted(v) for k, v in shapes.items()}}
    return state, metrics, rec


@contextlib.contextmanager
def own_shapes():
    """Within the block, the kernels' recorded shapes start empty; the dict
    it yields holds those the block launched (the earlier ones are put
    back after it)."""
    saved = shape_sets()
    restore_shape_sets({k: set() for k in saved})
    seen: dict = {}
    try:
        yield seen
    finally:
        seen.update(shape_sets())
        restore_shape_sets({k: saved[k] | seen[k] for k in saved})


def _whole_digest(cfg, rules, named) -> tuple[str, int]:
    """sha256 of the bits of every leaf this rank holds whole (sharded over
    no mesh axis), in name order, and their count."""
    import hashlib

    import torch
    from repro_torch.parallel.tensor import TensorPlan
    from repro_torch.training.train_step import leaf_axes
    plan, axes = TensorPlan(rules), leaf_axes(cfg)
    digest, n = hashlib.sha256(), 0
    for k in sorted(named):
        if not plan.leaf_axes(axes[k]):
            digest.update(named[k].detach().contiguous().view(-1).view(
                torch.uint8).cpu().numpy())
            n += 1
    return digest.hexdigest(), n


def tp_train_rank(rank: int, world: int, root: str, variants: dict,
                  shared_root: str):
    """One of ``world`` ranks sharing the card (``gloo``, ``data=1,
    model=world``): llama at full width cut to ``TP_LAYERS`` layers, for
    each variant one step on this rank's shards under the planner's rules
    for it; rank 0 holds the updated weights, gathered whole, to those of
    the phase's unsharded step on the whole batch (``_unsharded_step``,
    loaded from ``shared_root``) within ``tp_param_bound``. Writes
    ``root/rank{rank}.json``."""
    import torch.distributed as dist
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.convert import gather_named
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.parallel.strategies import make_rules
    from repro_torch.training import make_train_step

    dev, cfg, shape, batch = _rank_setup(rank, world, root, TP_LAYERS)
    one = _load_unsharded(shared_root)["one"]
    mesh = Mesh({"data": 1, "model": world})
    out = {"rank": rank, "one": {"loss": one["loss"],
                                 "grad_norm": one["grad_norm"]},
           "variants": {}}
    for name, fields in variants.items():
        pc = ParallelConfig(**fields)
        rules = make_rules(mesh, cfg, shape, pc)
        require_executable(rules, cfg=cfg)
        state = _sharded_state(cfg, dev, rules)
        step = make_train_step(cfg, shape, OptimizerConfig(
            lr=TRAIN_LR, warmup_steps=0), pc, rules=rules)
        state, metrics, rec = _timed_step(step, state, batch)
        named = dict(state["params"].named_parameters())
        rec["whole_sha256"], rec["whole_leaves"] = _whole_digest(
            cfg, rules, named)
        rec["rules"] = {k: v for k, v in rules.rules.items()
                        if v is not None}
        gathered = gather_named(named, cfg, rules)
        worst, diff = 0.0, 0.0
        for k, full in gathered.items():
            want = one["params"][k].to(dev).float()
            d = float((full.float() - want).abs().max())
            worst = max(worst, d / tp_param_bound(float(want.abs().max())))
            diff = max(diff, d)
        rec["param_max_abs_diff"], rec["param_bound_ratio"] = diff, worst
        out["variants"][name] = rec
        del gathered, named, state, step, metrics
        _release()
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def tp_param_bound(max_abs_weight: float) -> float:
    """How far one AdamW step's bf16 weights may lie apart when two runs
    from the same weights differ only in their gradients' rounding: the
    first step moves each fp32 master weight by ``lr`` times ``m / sqrt(v)
    = g / |g|`` (+-1, whatever ``|g|``) plus the same weight decay, so a
    gradient that changes sign moves it ``2 lr`` apart; each copy then
    rounds to bf16, whose spacing is at most ``2^-7`` of the leaf's largest
    weight."""
    return 2 * TRAIN_LR + 2.0 ** -7 * max_abs_weight


def _print_rank_records(prefix: str, ranks: list, name: str,
                        card: str) -> None:
    for r in ranks:
        rec = r["variants"][name]
        coll = {k: {"calls": v["calls"], "bytes": v["bytes"],
                    "ms": round(v["seconds"] * 1e3, 2)}
                for k, v in rec["collectives"].items()}
        print(f"{prefix} {name} rank {r['rank']}: step ms "
              f"{rec['step_ms']:.2f}, peak max_memory_allocated "
              f"{rec['peak_bytes']} B, collectives {json.dumps(coll)}, "
              f"launches {rec['launches']} [{card}]")


def _held_step(prefix: str, ranks: list, name: str, key: str) -> dict:
    """Every rank's loss and grad norm of a variant against its unsharded
    step's (``key`` in each rank's results), within ``TP_RTOL``; the
    leaves held whole bit-equal across the ranks."""
    rel = lambda a, b: abs(a - b) / abs(b)
    held = {"loss": [], "grad_norm": []}
    for r in ranks:
        rec, one = r["variants"][name], r[key]
        for k in held:
            held[k].append(rel(rec[k], one[k]))
            require(held[k][-1] <= TP_RTOL,
                    f"{prefix} {name} rank {r['rank']}: {k} {rec[k]} "
                    f"against one rank's {one[k]}")
    require(len({r["variants"][name]["whole_sha256"] for r in ranks}) == 1,
            f"{prefix} {name}: the leaves held whole differ across ranks")
    return {k: max(v) for k, v in held.items()}


def _require_launches(prefix: str, ranks: list, name: str,
                      want: dict) -> None:
    for r in ranks:
        got = r["variants"][name]["launches"]
        require(got == want, f"{prefix} {name} rank {r['rank']}: launches "
                f"{got}, expected {want}")


def _spawn(fn, world: int, root: str, *args) -> tuple[float, list]:
    """``fn(rank, world, root, *args)`` on ``world`` spawned ranks (one that
    raises fails the phase); their JSON results and the wall seconds."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.spawn(fn, args=(world, root) + args, nprocs=world, join=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(f"{root}/rank{r}.json") as f:
            ranks.append(json.load(f))
    return wall, ranks


def tp_train_phase(dev, card: str) -> dict:
    """``tp_train_llama3_2_3b``: ``TP_RANKS`` ranks sharing the card, one
    step of each ``TP_TRAIN_VARIANTS`` entry (``tp_train_rank``), then
    ``PP_RANKS`` ranks for each ``TP_TRAIN_LAYOUTS`` entry
    (``par_train_phase``, held alike). Held:
    every rank's loss and grad norm within ``TP_RTOL`` of the unsharded
    step's; the leaves each rank holds whole bit-equal across the ranks;
    the updated weights, gathered, within ``tp_param_bound``; K4 twice and
    K4b once an attention layer, each at a query offset on the rank that
    holds the sequence's second half."""
    import tempfile
    shared = tempfile.TemporaryDirectory()
    _save_unsharded(shared.name, _unsharded_step(dev, SERVE_ARCH, TP_LAYERS))
    with tempfile.TemporaryDirectory() as root:
        wall, ranks = _spawn(tp_train_rank, TP_RANKS, root,
                             TP_TRAIN_VARIANTS, shared.name)
    layers = TP_LAYERS
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "decode_attention": 0}
    out = {"wall_s": wall, "held": {}, "launches": {}, "shapes": {},
           "collectives": {name: ranks[0]["variants"][name]["collectives"]
                           for name in TP_TRAIN_VARIANTS}}
    print(f"tp_train {SERVE_ARCH} ({layers} of 28 layers at full width, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens): {TP_RANKS} ranks on one card "
          f"(gloo), {wall:.2f} s; the unsharded step's loss "
          f"{ranks[0]['one']['loss']:.6f}, grad norm "
          f"{ranks[0]['one']['grad_norm']:.6f} [{card}]")
    for name in TP_TRAIN_VARIANTS:
        _print_rank_records("tp_train", ranks, name, card)
        held = _held_step("tp_train", ranks, name, "one")
        rec0 = ranks[0]["variants"][name]
        held["param_max_abs_diff"] = rec0["param_max_abs_diff"]
        held["param_bound_ratio"] = rec0["param_bound_ratio"]
        require(rec0["param_bound_ratio"] <= 1.0,
                f"tp_train {name}: gathered weights {rec0['param_max_abs_diff']}"
                f" off the unsharded step's, {rec0['param_bound_ratio']} of "
                f"the bound")
        _require_launches("tp_train", ranks, name, want)
        offsets = {sh[-1] for r in ranks for sh in
                   r["variants"][name]["shapes"]["flash_attention"]
                   + r["variants"][name]["shapes"]["flash_attention_bwd"]
                   if len(sh) > 8}
        require(offsets == {0, TRAIN_SEQ // TP_RANKS},
                f"tp_train {name}: K4 / K4b query offsets {offsets}")
        print(f"tp_train {name}: rules {json.dumps(rec0['rules'])}; held "
              f"{json.dumps(held)} (loss and grad norm within {TP_RTOL} of "
              f"the unsharded step's, {rec0['whole_leaves']} leaves held "
              f"whole bit-equal across the ranks, the gathered weights "
              f"within 2 lr + 2^-7 max|w| a leaf) [{card}]")
        out["held"][name] = held
        for r in ranks:
            for k, v in r["variants"][name]["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            for k, v in r["variants"][name]["shapes"].items():
                out["shapes"].setdefault(k, set()).update(map(tuple, v))
    with shared:
        laid = par_train_phase(dev, card, "tp_train", SERVE_ARCH, TP_LAYERS,
                               TP_TRAIN_LAYOUTS, shared_root=shared.name)
    out["wall_s"] += laid["wall_s"]
    out["held"].update(laid["held"])
    for k, v in laid["launches"].items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    for k, v in laid["shapes"].items():
        out["shapes"].setdefault(k, set()).update(v)
    return out


def dryrun_phase(planned: dict, tp: dict, pp: dict, card: str) -> dict:
    """``dryrun_plan_train_llama3_2_3b``: the dry-run's trace
    (``repro_torch.launch.dryrun``, meta tensors, no kernel launched) of
    the cell ``plan_train_phase`` ran, under the plan it ran (one rank, the
    card's figures), and of ``tp_train_phase``'s layout on a fake process
    group of ``TP_RANKS``, held against what those phases measured, reusing
    their results: the kernel calls of ``PLAN_TRAIN_STEPS + 1`` traced
    steps equal ``plan_train``'s launches; the collective calls and result
    bytes by kind equal ``tp_train``'s rank 0's, each variant; the traced
    peak lies within ``DRYRUN_PEAK_RTOL`` of ``max_memory_allocated()``.
    ``pp_tp_train_phase``'s variants are traced on rank 0 of a fake group
    of ``PP_RANKS``: their collective calls and result bytes by kind, and
    their kernel calls, equal the real rank 0's. Prints the traced FLOPs a
    step beside the measured median step, and the achieved FLOP/s as a
    share of ``H100_SXM.peak_flops``."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.core.config import ParallelConfig, ShapeConfig
    from repro_torch.device import H100_SXM
    from repro_torch.launch import dryrun
    from repro_torch.launch.dispatch_analysis import collective_costs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.strategies import make_rules

    cfg = serve_config(SERVE_ARCH)
    fn, args = dryrun.build_step(cfg, planned["shape"], planned["pc"],
                                 planned["rules"])
    rec = dryrun.traced_fields(fn, args)
    del fn, args
    steps = PLAN_TRAIN_STEPS + 1
    predicted = {k: rec["kernel_launches"].get(k, 0) * steps
                 for k in planned["launches"]}
    require(predicted == planned["launches"],
            f"dryrun: {steps} traced steps launch {predicted}, plan_train "
            f"launched {planned['launches']}")
    peak, traced = planned["peak_bytes"], rec["peak_bytes"]
    require(abs(traced - peak) <= DRYRUN_PEAK_RTOL * peak,
            f"dryrun: traced peak {traced} B against plan_train's measured "
            f"{peak} B, outside {DRYRUN_PEAK_RTOL}")
    step_s = float(np.median(planned["step_ms"])) / 1e3
    achieved = rec["flops_per_device"] / step_s
    out = {"trace_s": rec["trace_s"], "flops": rec["flops_per_device"],
           "attention_flops": rec["attention_flops"],
           "kernel_launches": rec["kernel_launches"],
           "peak_bytes": traced, "measured_peak_bytes": peak,
           "peak_ratio": traced / peak, "step_s": step_s,
           "achieved_flops_per_s": achieved,
           "peak_share": achieved / H100_SXM.peak_flops, "tp": {}}
    print(f"dryrun {SERVE_ARCH} plan_train cell (one rank, plan "
          f"{json.dumps(planned['plan'])}): traced in {rec['trace_s']:.2f} s "
          f"on the host; {rec['flops_per_device']:.6g} FLOPs a step "
          f"({rec['attention_flops']:.6g} in K4 and K4b), the measured "
          f"median step {step_s * 1e3:.2f} ms: {achieved:.6g} FLOP/s, "
          f"{out['peak_share']:.4f} of H100_SXM's {H100_SXM.peak_flops:.4g}; "
          f"kernel calls x{steps} {predicted} equal plan_train's; traced peak "
          f"{traced} B against max_memory_allocated {peak} B (ratio "
          f"{out['peak_ratio']:.4f}) [{card}]")
    tcfg = dataclasses.replace(cfg, num_layers=TP_LAYERS)
    shape = ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    mesh = Mesh({"data": 1, "model": TP_RANKS})
    dryrun.fake_world(TP_RANKS)
    try:
        for name, fields in TP_TRAIN_VARIANTS.items():
            pc = ParallelConfig(**fields)
            fn, args = dryrun.build_step(tcfg, shape, pc,
                                         make_rules(mesh, tcfg, shape, pc))
            t = dryrun.traced_fields(fn, args)
            want_bytes, want_counts = collective_costs(tp["collectives"][name])
            got = {"calls": t["collective_counts"],
                   "result_bytes": t["collective_bytes_by_kind"]}
            require(got == {"calls": want_counts, "result_bytes": want_bytes},
                    f"dryrun tp_train {name}: traced collectives {got}, rank "
                    f"0 made {want_counts} calls of {want_bytes} B")
            out["tp"][name] = {"trace_s": t["trace_s"], **got}
            print(f"dryrun tp_train {name} (rank 0 of {TP_RANKS}, fake "
                  f"process group): collectives {json.dumps(got)} equal the "
                  f"real rank 0's; traced in {t['trace_s']:.2f} s [{card}]")
        out["pp_tp"] = {}
        pcfg = dataclasses.replace(cfg, num_layers=PP_LAYERS)
        shape = ShapeConfig("chip_train", TRAIN_SEQ, PP_BATCH, "train")
        dryrun.fake_world(PP_RANKS)
        for name, (mesh_shape, profile, overrides) in PP_TP_VARIANTS.items():
            pc, rules = dryrun.packing_plan(SERVE_ARCH, pcfg,
                                            Mesh(mesh_shape),
                                            PP_MICROBATCHES, overrides,
                                            profile)
            fn, args = dryrun.build_step(pcfg, shape, pc, rules,
                                         pipeline=True)
            t = dryrun.traced_fields(fn, args)
            want_bytes, want_counts = collective_costs(pp["collectives"][name])
            launched = {k: v for k, v in pp["rank0_launches"][name].items()
                        if v}
            got = {"calls": t["collective_counts"],
                   "result_bytes": t["collective_bytes_by_kind"],
                   "kernels": t["kernel_launches"]}
            require(got == {"calls": want_counts, "result_bytes": want_bytes,
                            "kernels": launched},
                    f"dryrun pp_tp_train {name}: traced {got}, rank 0 made "
                    f"{want_counts} calls of {want_bytes} B and launched "
                    f"{launched}")
            out["pp_tp"][name] = {"trace_s": t["trace_s"], **got}
            print(f"dryrun pp_tp_train {name} (rank 0 of {PP_RANKS}, fake "
                  f"process group): collectives and kernel calls "
                  f"{json.dumps(got)} equal the real rank 0's; traced in "
                  f"{t['trace_s']:.2f} s [{card}]")
    finally:
        dist.destroy_process_group()
    return out


def zero3_train_rank(rank: int, world: int, root: str, variants: dict):
    """One of ``world`` ranks sharing the card (``gloo``, ``pure_dp`` on
    ``data=world``): for each variant the unsharded step on the whole
    batch at its microbatch count (each rank its own, from the same seed),
    then one step on this rank's 1/world of every weight matrix's embed
    dimension; its slice of the updated master weights held to the same
    slice of the unsharded step's. Writes ``root/rank{rank}.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.convert import shard_named
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.parallel.strategies import make_rules
    from repro_torch.training import make_train_step

    dev, cfg, shape, batch = _rank_setup(rank, world, root, TP_LAYERS)
    mesh = Mesh({"data": world, "model": 1})
    out = {"rank": rank, "variants": {}}
    for name, (fields, regather) in variants.items():
        pc = ParallelConfig(**fields)
        one = _one_rank_step(cfg, dev, shape, batch, pc.microbatches)
        rules = make_rules(mesh, cfg, shape, pc)
        require_executable(rules, cfg=cfg)
        mine = shard_named(one.pop("master"), cfg, rules)
        out[f"one_{name}"] = {"loss": one["loss"],
                              "grad_norm": one["grad_norm"]}
        del one
        state = _sharded_state(cfg, dev, rules)
        step = make_train_step(cfg, shape, OptimizerConfig(
            lr=TRAIN_LR, warmup_steps=0), pc, rules=rules,
            regather=regather)
        state, metrics, rec = _timed_step(step, state, batch)
        rec["whole_sha256"], rec["whole_leaves"] = _whole_digest(
            cfg, rules, dict(state["params"].named_parameters()))
        rec["rules"] = {k: v for k, v in rules.rules.items()
                        if v is not None}
        diff, apart, total = 0.0, 0, 0
        for k, m in state["opt"]["master"].items():
            d = (m - mine[k].to(dev)).abs()
            diff = max(diff, float(d.max()))
            apart += int((d > TRAIN_LR).sum())
            total += d.numel()
        rec["master_max_abs_diff"] = diff
        rec["master_moved_apart"] = apart / total
        out["variants"][name] = rec
        del state, step, metrics, mine
        _release()
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def zero3_train_phase(dev, card: str) -> dict:
    """``zero3_train_llama3_2_3b``: ``TP_RANKS`` ranks sharing the card
    under ``pure_dp`` (``w_embed`` over both), one step of each
    ``ZERO_VARIANTS`` entry (``zero3_train_rank``). Held: every rank's loss
    and grad norm within ``TP_RTOL`` of the unsharded step's at the same
    microbatch count; the leaves held whole bit-equal across the ranks;
    each rank's slice of the updated fp32 master weights within ``2 lr``
    (+ 1e-6) of the same slice of the unsharded step's (``tp_param_bound``
    without the bf16 rounding); K4 twice and K4b once an attention layer a
    microbatch."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        wall, ranks = _spawn(zero3_train_rank, TP_RANKS, root,
                             ZERO_VARIANTS)
    out = {"wall_s": wall, "held": {}, "launches": {}, "shapes": {}}
    print(f"zero3_train {SERVE_ARCH} ({TP_LAYERS} of 28 layers at full "
          f"width, {TRAIN_BATCH}x{TRAIN_SEQ} tokens): {TP_RANKS} ranks on "
          f"one card (gloo), {wall:.2f} s [{card}]")
    for name, (fields, _) in ZERO_VARIANTS.items():
        mb = fields.get("microbatches", 1)
        _print_rank_records("zero3_train", ranks, name, card)
        held = _held_step("zero3_train", ranks, name, f"one_{name}")
        bound = 2 * TRAIN_LR + 1e-6
        for r in ranks:
            rec = r["variants"][name]
            require(rec["master_max_abs_diff"] <= bound,
                    f"zero3_train {name} rank {r['rank']}: master weights "
                    f"{rec['master_max_abs_diff']} off the unsharded "
                    f"step's slice (bound {bound})")
        held["master_max_abs_diff"] = max(
            r["variants"][name]["master_max_abs_diff"] for r in ranks)
        held["master_moved_apart"] = max(
            r["variants"][name]["master_moved_apart"] for r in ranks)
        _require_launches("zero3_train", ranks, name, {
            "flash_attention": 2 * TP_LAYERS * mb,
            "flash_attention_bwd": TP_LAYERS * mb, "decode_attention": 0})
        rec0 = ranks[0]["variants"][name]
        print(f"zero3_train {name}: rules {json.dumps(rec0['rules'])}; "
              f"held {json.dumps(held)} (loss and grad norm within "
              f"{TP_RTOL} of the unsharded step's at {mb} microbatches, "
              f"{rec0['whole_leaves']} leaves held whole bit-equal across "
              f"the ranks, each rank's master slice within {bound}; "
              f"master_moved_apart: the share of weights more than lr "
              f"apart, a gradient sign that differs) [{card}]")
        out["held"][name] = held
        for r in ranks:
            for k, v in r["variants"][name]["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            for k, v in r["variants"][name]["shapes"].items():
                out["shapes"].setdefault(k, set()).update(map(tuple, v))
    return out


def pp_tp_train_rank(rank: int, world: int, root: str, variants: dict):
    """One of ``world`` ranks sharing the card (``gloo``): llama at full
    width cut to ``PP_LAYERS`` layers, for each variant one pipelined step
    on this rank's shards of its stage (``dryrun.packing_plan``); each
    rank holds its updated shards to the same slices of the phase's
    unsharded step's on the whole ``PP_BATCH`` x ``TRAIN_SEQ`` batch
    (``_unsharded_step``, loaded from ``root``) within ``tp_param_bound``
    and records the bits of the leaves it holds whole. Writes
    ``root/rank{rank}.json``."""
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.launch.dryrun import packing_plan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_lm
    from repro_torch.models.convert import (_cuts, _meta_leaves, _shard,
                                            shard_params)
    from repro_torch.parallel.pipeline import (init_pp_train_state,
                                               make_pp_train_step)
    from repro_torch.parallel.sharding import require_executable

    t0 = time.perf_counter()
    dev, cfg, shape, batch = _rank_setup(rank, world, root, PP_LAYERS,
                                         PP_BATCH)
    seconds = {"setup": time.perf_counter() - t0}
    one = _load_unsharded(root)["one"]
    leaves = _meta_leaves(cfg)
    out = {"rank": rank, "one": {"loss": one["loss"],
                                 "grad_norm": one["grad_norm"]},
           "variants": {}, "seconds": seconds}
    for name, (mesh_shape, profile, overrides) in variants.items():
        t0 = time.perf_counter()
        mesh = Mesh(mesh_shape)
        pc, rules = packing_plan(SERVE_ARCH, cfg, mesh, PP_MICROBATCHES,
                                 overrides, profile)
        require_executable(rules, pipeline=True, cfg=cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        full = init_lm(cfg, gen, dev)
        local = shard_params(full, rules)
        del full
        _release()
        state = init_pp_train_state(cfg, local, mesh)
        step = make_pp_train_step(cfg, shape, OptimizerConfig(
            lr=TRAIN_LR, warmup_steps=0), pc, rules)
        seconds[f"{name}_build"] = time.perf_counter() - t0
        state, metrics, rec = _timed_step(step, state, batch)
        t0 = time.perf_counter()
        named = dict(state["params"].named_parameters())
        worst, diff, whole = 0.0, 0.0, {}
        for k, p in named.items():
            cuts = _cuts(rules, leaves[k][1], tuple(one["params"][k].shape))
            want = _shard(one["params"][k], cuts).to(dev)
            d = float((p.detach().float() - want.float()).abs().max())
            worst = max(worst, d / tp_param_bound(one["max_abs"][k]))
            diff = max(diff, d)
            if not cuts:
                whole[k] = hashlib.sha256(p.detach().contiguous().view(-1)
                                          .view(torch.uint8).cpu().numpy()
                                          ).hexdigest()
        rec.update(param_max_abs_diff=diff, param_bound_ratio=worst,
                   whole=whole, stage=mesh.coordinate()["pod"],
                   coordinate=mesh.coordinate(),
                   rules={k: v for k, v in rules.rules.items()
                          if v is not None},
                   pc={k: getattr(pc, k) for k in (
                       "attn_strategy", "mlp_mode", "fsdp", "remat",
                       "microbatches")})
        out["variants"][name] = rec
        del named, state, step, metrics, local
        _release()
        seconds[f"{name}_hold"] = time.perf_counter() - t0
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def pp_tp_train_phase(dev, card: str) -> dict:
    """``pp_tp_train_llama3_2_3b``: ``PP_RANKS`` ranks sharing the card, one
    pipelined step of each ``PP_TP_VARIANTS`` entry over ``pod=2`` stages
    with the packing cell's splits inside them (``pp_tp_train_rank``).
    Held: every rank's loss and grad norm within ``TP_RTOL`` of the
    unsharded step's; every rank's updated shards within
    ``tp_param_bound`` of the same slices of the unsharded step's; every
    leaf a rank holds whole bit-equal on every rank that holds it; K4
    twice and K4b once a layer of the rank's stage a microbatch, at the
    query offset of the rank's block of the sequence under ``seq_tp``."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        shared = _unsharded_step(dev, SERVE_ARCH, PP_LAYERS, rows=PP_BATCH)
        one = shared["one"]
        one["max_abs"] = {k: float(t.to(dev).abs().max())
                          for k, t in one["params"].items()}
        _save_unsharded(root, shared)
        del shared, one
        one_s = time.perf_counter() - t0
        wall, ranks = _spawn(pp_tp_train_rank, PP_RANKS, root,
                             PP_TP_VARIANTS)
    per_stage = PP_LAYERS // 2
    want = {"flash_attention": 2 * per_stage * PP_MICROBATCHES,
            "flash_attention_bwd": per_stage * PP_MICROBATCHES,
            "decode_attention": 0}
    out = {"wall_s": wall, "held": {}, "launches": {}, "shapes": {},
           "collectives": {}, "rank0_launches": {}}
    print(f"pp_tp_train {SERVE_ARCH} ({PP_LAYERS} of 28 layers at full "
          f"width, {per_stage} a stage, {PP_BATCH}x{TRAIN_SEQ} tokens in "
          f"{PP_MICROBATCHES} microbatches): {PP_RANKS} ranks on one card "
          f"(gloo; the shifts' batch_isend_irecv through host memory), "
          f"the unsharded step {one_s:.2f} s before them, {wall:.2f} s "
          f"(rank 0's parts, s: "
          f"{json.dumps({k: round(v, 2) for k, v in ranks[0]['seconds'].items()})}"
          f"); the unsharded step's loss {ranks[0]['one']['loss']:.6f}, "
          f"grad norm {ranks[0]['one']['grad_norm']:.6f} [{card}]")
    rel = lambda a, b: abs(a - b) / abs(b)
    for name, (mesh_shape, profile, _) in PP_TP_VARIANTS.items():
        _print_rank_records("pp_tp_train", ranks, name, card)
        held = {"loss": 0.0, "grad_norm": 0.0, "param_bound_ratio": 0.0,
                "param_max_abs_diff": 0.0}
        holders: dict = {}
        for r in ranks:
            rec, one = r["variants"][name], r["one"]
            for k in ("loss", "grad_norm"):
                held[k] = max(held[k], rel(rec[k], one[k]))
                require(rel(rec[k], one[k]) <= TP_RTOL,
                        f"pp_tp_train {name} rank {r['rank']}: {k} "
                        f"{rec[k]} against one rank's {one[k]}")
            require(rec["param_bound_ratio"] <= 1.0,
                    f"pp_tp_train {name} rank {r['rank']}: shards "
                    f"{rec['param_max_abs_diff']} off the unsharded step's, "
                    f"{rec['param_bound_ratio']} of the bound")
            for k in ("param_bound_ratio", "param_max_abs_diff"):
                held[k] = max(held[k], rec[k])
            for k, digest in rec["whole"].items():
                holders.setdefault(k, set()).add(digest)
        require(all(len(d) == 1 for d in holders.values()),
                f"pp_tp_train {name}: leaves held whole differ across the "
                f"ranks that hold them: "
                f"{sorted(k for k, d in holders.items() if len(d) > 1)}")
        require({r["variants"][name]["stage"] for r in ranks} == {0, 1},
                f"pp_tp_train {name}: stages")
        _require_launches("pp_tp_train", ranks, name, want)
        offsets = {sh[-1] if len(sh) > 8 else 0 for r in ranks for sh in
                   r["variants"][name]["shapes"]["flash_attention"]
                   + r["variants"][name]["shapes"]["flash_attention_bwd"]}
        seq = mesh_shape["model"]
        require(offsets == {i * TRAIN_SEQ // seq for i in range(seq)},
                f"pp_tp_train {name}: K4 / K4b query offsets {offsets}")
        rec0 = ranks[0]["variants"][name]
        print(f"pp_tp_train {name} (mesh {json.dumps(mesh_shape)}, the "
              f"{profile} profile's plan {json.dumps(rec0['pc'])}): rules "
              f"{json.dumps(rec0['rules'])}; held {json.dumps(held)} (loss "
              f"and grad norm within {TP_RTOL} of the unsharded step's, "
              f"every rank's shards within 2 lr + 2^-7 max|w| a leaf of the "
              f"unsharded step's slices, {len(holders)} leaves held whole "
              f"bit-equal on every rank that holds them) [{card}]")
        out["held"][name] = held
        out["collectives"][name] = rec0["collectives"]
        out["rank0_launches"][name] = rec0["launches"]
        for r in ranks:
            for k, v in r["variants"][name]["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            for k, v in r["variants"][name]["shapes"].items():
                out["shapes"].setdefault(k, set()).update(map(tuple, v))
    return out


def _decode_prompts(cfg, lengths=TP_PROMPT_LENGTHS):
    """Prompts of ``lengths`` tokens from seed 5, padded with token 0 to the
    longest: ``(tokens (B, S) int32, lengths)``."""
    rng = np.random.default_rng(5)
    s = max(lengths)
    tokens = np.zeros((len(lengths), s), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return tokens, np.asarray(lengths, np.int32)


def _prefill_then_decode(prefill_model, decode_model, cfg, dev, fed,
                         prefill_rules=None, decode_rules=None,
                         lengths=TP_PROMPT_LENGTHS,
                         steps=TP_DECODE_STEPS) -> dict:
    """The prompts of ``lengths`` padded to the longest through
    ``prefill_step`` (under ``prefill_rules``) into a state made under
    ``decode_rules``, every row's position rewound to its last prompt
    token where the lengths differ (a recurrent state cannot be rewound:
    recurrent models take prompts of one length, and decode from the end),
    then ``steps`` ``decode_step``s a row of ``fed`` (the tokens to feed;
    where ``None``, each row's last prompt token, or the prefill's argmax
    where nothing was rewound, and then its argmax): the logits, the tokens
    fed and the step ms."""
    import torch
    from repro_torch.models.lm import (decode_step, init_decode_state,
                                       prefill_step)
    from repro_torch.parallel.sharding import use_rules
    tokens, lengths = _decode_prompts(cfg, lengths)
    rows = np.arange(len(lengths))
    rewind = len(set(lengths.tolist())) > 1
    out = {"decode": [], "step_ms": [], "fed": []}
    with torch.inference_mode():
        with use_rules(decode_rules):
            state = init_decode_state(cfg, len(lengths), TP_MAX_SEQ, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_rules(prefill_rules):
            logits, state = prefill_step(
                prefill_model, state,
                {"tokens": torch.from_numpy(tokens).to(dev)})
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill"] = logits[:, 0].float().cpu()
        if rewind:
            state["pos"] = torch.from_numpy(lengths - 1).to(dev)
            tok = tokens[rows, lengths - 1]
        else:
            tok = out["prefill"].argmax(-1).numpy()
        with use_rules(decode_rules):
            for t in range(steps):
                if fed is not None:
                    tok = fed[t]
                out["fed"].append(np.asarray(tok))
                step_in = torch.from_numpy(np.asarray(tok, np.int32)).to(
                    dev)[:, None]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, state = decode_step(decode_model, state, step_in)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["decode"].append(logits[:, 0].float().cpu())
                tok = logits[:, 0].argmax(-1).cpu().numpy()
    return out


def tp_decode_rank(rank: int, world: int, root: str, fed: list):
    """One of ``world`` ranks sharing the card (``gloo``, ``data=1,
    model=world``): llama at its published config, its shards under the
    planner's ``seq_tp`` rules for the padded prompts' prefill and under
    its ``decode_kv_shard`` rules for the decode steps (the cache split
    along its sequence), fed the tokens ``fed``. Rank 0 writes the logits
    to ``root/tp_logits.pt``; every rank its record to
    ``root/rank{rank}.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.config import ParallelConfig, ShapeConfig
    from repro_torch.kernels import attention as A
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_lm
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.parallel.strategies import make_rules

    dev, cfg, _, _ = _rank_setup(rank, world, root, None)
    mesh = Mesh({"data": 1, "model": world})
    n = len(TP_PROMPT_LENGTHS)
    prefill_rules = make_rules(mesh, cfg, ShapeConfig(
        "tp_prefill", max(TP_PROMPT_LENGTHS), n, "prefill"), ParallelConfig(
        attn_strategy="seq_tp", mlp_mode="tp", fsdp="off"))
    decode_rules = make_rules(mesh, cfg, ShapeConfig(
        "tp_decode", TP_MAX_SEQ, n, "decode"), ParallelConfig(
        attn_strategy="decode_kv_shard", fsdp="off"))
    for rules in (prefill_rules, decode_rules):
        require_executable(rules, cfg=cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    full = init_lm(cfg, gen, dev)
    models = [shard_params(full, r) for r in (prefill_rules, decode_rules)]
    del full
    _release()
    A.reset_launches()
    C.reset_collective_stats()
    torch.cuda.reset_peak_memory_stats()
    with own_shapes() as shapes:
        res = _prefill_then_decode(*models, cfg, dev, fed, prefill_rules,
                                   decode_rules)
    rec = {"rank": rank, "prefill_ms": res["prefill_ms"],
           "step_ms": res["step_ms"], "launches": dict(A.LAUNCHES),
           "collectives": {k: dict(v) for k, v in
                           C.COLLECTIVE_STATS.items()},
           "peak_bytes": int(torch.cuda.max_memory_allocated()),
           "shapes": {k: sorted(v) for k, v in shapes.items()},
           "rules": [{k: v for k, v in r.rules.items() if v is not None}
                     for r in (prefill_rules, decode_rules)]}
    if rank == 0:
        torch.save({"prefill": res["prefill"], "decode": res["decode"]},
                   f"{root}/tp_logits.pt")
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(rec, f)


def tp_decode_phase(dev, card: str) -> dict:
    """``tp_decode_llama3_2_3b``: llama at its published config on one rank
    in this process, the padded prompts prefilled and ``TP_DECODE_STEPS``
    greedy decode steps; then the same on ``TP_RANKS`` ranks sharing the
    card (``tp_decode_rank``), fed the same tokens. Held: every logit of
    the prefill and of each step within ``LOGIT_TOL`` of one rank's, and
    the argmax equal wherever one rank's top two logits lie more than
    ``TP_MARGIN`` apart; K4 once a layer (the prefill) and K5 with its
    log-sum-exp once a layer a step, on every rank."""
    import tempfile

    import torch
    from repro_torch.models import init_lm
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = serve_config(SERVE_ARCH)
    model = init_lm(cfg, gen, dev)
    saved = shape_sets()
    one = _prefill_then_decode(model, model, cfg, dev, None)
    restore_shape_sets(saved)
    del model
    _release()
    with tempfile.TemporaryDirectory() as root:
        wall, ranks = _spawn(tp_decode_rank, TP_RANKS, root, one["fed"])
        got = torch.load(f"{root}/tp_logits.pt")
    worst, disagree, held_rows = 0.0, 0, 0
    for g, w in zip([got["prefill"]] + got["decode"],
                    [one["prefill"]] + one["decode"]):
        worst = max(worst, float((g - w).abs().max()))
        top2 = w.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > TP_MARGIN
        held_rows += int(sure.sum())
        disagree += int((g.argmax(-1) != w.argmax(-1))[sure].sum())
    layers = cfg.num_layers
    steps = TP_DECODE_STEPS
    want = {"flash_attention": layers, "flash_attention_bwd": 0,
            "decode_attention": layers * steps}
    for r in ranks:
        require(r["launches"] == want, f"tp_decode rank {r['rank']}: "
                f"launches {r['launches']}, expected {want}")
        require(r["shapes"]["decode_attention"] and all(
            sh[-1] == "lse" for sh in r["shapes"]["decode_attention"]),
            f"tp_decode rank {r['rank']}: K5 without its log-sum-exp: "
            f"{r['shapes']['decode_attention']}")
    print(f"tp_decode {SERVE_ARCH} (published config, {len(ranks)} ranks on "
          f"one card, gloo, {wall:.2f} s): prompts {list(TP_PROMPT_LENGTHS)}"
          f" padded to {max(TP_PROMPT_LENGTHS)}, prefilled under "
          f"{json.dumps(ranks[0]['rules'][0])}, then {steps} decode steps "
          f"under {json.dumps(ranks[0]['rules'][1])}; one rank's decode ms "
          f"a step median {np.median(one['step_ms']):.2f} [{card}]")
    for r in ranks:
        coll = {k: {"calls": v["calls"], "bytes": v["bytes"],
                    "ms": round(v["seconds"] * 1e3, 2)}
                for k, v in r["collectives"].items()}
        print(f"tp_decode rank {r['rank']}: prefill {r['prefill_ms']:.2f} "
              f"ms, decode ms a step median {np.median(r['step_ms']):.2f} "
              f"(all {[round(x, 2) for x in r['step_ms']]}), peak "
              f"max_memory_allocated {r['peak_bytes']} B, collectives "
              f"{json.dumps(coll)}, launches {r['launches']} [{card}]")
    held = {"logit_max_abs_diff": worst, "argmax_held_rows": held_rows,
            "argmax_disagree": disagree}
    print(f"tp_decode {SERVE_ARCH}: held {json.dumps(held)} (every logit "
          f"within {LOGIT_TOL} of one rank's, the argmax equal where one "
          f"rank's top two lie more than {TP_MARGIN} apart) [{card}]")
    require(worst <= LOGIT_TOL, f"tp_decode logits {worst} off one rank's")
    require(disagree == 0, f"tp_decode: {disagree} argmax differ")
    require(held_rows > 0, "tp_decode: no row's top two logits lie apart")
    launches, shapes = {}, {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in r["shapes"].items():
            shapes.setdefault(k, set()).update(map(tuple, v))
    return {"wall_s": wall, "held": held, "launches": launches,
            "shapes": shapes}


def _timed_step_all(step, state, batch) -> tuple:
    """``_timed_step`` with K1-K3's counters beside K4, K4b and K5's: the
    MoE dispatch runs K2."""
    from repro_torch.kernels import partition as K
    K.reset_launches()
    state, metrics, rec = _timed_step(step, state, batch)
    rec["launches"].update(K.LAUNCHES)
    return state, metrics, rec


@contextlib.contextmanager
def counting_drops():
    """Within the block, every MoE dispatch's dropped assignments and all
    of its assignments, summed: ``{"dropped", "assignments"}``."""
    from repro_torch.models import moe as M
    plain, seen = M.dispatch, {"dropped": 0, "assignments": 0}

    def counting(top_i, e, cap, start=None):
        bk = plain(top_i, e, cap, start)
        seen["dropped"] += int((~bk.keep).sum())
        seen["assignments"] += bk.keep.numel()
        return bk

    M.dispatch = counting
    try:
        yield seen
    finally:
        M.dispatch = plain


@contextlib.contextmanager
def moe_plane_collectives():
    """Within the block, the collectives the MoE layer's expert-parallel
    planes (``moe._moe_a2a``, ``moe._moe_partial``) make inside their calls
    (a forward's; a backward's are made after), by kind: ``{kind: {"calls",
    "bytes", "seconds"}}``."""
    from repro_torch.models import moe as M
    from repro_torch.parallel import collectives as C
    seen: dict = {}
    saved = M._moe_a2a, M._moe_partial

    def counted(fn):
        def call(*args, **kwargs):
            before = {k: dict(v) for k, v in C.COLLECTIVE_STATS.items()}
            try:
                return fn(*args, **kwargs)
            finally:
                for kind, row in C.COLLECTIVE_STATS.items():
                    was = before.get(kind, {})
                    acc = seen.setdefault(kind, {"calls": 0, "bytes": 0,
                                                 "seconds": 0.0})
                    for f in acc:
                        acc[f] += row[f] - was.get(f, 0)
        return call

    M._moe_a2a, M._moe_partial = map(counted, saved)
    try:
        yield seen
    finally:
        M._moe_a2a, M._moe_partial = saved
        for kind in [k for k, v in seen.items() if not v["calls"]]:
            del seen[kind]


def _drops_at(model, cfg, batch, rules=None, factor: float = 1.25) -> dict:
    """One no-grad ``forward_hidden`` of ``batch`` (remat none) with the MoE
    capacity factor at ``factor`` under ``rules``: the assignments this
    rank's dispatches dropped, and the collectives its MoE planes made
    (``moe_plane_collectives``)."""
    import dataclasses

    import torch
    from repro_torch.models.lm import forward_hidden
    from repro_torch.parallel.sharding import use_rules
    saved = model.cfg
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    try:
        with torch.no_grad(), use_rules(rules), counting_drops() as seen, \
                moe_plane_collectives() as coll:
            forward_hidden(model, batch, remat="none")
    finally:
        model.cfg = saved
    if coll:
        seen["plane_collectives"] = coll
    return seen


def _shard_bound(one_params: dict, named: dict, cfg, rules, dev) -> tuple:
    """This rank's updated shards against the same shards of the unsharded
    step's weights: the max |diff| and its largest ratio to
    ``tp_param_bound``, leaf by leaf (no collective)."""
    from repro_torch.models.convert import shard_named
    worst, diff = 0.0, 0.0
    for k, p in named.items():
        want = shard_named({k: one_params[k]}, cfg, rules)[k].to(dev).float()
        d = float((p.detach().float() - want).abs().max())
        worst = max(worst, d / tp_param_bound(float(want.abs().max())))
        diff = max(diff, d)
    return diff, worst


def variant_rules(mesh_shape: dict, fields, cfg, shape) -> tuple:
    """``(pc, rules)`` of a train variant on a mesh of ``mesh_shape``: the
    planner's ``make_rules`` under ``ParallelConfig(**fields)``, or, where
    ``fields`` names a hand-written layout (``sharding.LAYOUTS``, the
    tests' layouts too), its ``layout_rules`` under ``remat="block"``."""
    from repro_torch.core.config import ParallelConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import layout_rules
    from repro_torch.parallel.strategies import make_rules
    if isinstance(fields, str):
        return ParallelConfig(remat="block"), layout_rules(Mesh(mesh_shape),
                                                           fields)
    pc = ParallelConfig(**fields)
    return pc, make_rules(Mesh(mesh_shape), cfg, shape, pc)


def variant_world(mesh_shape: dict) -> int:
    return math.prod(mesh_shape.values())


def _layer_drops(model, cfg, rules=None, factor: float = 1.25) -> dict:
    """The first MoE layer alone (``moe.moe_parts``) at capacity factor
    ``factor`` on one seeded ``(TRAIN_BATCH, TRAIN_SEQ, d)`` input in the
    model's dtype (seed 11, a direction every token shares skewing the
    routing, so that some assignments drop), under ``rules`` on the rank's
    rows and positions of it: its dispatches' drops and assignments
    (``counting_drops``). The same input and router on every rank, so the
    drops can be held exactly."""
    import dataclasses

    import torch
    from repro_torch.models import moe as M
    from repro_torch.parallel.tensor import tensor_plan
    layer = next(b.ffn for b in model.layers
                 if isinstance(getattr(b, "ffn", None), M.MoE))
    dev = layer.router.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=dev)
    x = (x + 2.0 * torch.randn((cfg.d_model,), generator=gen,
                               device=dev)).to(layer.gate.dtype)
    plan = tensor_plan(rules) if rules is not None else None
    if plan is not None:
        if plan.batch:
            lo, n = plan.batch.block(x.shape[0])
            x = x[lo:lo + n]
        x = plan.seq_block(x)
    low = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    with torch.no_grad(), counting_drops() as seen:
        M.moe_parts(layer, x, low, plan=plan)
    return dict(seen)


def par_train_rank(rank: int, world: int, root: str, arch: str, layers,
                   variants: dict, drops: bool, dtype, device: str,
                   shared_root: str):
    """One of ``world`` ranks sharing the card (``gloo``): ``arch`` at its
    published width (``_par_inputs``) with the phase's unsharded step
    (``_unsharded_step``, loaded from ``shared_root``); for each variant
    ``(mesh shape, ParallelConfig fields or a layout name:
    variant_rules)`` every rank runs one step on its shards under the
    variant's rules, its updated shards held to the unsharded step's
    (``_shard_bound``). With ``drops``, the assignments one forward drops
    at the model's capacity factor 1.25, unsharded and under each
    variant's rules, and those of the first MoE layer alone on one input
    (``_layer_drops``). With ``dtype`` other than the published one, the
    model runs in ``dtype`` (weights drawn in fp32, not rounded) and the
    unsharded step also runs in the published dtype on the same weights
    rounded: the rounding floor. The model lives on ``device`` (the
    card). Writes ``root/rank{rank}.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.training import make_train_step

    init_distributed(rank, world, f"file://{root}/rendezvous", device)
    dev = torch.device(device)
    cfg, _, shape, batch = _par_inputs(arch, layers, dtype, dev)
    shared = _load_unsharded(shared_root)
    one = shared.pop("one")
    out = {"rank": rank, "variants": {}, **shared,
           "one": {"loss": one["loss"], "grad_norm": one["grad_norm"]}}
    for name, (mesh_shape, fields) in variants.items():
        pc, rules = variant_rules(mesh_shape, fields, cfg, shape)
        require_executable(rules, cfg=cfg)
        state = _sharded_state(cfg, dev, rules)
        drops_125 = _drops_at(state["params"], cfg, batch, rules) \
            if drops else None
        layer_drops = _layer_drops(state["params"], cfg, rules) \
            if drops else None
        step = make_train_step(cfg, shape, OptimizerConfig(
            lr=TRAIN_LR, warmup_steps=0), pc, rules=rules)
        state, metrics, rec = _timed_step_all(step, state, batch)
        named = dict(state["params"].named_parameters())
        rec["whole_sha256"], rec["whole_leaves"] = _whole_digest(
            cfg, rules, named)
        rec["rules"] = {k: v for k, v in rules.rules.items()
                        if v is not None}
        rec["mesh"] = mesh_shape
        rec["remat"] = pc.remat
        rec["param_max_abs_diff"], rec["param_bound_ratio"] = _shard_bound(
            one["params"], named, cfg, rules, dev)
        if drops_125 is not None:
            rec["drops_1.25"] = drops_125
            rec["layer_drops_1.25"] = layer_drops
        out["variants"][name] = rec
        del named, state, step, metrics
        _release()
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def par_train_phase(dev, card: str, prefix: str, arch: str, layers,
                    variants: dict, drops: bool = False,
                    dtype: str | None = None,
                    shared_root: str | None = None) -> dict:
    """Ranks sharing the card, one step of each variant
    (``par_train_rank``): one spawn of ``PAR_RANKS`` ranks for the variants
    on meshes of that many, one of ``PP_RANKS`` for those on ``data=2 x
    model=2``. Held as ``tp_train`` holds llama: every rank's loss and
    grad norm within ``TP_RTOL`` of the unsharded step's, the leaves held
    whole bit-equal across the ranks, every rank's updated shards within
    ``tp_param_bound``; K4 twice and K4b once an attention layer, K2 once
    a MoE layer in the forward and again in its recompute (twice under
    ``remat=block``, the same under ``dots``, which keeps no dispatch).
    With ``drops``, for the variants of ``DROPS_HELD`` (their planes
    compute the unsharded layer's chunks) the first MoE layer's drops on
    one input (``_layer_drops``), summed over the ranks and divided by how
    many ranks dispatch each token, equal the unsharded layer's.
    ``shared_root``: where an earlier phase left its unsharded step on the
    same model and batch (``_save_unsharded``), else the phase runs it
    here, once, before its spawns."""
    import dataclasses
    import tempfile

    groups: dict = {}
    for name, (mesh_shape, fields) in variants.items():
        groups.setdefault(variant_world(mesh_shape), {})[name] = \
            (mesh_shape, fields)
    spawned, wall = {}, 0.0
    with contextlib.ExitStack() as stack:
        if shared_root is None:
            shared_root = stack.enter_context(tempfile.TemporaryDirectory())
            _save_unsharded(shared_root, _unsharded_step(
                dev, arch, layers, dtype, drops))
        for world, group in sorted(groups.items()):
            with tempfile.TemporaryDirectory() as root:
                took, ranks = _spawn(par_train_rank, world, root, arch,
                                     layers, group, drops, dtype, dev.type,
                                     shared_root)
            wall += took
            spawned[world] = (took, ranks)
    cfg = serve_config(arch)
    n_layers = layers if layers is not None else cfg.num_layers
    cut = dataclasses.replace(cfg, num_layers=n_layers)
    attn, moe = attention_layers(cut), moe_layers(cut)
    out = {"wall_s": wall, "held": {}, "launches": {}, "shapes": {}}
    first = spawned[min(spawned)][1][0]
    print(f"{prefix} {arch} ({n_layers} of {cfg.num_layers} layers at full "
          f"width, {dtype or cfg.dtype}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens"
          f"{', drop-free capacity E / top_k' if cfg.moe else ''}): "
          + ", ".join(f"{w} ranks on one card (gloo) {t:.2f} s"
                      for w, (t, _) in sorted(spawned.items()))
          + f"; the unsharded step's loss {first['one']['loss']:.6f}, grad "
          f"norm {first['one']['grad_norm']:.6f} [{card}]")
    if "one_low" in first:
        low = first["one_low"]
        print(f"{prefix} rounding floor: the unsharded step in "
              f"{low['dtype']} on the same weights rounded: loss "
              f"{low['loss']:.6f}, grad norm {low['grad_norm']:.6f} (not "
              f"held) [{card}]")
    if drops:
        print(f"{prefix} capacity drops at factor 1.25 in one forward, "
              f"unsharded (chunks of 1024): "
              f"{json.dumps(first['one_drops'])}; the first MoE layer "
              f"alone on one input: {json.dumps(first['one_layer_drops'])} "
              f"[{card}]")
    for name, (mesh_shape, _) in variants.items():
        ranks = spawned[variant_world(mesh_shape)][1]
        _print_rank_records(prefix, ranks, name, card)
        held = _held_step(prefix, ranks, name, "one")
        worst = max(r["variants"][name]["param_bound_ratio"] for r in ranks)
        held["param_max_abs_diff"] = max(
            r["variants"][name]["param_max_abs_diff"] for r in ranks)
        held["param_bound_ratio"] = worst
        require(worst <= 1.0, f"{prefix} {name}: updated shards "
                f"{held['param_max_abs_diff']} off the unsharded step's, "
                f"{worst} of the bound")
        # a recompute (``block``, or ``dots``, which keeps the matrix
        # products only) runs K4 and the dispatch's K2 again
        rec0 = ranks[0]["variants"][name]
        recompute = 2 if rec0["remat"] != "none" else 1
        want = {"flash_attention": recompute * attn,
                "flash_attention_bwd": attn, "decode_attention": 0,
                "partition_histogram": 0,
                "partition_scatter": recompute * moe, "fused_probe": 0}
        _require_launches(prefix, ranks, name, want)
        if drops:
            by_rank = [dict(r["variants"][name]["drops_1.25"])
                       for r in ranks]
            planes = [d.pop("plane_collectives", {}) for d in by_rank]
            print(f"{prefix} {name} capacity drops at factor 1.25 in one "
                  f"forward, by rank: {by_rank} (summed "
                  f"{sum(d['dropped'] for d in by_rank)}; unsharded "
                  f"{first['one_drops']['dropped']}) [{card}]")
            for r, coll in zip(ranks, planes):
                shown = {k: {"calls": v["calls"], "bytes": v["bytes"],
                             "ms": round(v["seconds"] * 1e3, 2)}
                         for k, v in coll.items()}
                print(f"{prefix} {name} rank {r['rank']}: the MoE planes' "
                      f"collectives in that forward, by kind: "
                      f"{json.dumps(shown)} [{card}]")
            layer = [r["variants"][name]["layer_drops_1.25"] for r in ranks]
            want_l = first["one_layer_drops"]
            dropped = sum(d["dropped"] for d in layer)
            assigned = sum(d["assignments"] for d in layer)
            print(f"{prefix} {name} the first MoE layer alone at factor "
                  f"1.25, by rank: {layer} (unsharded {want_l}) [{card}]")
            if name in DROPS_HELD:
                require(want_l["dropped"] > 0 and assigned
                        % want_l["assignments"] == 0
                        and dropped * want_l["assignments"]
                        == want_l["dropped"] * assigned,
                        f"{prefix} {name}: the first MoE layer's drops "
                        f"{layer} against the unsharded layer's {want_l}")
                held["layer_drops_held"] = True
        print(f"{prefix} {name}: mesh {json.dumps(rec0['mesh'])}, rules "
              f"{json.dumps(rec0['rules'])}; held {json.dumps(held)} (loss "
              f"and grad norm within {TP_RTOL} of the unsharded step's, "
              f"{rec0['whole_leaves']} leaves held whole bit-equal across "
              f"the ranks, each rank's updated shards within 2 lr + 2^-7 "
              f"max|w| a leaf) [{card}]")
        out["held"][name] = held
        for r in ranks:
            for k, v in r["variants"][name]["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            for k, v in r["variants"][name]["shapes"].items():
                out["shapes"].setdefault(k, set()).update(map(tuple, v))
    return out


def same_cuts(cfg, rules_a, rules_b) -> bool:
    """Whether two rule sets cut every leaf of ``cfg`` alike."""
    from repro_torch.models.convert import _cuts, _halves, _meta_leaves
    leaves, halves = _meta_leaves(cfg), _halves(cfg)
    return all(_cuts(rules_a, logical, tuple(shape.shape), name in halves)
               == _cuts(rules_b, logical, tuple(shape.shape), name in halves)
               for name, (shape, logical) in leaves.items())


def _shared_shards(full, rules_a, rules_b, dtype):
    """This rank's shards of ``full`` under two rule sets, as two models
    in ``dtype``, made leaf by leaf (each of ``full``'s leaves dropped once
    cut): a leaf cut alike by both is one tensor in both."""
    import torch
    from repro_torch.models.convert import (_cuts, _halves, _meta_leaves,
                                            _shard)
    from repro_torch.models.lm import LM
    cfg = full.cfg
    leaves, halves = _meta_leaves(cfg), _halves(cfg)
    a, b = (LM(cfg, None, torch.device("meta")) for _ in range(2))
    def cast(t):           # fp32 leaves (routers, a_log, r_gates) stay
        return t if t.dtype == torch.float32 else t.to(dtype)

    for name, p in list(full.named_parameters()):
        *path, leaf = name.split(".")
        mod = ".".join(path)
        logical, two = leaves[name][1], name in halves
        cuts_a = _cuts(rules_a, logical, tuple(p.shape), two)
        cuts_b = _cuts(rules_b, logical, tuple(p.shape), two)
        pa = torch.nn.Parameter(cast(_shard(p.detach(), cuts_a)),
                                requires_grad=False)
        pb = pa if cuts_a == cuts_b else torch.nn.Parameter(
            cast(_shard(p.detach(), cuts_b)), requires_grad=False)
        setattr(a.get_submodule(mod), leaf, pa)
        setattr(b.get_submodule(mod), leaf, pb)
        setattr(full.get_submodule(mod), leaf, None)
        del p
    return a, b


def par_decode_rank(rank: int, world: int, root: str, spec: dict, fed,
                    device: str):
    """One of ``world`` ranks sharing the card (``gloo``, ``data=1,
    model=world``): the model of ``spec`` (``_decode_cfg``), its shards
    under the planner's rules for the prefill shape (``spec["prefill"]``,
    ParallelConfig fields) and for the decode shape (``spec["decode"]``),
    in ``spec["dtype"]``; with ``spec["forward"]``, one ``forward`` of the
    padded prompts under the prefill rules (or, where ``spec["forward"]``
    gives ``ParallelConfig`` fields, under their rules at the prefill
    shape, on the prefill's shards); then ``_prefill_then_decode``
    fed the tokens ``fed``. Rank 0 writes the logits to
    ``root/logits.pt``; every rank its record to ``root/rank{rank}.json``.
    The model lives on ``device`` (the card)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core.config import ParallelConfig, ShapeConfig
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import partition as K
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.models import forward, init_lm
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import require_executable, use_rules
    from repro_torch.parallel.strategies import make_rules

    init_distributed(rank, world, f"file://{root}/rendezvous", device)
    dev = torch.device(device)
    cfg = _decode_cfg(spec)
    mesh = Mesh({"data": 1, "model": world})
    n = len(spec["lengths"])
    prefill_rules = make_rules(mesh, cfg, ShapeConfig(
        "par_prefill", max(spec["lengths"]), n, "prefill"),
        ParallelConfig(**spec["prefill"]))
    decode_rules = make_rules(mesh, cfg, ShapeConfig(
        "par_decode", TP_MAX_SEQ, n, "decode"),
        ParallelConfig(**spec["decode"]))
    forward_rules = prefill_rules
    if isinstance(spec.get("forward"), dict):
        lengths = forward_lengths(spec)
        forward_rules = make_rules(mesh, cfg, ShapeConfig(
            "par_forward", max(lengths), len(lengths), "prefill"),
            ParallelConfig(**spec["forward"]))
        require(same_cuts(cfg, forward_rules, prefill_rules),
                f"the forward's rules cut the leaves otherwise than the "
                f"prefill's: {forward_rules.rules}")
    for rules in (prefill_rules, decode_rules, forward_rules):
        require_executable(rules, cfg=cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    full = init_lm(dataclasses.replace(cfg, dtype=spec["build_dtype"]), gen,
                   dev)
    full.cfg = cfg
    models = _shared_shards(full, prefill_rules, decode_rules,
                            getattr(torch, spec["dtype"]))
    del full
    _release()
    for m in models:
        m.cfg = cfg
    A.reset_launches()
    K.reset_launches()
    C.reset_collective_stats()
    torch.cuda.reset_peak_memory_stats()
    logits = {}
    with own_shapes() as shapes:
        if spec.get("forward"):
            tokens, _ = _decode_prompts(cfg, forward_lengths(spec))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode(), use_rules(forward_rules):
                logits["forward"] = forward(models[0], {
                    "tokens": torch.from_numpy(tokens).to(dev)})[0][
                    ..., :cfg.vocab_size].cpu()
            torch.cuda.synchronize()
            forward_ms = (time.perf_counter() - t0) * 1e3
        res = _prefill_then_decode(*models, cfg, dev, fed, prefill_rules,
                                   decode_rules, spec["lengths"],
                                   spec["steps"])
    rec = {"rank": rank, "prefill_ms": res["prefill_ms"],
           "step_ms": res["step_ms"],
           "launches": {**A.LAUNCHES, **K.LAUNCHES},
           "collectives": {k: dict(v) for k, v in
                           C.COLLECTIVE_STATS.items()},
           "peak_bytes": int(torch.cuda.max_memory_allocated()),
           "shapes": {k: sorted(v) for k, v in shapes.items()},
           "rules": [{k: v for k, v in r.rules.items() if v is not None}
                     for r in (prefill_rules, decode_rules, forward_rules)]}
    if spec.get("forward"):
        rec["forward_ms"] = forward_ms
    if rank == 0:
        logits.update(prefill=res["prefill"], decode=res["decode"])
        torch.save(logits, f"{root}/logits.pt")
    dist.destroy_process_group()
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(rec, f)


def forward_lengths(spec: dict) -> tuple:
    """The prompt lengths of ``spec``'s forward: ``spec["forward_lengths"]``
    where given, else the prefill's."""
    return tuple(spec.get("forward_lengths", spec["lengths"]))


def _decode_cfg(spec: dict):
    """``spec["arch"]``'s published config cut to ``spec["layers"]``
    layers, drop-free where it has experts, in ``spec["dtype"]``."""
    import dataclasses
    cfg = drop_free(serve_config(spec["arch"]))
    return dataclasses.replace(cfg, num_layers=spec["layers"],
                               dtype=spec["dtype"])


def par_decode_phase(dev, card: str, prefix: str, spec: dict) -> dict:
    """The model of ``spec`` on one rank in this process (built in
    ``spec["build_dtype"]`` from seed 0 and cast to ``spec["dtype"]``,
    exactly: every bf16 value is an fp32 value): with ``spec["forward"]``
    one ``forward`` of the padded prompts (on the ranks under the prefill
    rules, or under the rules of the ``ParallelConfig`` fields
    ``spec["forward"]`` gives, which must cut the leaves alike), then the
    prompts prefilled and
    ``spec["steps"]`` greedy decode steps; then the same on ``PAR_RANKS``
    ranks sharing the card (``par_decode_rank``), fed the same tokens.
    Held: every logit within ``LOGIT_TOL`` of one rank's, and the argmax
    equal wherever one rank's top two logits lie more than ``TP_MARGIN``
    apart; K4 once an attention layer a prefill (and a forward), K5 with
    its log-sum-exp once an attention layer a step, K2 once a MoE layer a
    call, on every rank."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.models import forward, init_lm
    from repro_torch.parallel.sharding import use_rules
    cfg = _decode_cfg(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    built = dataclasses.replace(cfg, dtype=spec["build_dtype"])
    model = init_lm(built, gen, dev)
    saved = shape_sets()
    low = None
    if spec["dtype"] != spec["build_dtype"]:
        # the rounding floor: one rank in the build dtype, fed the tokens
        # it chooses; the held runs are fed the same
        model.cfg = built
        low = _prefill_then_decode(model, model, built, dev, None, None,
                                   None, spec["lengths"], spec["steps"])
        model = model.to(getattr(torch, spec["dtype"]))
    model.cfg = cfg
    one = {}
    if spec.get("forward"):
        tokens, _ = _decode_prompts(cfg, forward_lengths(spec))
        with torch.inference_mode(), use_rules(None):
            one["forward"] = forward(model, {"tokens": torch.from_numpy(
                tokens).to(dev)})[0][..., :cfg.vocab_size].cpu()
    one.update(_prefill_then_decode(model, model, cfg, dev,
                                    low["fed"] if low else None, None,
                                    None, spec["lengths"], spec["steps"]))
    restore_shape_sets(saved)
    floor = None
    if low is not None:
        floor = max(float((a[..., :cfg.vocab_size]
                           - b[..., :cfg.vocab_size]).abs().max())
                    for a, b in zip([low["prefill"]] + low["decode"],
                                    [one["prefill"]] + one["decode"]))
    del model
    _release()
    with tempfile.TemporaryDirectory() as root:
        wall, ranks = _spawn(par_decode_rank, PAR_RANKS, root, spec,
                             one["fed"], dev.type)
        got = torch.load(f"{root}/logits.pt")
    pairs = [(got["prefill"], one["prefill"])] + list(zip(got["decode"],
                                                          one["decode"]))
    if spec.get("forward"):
        pairs.append((got["forward"], one["forward"]))
    worst, disagree, held_rows = 0.0, 0, 0
    for g, w in pairs:
        g, w = g[..., :cfg.vocab_size], w[..., :cfg.vocab_size]
        worst = max(worst, float((g - w).abs().max()))
        top2 = w.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > TP_MARGIN
        held_rows += int(sure.sum())
        disagree += int((g.argmax(-1) != w.argmax(-1))[sure].sum())
    held = {"logit_max_abs_diff": worst, "argmax_held_rows": held_rows,
            "argmax_disagree": disagree}
    if spec.get("forward"):
        held["forward_max_abs_diff"] = float(
            (got["forward"] - one["forward"]).abs().max())
    if floor is not None:
        held[f"{spec['build_dtype']}_one_rank_max_abs_diff"] = floor
    attn = attention_layers(cfg)
    moe = moe_layers(cfg)
    calls = 1 + (1 if spec.get("forward") else 0)
    forward_note = (f"one forward of prompts {list(forward_lengths(spec))} "
                    f"under {json.dumps(ranks[0]['rules'][2])}, "
                    if spec.get("forward") else "")
    want = {"flash_attention": attn * calls, "flash_attention_bwd": 0,
            "decode_attention": attn * spec["steps"],
            "partition_histogram": 0,
            "partition_scatter": moe * (calls + spec["steps"]),
            "fused_probe": 0}
    for r in ranks:
        require(r["launches"] == want, f"{prefix} rank {r['rank']}: "
                f"launches {r['launches']}, expected {want}")
        if attn:
            require(r["shapes"]["decode_attention"] and all(
                sh[-1] == "lse" for sh in r["shapes"]["decode_attention"]),
                f"{prefix} rank {r['rank']}: K5 without its log-sum-exp")
    print(f"{prefix} {spec['arch']} ({cfg.num_layers} of "
          f"{serve_config(spec['arch']).num_layers} layers at full width, "
          f"{spec['dtype']}, drop-free capacity E / top_k; {len(ranks)} "
          f"ranks on one card, gloo, {wall:.2f} s): prompts "
          f"{list(spec['lengths'])} padded to {max(spec['lengths'])}, "
          f"{forward_note}prefilled under "
          f"{json.dumps(ranks[0]['rules'][0])}, then "
          f"{spec['steps']} decode steps under "
          f"{json.dumps(ranks[0]['rules'][1])}; one rank's prefill "
          f"{one['prefill_ms']:.2f} ms, decode ms a step median "
          f"{np.median(one['step_ms']):.2f} [{card}]")
    for r in ranks:
        coll = {k: {"calls": v["calls"], "bytes": v["bytes"],
                    "ms": round(v["seconds"] * 1e3, 2)}
                for k, v in r["collectives"].items()}
        extra = f"forward {r['forward_ms']:.2f} ms, " \
            if "forward_ms" in r else ""
        print(f"{prefix} rank {r['rank']}: {extra}prefill "
              f"{r['prefill_ms']:.2f} ms, decode ms a step median "
              f"{np.median(r['step_ms']):.2f} (all "
              f"{[round(x, 2) for x in r['step_ms']]}), peak "
              f"max_memory_allocated {r['peak_bytes']} B, collectives "
              f"{json.dumps(coll)}, launches {r['launches']} [{card}]")
    print(f"{prefix}: held {json.dumps(held)} (every logit within "
          f"{LOGIT_TOL} of one rank's, the argmax equal where one rank's "
          f"top two lie more than {TP_MARGIN} apart; the "
          f"{spec['build_dtype']} one-rank run's distance from the "
          f"{spec['dtype']} one, where they differ, is printed, not held: "
          f"the rounding floor) [{card}]")
    require(worst <= LOGIT_TOL, f"{prefix} logits {worst} off one rank's")
    require(held.get("forward_max_abs_diff", 0.0) <= LOGIT_TOL,
            f"{prefix} forward logits {held.get('forward_max_abs_diff')} "
            f"off one rank's")
    require(disagree == 0, f"{prefix}: {disagree} argmax differ")
    require(held_rows > 0, f"{prefix}: no row's top two logits lie apart")
    launches, shapes = {}, {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in r["shapes"].items():
            shapes.setdefault(k, set()).update(map(tuple, v))
    return {"wall_s": wall, "held": held, "launches": launches,
            "shapes": shapes}


def parallel_phases(dev, card: str, seconds: dict) -> dict:
    """``ep_train_granite_moe_1b_a400m``, ``ep_decode_moonshot_v1_16b_a3b``,
    ``inner_tp_jamba_v0_1_52b`` and ``inner_tp_train_xlstm_1_3b`` in turn,
    each timed into ``seconds``."""
    phases = {
        "ep_train_granite_moe_1b_a400m": lambda: par_train_phase(
            dev, card, "ep_train", MOE_ARCH, EP_TRAIN_LAYERS,
            EP_TRAIN_VARIANTS,
            drops=True),
        "ep_decode_moonshot_v1_16b_a3b": lambda: par_decode_phase(
            dev, card, "ep_decode", EP_DECODE),
        "inner_tp_jamba_v0_1_52b": lambda: par_decode_phase(
            dev, card, "inner_tp_jamba", INNER_JAMBA),
        "inner_tp_train_xlstm_1_3b": lambda: par_train_phase(
            dev, card, "inner_tp_train", XLSTM_ARCH, XLSTM_TRAIN_LAYERS,
            XLSTM_TRAIN_VARIANTS, dtype=XLSTM_TRAIN_DTYPE)}
    out = {}
    for name, fn in phases.items():
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.2f} s")
    return out


def offset_kernel_times(dev, gen, card: str) -> None:
    """K4 and K4b on a rank's half of the queries at its offset against the
    whole sequence's keys (the ``seq_tp`` training shape), and K5 with its
    log-sum-exp on a rank's half of the cache (the ``decode_kv_shard``
    shape), each timed beside the default call at the same shape, and
    SDPA at the offset shape (``causal_lower_right``), forward and its
    backward alone: call ms (median of 20) and device ms."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import attention as A, ref
    b, s, h, kh, hd, dt = TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128, \
        "torch.bfloat16"
    half = s // 2
    q = _randn(gen, (b, s, h, hd), dt, dev)
    k, v, d_out = (_randn(gen, (b, s, kh, hd), dt, dev),
                   _randn(gen, (b, s, kh, hd), dt, dev),
                   _randn(gen, (b, s, h, hd), dt, dev))
    calls = {"K4 whole (S=1024)": lambda: A.flash_attention(q, k, v),
             "K4 q rows 512-1023 at offset 512": lambda: A.flash_attention(
                 q[:, half:], k, v, q_offset=half),
             "K4 q rows 0-511 at offset 0": lambda: A.flash_attention(
                 q[:, :half], k, v)}
    out, lse = A.flash_attention_with_lse(q, k, v)
    out2, lse2 = A.flash_attention_with_lse(q[:, half:], k, v, True, half)
    go2 = d_out[:, half:].contiguous()
    calls["K4b whole (S=1024)"] = lambda: A.flash_attention_bwd(
        q, k, v, out, d_out, True, lse)
    calls["K4b q rows 512-1023 at offset 512"] = \
        lambda: A.flash_attention_bwd(q[:, half:], k, v, out2, go2, True,
                                      lse2, half)
    qd = _randn(gen, (b, h, hd), dt, dev)
    kc, vc = (_randn(gen, (b, TP_MAX_SEQ // 2, kh, hd), dt, dev)
              for _ in range(2))
    length = torch.tensor([64, 200, 320, 512], dtype=torch.int32,
                          device=dev)
    calls["K5 (S=512)"] = lambda: A.decode_attention(qd, kc, vc, length)
    calls["K5 with lse (S=512)"] = lambda: A.decode_attention(
        qd, kc, vc, length, return_lse=True)
    # the library's call at the offset shape: SDPA with the lower-right
    # causal mask (queries at the keys' end), K and V repeated to the query
    # heads outside the window; its backward alone, its forward outside
    rep = h // kh
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (
        q[:, half:], k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    mask = causal_lower_right(s - half, s)
    calls["SDPA causal_lower_right q rows 512-1023"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    gog = go2.transpose(1, 2).contiguous()
    calls["SDPA causal_lower_right backward alone q rows 512-1023"] = \
        lambda: torch.autograd.grad(og, (qg, kg, vg), gog, retain_graph=True)
    err = float((A.flash_attention(q[:, half:], k, v, q_offset=half).float()
                 - ref.flash_attention_ref(q[:, half:], k, v, True,
                                           half).float()).abs().max())
    sdpa_err = float((F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask).transpose(1, 2).float()
        - ref.flash_attention_ref(q[:, half:], k, v, True,
                                  half).float()).abs().max())
    saved = shape_sets()
    times = {name: {"ms": median_ms(fn), "device_ms": device_ms(fn)}
             for name, fn in calls.items()}
    restore_shape_sets(saved)
    print(f"kernel offset and lse calls (B={b} H={h} K={kh} hd={hd} {dt}, "
          f"causal; K5 lengths {length.tolist()}): {json.dumps(times)}; K4 at "
          f"offset 512 max |err| {err:.4g} against its plain version, "
          f"SDPA's {sdpa_err:.4g} [{card}]")


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
    started = time.perf_counter()
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
    # the offset and lse calls timed here, before the phases that spawn
    # ranks on the card: after them the profiler's traces came back empty
    # on most tries
    offset_kernel_times(dev, gen, card)

    # checkpoint and restart, and the training CLI: after the train phases
    t0 = time.perf_counter()
    ckpt = ckpt_phase(dev, card)
    seconds["ckpt_train_llama3_2_3b"] = time.perf_counter() - t0
    print(f"phase ckpt_train_llama3_2_3b: "
          f"{seconds['ckpt_train_llama3_2_3b']:.2f} s")

    # the planner, a planned train step and data parallelism: after the
    # train phases, before the recurrent ones
    t0 = time.perf_counter()
    plan_cells(card)
    seconds["plan_cells"] = time.perf_counter() - t0
    print(f"phase plan_cells: {seconds['plan_cells']:.2f} s")
    t0 = time.perf_counter()
    planned = plan_train_phase(dev, card)
    seconds["plan_train_llama3_2_3b"] = time.perf_counter() - t0
    print(f"phase plan_train_llama3_2_3b: "
          f"{seconds['plan_train_llama3_2_3b']:.2f} s")
    t0 = time.perf_counter()
    dp = dp_phase(dev, card)
    seconds["dp_granite_moe_1b_a400m"] = time.perf_counter() - t0
    print(f"phase dp_granite_moe_1b_a400m: "
          f"{seconds['dp_granite_moe_1b_a400m']:.2f} s")
    # tensor, sequence and ZeRO-3 parallelism: two ranks sharing the card
    # (four for the pipeline with those splits inside its stages), each
    # phase held against one rank
    tp_phases = {}
    for name, fn in (("tp_train_llama3_2_3b", tp_train_phase),
                     ("tp_decode_llama3_2_3b", tp_decode_phase),
                     ("zero3_train_llama3_2_3b", zero3_train_phase),
                     ("pp_tp_train_llama3_2_3b", pp_tp_train_phase)):
        t0 = time.perf_counter()
        tp_phases[name] = fn(dev, card)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.2f} s")
    t0 = time.perf_counter()
    dryrun_phase(planned, tp_phases["tp_train_llama3_2_3b"],
                 tp_phases["pp_tp_train_llama3_2_3b"], card)
    seconds["dryrun_plan_train_llama3_2_3b"] = time.perf_counter() - t0
    print(f"phase dryrun_plan_train_llama3_2_3b: "
          f"{seconds['dryrun_plan_train_llama3_2_3b']:.2f} s")
    # each kernel held at the shapes these phases launched it at first
    held = {k: set(v) for k, v in attn_shapes.items()}
    for k in train_shapes:
        held[k] |= train_shapes[k]
    new = {k: set().union(dp["shapes"].get(k, set()),
                          planned["shapes"].get(k, set()),
                          ckpt["shapes"].get(k, set()),
                          *(ph["shapes"].get(k, set())
                            for ph in tp_phases.values()))
           - held.get(k, set()) for k in shape_sets()}
    print(f"main-path kernel shapes of the checkpoint, planned, data-"
          f"parallel, tensor-parallel and ZeRO-3 phases: "
          f"{ {k: sorted(v) for k, v in new.items()} }")
    new_err = hold_late_shapes(dev, gen, new)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"], new_err[r["name"]])

    # jamba at full width, one period of its pattern (Mamba, attention, MoE
    # on K2), then xlstm (mLSTM and sLSTM), then the stub frontends: after
    # everything above, which runs as it did before these existed; each
    # model freed at its phase's end. Their profiles come first, on the
    # weights made from seed 0 once more, and leave no shape behind
    # (``recurrent_profiles``): every profiler trace taken after these
    # phases came back empty on an H100
    import dataclasses
    recurrent_cfgs = {}
    for arch, cut in ((HYBRID_ARCH, HYBRID_LAYERS),
                      (XLSTM_ARCH, XLSTM_SERVE_LAYERS)):
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

    # expert parallelism and the Mamba / xLSTM inner split: two ranks
    # sharing the card, each phase held against one rank; last, after
    # every profile
    par = parallel_phases(dev, card, seconds)
    seen = shape_sets()
    for k in seen:
        seen[k] |= new.get(k, set())
    par_new = {k: set().union(*(ph["shapes"].get(k, set())
                                for ph in par.values())) - seen[k]
               for k in seen}
    print(f"main-path kernel shapes of the expert-parallel and inner-split "
          f"phases: { {k: sorted(v) for k, v in par_new.items()} }")
    par_err = hold_late_shapes(dev, gen, par_new)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"], par_err[r["name"]])

    # the main path's launches: the queries, the simulator's planning, the
    # process workers', the scheduler's, the serve phases and the frontends
    # (the teacher-forced checks' own are on their lines above)
    counted = [res["launches"] for res in phases] + [
        sim["launches"], proc["worker_launches"]] + [
        r["launches"] for r in mix["policies"].values()] + [
        serve["launches"], granite["launches"], fronts["launches"]] + [
        r["launches"] for r in recurrent.values()] + [
        t["launches"] for t in train.values()] + [
        ckpt["launches"], planned["launches"], dp["launches"]] + [
        ph["launches"] for ph in tp_phases.values()] + [
        ph["launches"] for ph in par.values()]
    for r in rows:
        r["launches"] = sum(c.get(r["name"], 0) for c in counted)
        for extra in ("shape", "device", "device_ops_per_call", "checked_ms",
                      "second"):
            r.pop(extra, None)
    print(json.dumps({"kernels": rows}))
    print(f"phase seconds: {json.dumps(seconds)}")
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from the "
          f"build's start to this line")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
