"""GPipe pipeline parallelism over the ``pod`` mesh axis (the port of
``repro/parallel/pipeline.py``).

The *packing* schedule decision (paper Fig. 4e) applied to pods: instead of
stretching data parallelism across the slow cross-pod links (a gradient
all-reduce of the full model every step), each pod owns a contiguous slice
of the layer stack and only microbatch activations cross pods.

Stage ``s`` of ``S`` runs layers ``[s R/S, (s+1) R/S)`` of the ``R``
repeats (the reference's rows of the stacked blocks). The embedding, the
final norm and the loss run on every rank, outside the stages, as the
reference runs them outside its manual region. The schedule is the static
GPipe grid: tick ``t`` runs microbatch ``t - s`` on stage ``s``; after
every tick but the last, ``_Shift`` sends each stage's output to the next
stage with ``batch_isend_irecv``, and its backward sends the gradient
back (the reference's transposed ``ppermute``). Every tick's input is the
previous tick's ``_Shift`` output on every stage (stage 0 and idle ticks
pass a zero gradient to it), so each rank's graph is one chain and every
rank runs the ``_Shift`` backwards in the same order. An idle tick runs
``h_recv * 0``, which makes no collective. The last stage's outputs reach
every rank through one fp32 sum over ``pod`` (the reference's ``psum`` of
``out_acc``).

Inside a pod the rules' other splits run as the tensor-parallel train step
runs them (the reference's pipeline is manual over ``pod`` only and leaves
``data`` and ``model`` to GSPMD, so "the per-stage layer stack keeps its
TP/FSDP shardings"): every rank computes under the rules'
``parallel.tensor.TensorPlan`` (the batch over ``data``; ``seq`` with
``mlp_seq`` or ``mlp``, ``vocab``, ``heads`` and ``kv_heads`` over
``model``; ``w_embed`` over ``data``, ZeRO-3), holds its shards of its
stage's layers and of the replicated leaves (``convert.shard_params``)
and their AdamW state. ``_Shift`` sends a rank's shard of the residual
(under a sequence split, its block of the sequence) to the rank with the
same ``(data, model)`` coordinate in the next stage, and the sum over
``pod`` of the last stage's outputs is taken shard by shard. The
collectives of a stage's layers run on the ticks the stage is active, in
the same order on every rank of its pod.

Gradients: the loss path's (final norm, unembedding) are the same on every
stage; the input path's gradient to the embedding exists only on stage 0,
so its gradient with respect to the embeddings is summed over ``pod``
before it reaches the table, and every stage's replicated leaves stay
equal. Each leaf's gradient is then summed over
``TensorPlan.grad_sync_axes`` within the pod (ZeRO-3 leaves come
reduce-scattered from their gathers' backward). The clip norm is the whole
tree's: the stage's layers' squares summed within the pod and over
``pod``, the replicated leaves' counted once.

An MoE layer runs in the port's pipeline with its experts whole (the
stage's ranks each run every expert), and its aux loss is left out of the
pipeline's loss. The reference's pipeline runs no MoE layer at all: its
stage body calls ``_apply_block`` with ``is_moe=False``
(``repro/parallel/pipeline.py:80``), so ``repro/models/lm.py:169-174``
hands the experts' 3-D weights to the dense MLP, and the einsum raises
(ROADMAP Queue 3, "Kept on purpose").

Scope: uniform-attention archs (block pattern period 1) in train mode,
repeats divisible by the stage count, microbatches >= stages; an MoE
layer's experts are not split under the pipeline (``require_executable``:
the reference runs no MoE layer there).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import (
    BlockKind,
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import embed, residual_from_partial, rmsnorm
from repro_torch.parallel.collectives import (
    all_reduce_,
    exchange,
    flat_all_reduce_,
    replicated_sum,
)
from repro_torch.parallel.sharding import ShardingRules, require_executable
from repro_torch.parallel.tensor import TensorPlan
from repro_torch.training.losses import (
    chunked_cross_entropy,
    vocab_input,
    vocab_labels,
)
from repro_torch.training.optimizer import apply_updates, init_opt_state
from repro_torch.training.train_step import (
    _on_device,
    leaf_axes,
    sharded_square_sum,
)


def _repeats(cfg: ModelConfig) -> int:
    period = len(cfg.block_pattern)
    assert cfg.num_layers % period == 0, (cfg.num_layers, period)
    return cfg.num_layers // period


def pp_applicable(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  pc: ParallelConfig) -> bool:
    if "pod" not in getattr(mesh, "shape", {}):
        return False
    stages = int(mesh.shape["pod"])
    return (shape.mode == "train"
            and all(BlockKind(k) == BlockKind.ATTENTION
                    for k in cfg.block_pattern)
            and _repeats(cfg) % stages == 0
            and max(1, pc.microbatches) >= stages)


def pp_rules(rules: ShardingRules) -> ShardingRules:
    """Variant rule set: layer stacks sharded over pod (weights stay
    pod-local); batch stays on data only."""
    new = dict(rules.rules)
    new["layers"] = "pod"
    new["batch"] = "data"
    return ShardingRules(rules.mesh, new)


def stage_layers(cfg: ModelConfig, stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``stages`` runs."""
    per = _repeats(cfg) // stages
    return range(stage * per, (stage + 1) * per)


class _OtherStage(nn.Module):
    """The place of a layer that another stage holds and runs."""


def init_pp_train_state(cfg: ModelConfig, model, mesh) -> dict:
    """``{"params": model, "opt": ...}`` for this rank's stage: ``model``
    (this rank's shards, ``convert.shard_params``, or the whole model where
    the rules split nothing inside a pod) keeps its stage's layers and the
    replicated leaves, with gradients on and their AdamW state; the other
    stages' layers are dropped from it (``_OtherStage``)."""
    mine = stage_layers(cfg, int(mesh.shape["pod"]),
                        mesh.coordinate()["pod"])
    for i in range(len(model.layers)):
        if i not in mine:
            model.layers[i] = _OtherStage()
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(named)}


class _Shift(torch.autograd.Function):
    """One pipeline tick's hand-over: send ``h`` to stage ``s + 1`` and
    return what stage ``s - 1`` sent (zeros on stage 0); the backward sends
    the returned tensor's gradient to ``s - 1`` and returns what ``s + 1``
    sent back (zeros on the last stage)."""

    @staticmethod
    def forward(ctx, h, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        recv = torch.zeros_like(h)
        exchange(h.detach() if nxt is not None else None, nxt,
                 recv if prev is not None else None, prev, group)
        return recv

    @staticmethod
    def backward(ctx, grad):
        back = torch.zeros_like(grad)
        exchange(grad if ctx.prev is not None else None, ctx.prev,
                 back if ctx.nxt is not None else None, ctx.nxt, ctx.group)
        return back, None, None, None


def make_pp_train_step(cfg: ModelConfig, shape: ShapeConfig,
                       opt_cfg: OptimizerConfig, pc: ParallelConfig,
                       rules: ShardingRules, total_steps: int = 10000,
                       q_chunk: int = 1024, ssm_chunk: int = 128):
    """Returns ``train_step(state, batch)`` (``state`` from
    ``init_pp_train_state``) for ``rules`` from ``pp_rules``. Every rank
    receives the same global batch; ``pc.microbatches`` (at least the
    stage count) slices of it go through the stages, each split over the
    batch axes in contiguous blocks."""
    require_executable(rules, pipeline=True, cfg=cfg)
    mesh = rules.mesh
    assert pp_applicable(cfg, shape, mesh, pc)
    stages = int(mesh.shape["pod"])
    coord = mesh.coordinate()
    stage = coord["pod"]
    mb = max(stages, pc.microbatches)
    pod = mesh.group("pod")
    plan = TensorPlan(rules)
    axes_of = leaf_axes(cfg)

    def neighbour(offset: int) -> int | None:
        s = stage + offset
        if not 0 <= s < stages:
            return None
        return int(mesh.devices[tuple({**coord, "pod": s}[a]
                                      for a in mesh.axis_names)])

    prev, nxt = neighbour(-1), neighbour(1)
    mine = stage_layers(cfg, stages, stage)

    def stage_apply(model, h, positions):
        for i in mine:
            if pc.remat == "none":
                h, _ = lm_mod._layer(model.layers[i], h, positions, cfg,
                                     ssm_chunk, plan)
            else:
                h, _ = checkpoint(lm_mod._layer, model.layers[i], h,
                                  positions, cfg, ssm_chunk, plan,
                                  use_reentrant=False,
                                  **lm_mod._REMAT[pc.remat])
        return h

    def embedded(model, tokens_mb):
        """``tokens_mb (M, b, S)`` -> ``(M, b, s, D)``, this rank's shard
        of the embedded microbatches as the residual stream (``s`` its
        block of the sequence under a sequence split)."""
        m_, b = tokens_mb.shape[:2]
        h = embed(model.embed, tokens_mb.flatten(0, 1), plan)
        return residual_from_partial(h, plan).unflatten(0, (m_, b))

    def pp_loss(model, h0, labels, total_count, h_recv):
        """``h0 (M, b, s, D)`` embedded microbatches, ``labels (M, b, S)``,
        ``h_recv`` the chain's zero start (a leaf asking for a gradient, so
        that the gradient of the loss with respect to it runs every
        ``_Shift`` backward): this rank's share of the cross-entropy of the
        whole batch."""
        m_, b, s, d = h0.shape
        positions = plan.local_positions(
            lm_mod._positions(b, labels.shape[-1], h0.device))
        first = torch.tensor(stage == 0, device=h0.device)
        outs = [torch.zeros((b, s, d), dtype=torch.float32,
                            device=h0.device) for _ in range(m_)]
        ticks = m_ + stages - 1
        for t in range(ticks):
            m = t - stage
            active = 0 <= m < m_
            if active:
                x_in = torch.where(first, h0[m], h_recv)
                h_out = stage_apply(model, x_in, positions)
            else:
                h_out = h_recv * 0           # idle: keeps the chain
            if t >= stages - 1:
                k = min(max(m, 0), m_ - 1)
                take = torch.tensor(stage == stages - 1 and active,
                                    device=h0.device)
                outs[k] = torch.where(take, h_out.float(), outs[k])
            if t < ticks - 1:
                h_recv = _Shift.apply(h_out, prev, nxt, pod)
        # only the last stage wrote its outputs: one fp32 sum over pod;
        # then the loss of every microbatch in one call (the reference
        # vmaps it), so a ZeRO-3 table is gathered once
        h_final = replicated_sum(torch.stack(outs), pod).flatten(0, 1)
        h_last = rmsnorm(model.final_norm, h_final.to(h0.dtype),
                         cfg.norm_eps)
        total, _ = chunked_cross_entropy(
            model.embed, vocab_input(h_last, plan),
            vocab_labels(labels.flatten(0, 1), plan), cfg,
            total_count=total_count, plan=plan)
        return total

    def grad_step(model, batch: dict):
        """``(loss, grads, norm)``: the loss, the fp32 gradients of this
        rank's shards of the model's parameters (its stage's and the
        replicated ones) after the sums within the pod, and the whole
        tree's gradient norm."""
        named = dict(model.named_parameters())
        names = list(named)
        batch = _on_device(batch, next(iter(named.values())).device)
        tokens, labels = batch["tokens"], batch["labels"]
        rows, dp = tokens.shape[0], plan.batch.n
        if rows % (mb * dp):
            raise ValueError(f"{mb} microbatches over {dp} batch ranks do "
                             f"not divide a batch of {rows} rows")
        n = rows // mb
        split = [t.reshape(mb, n, *t.shape[1:]) for t in (tokens, labels)]
        total_count = (split[1] >= 0).sum().float()
        lo = plan.batch.index * (n // dp)
        tokens_mb, labels_mb = (t[:, lo:lo + n // dp] for t in split)

        # the input path stops at h0: its gradient is summed over pod
        # before it reaches the table
        h_in = embedded(model, tokens_mb)
        h0 = h_in.detach().requires_grad_(True)
        start = torch.zeros_like(h0[0], requires_grad=True)
        loss = pp_loss(model, h0, labels_mb, total_count, start)
        got = torch.autograd.grad(
            loss, [named[k] for k in names] + [h0, start], allow_unused=True)
        got = got[:-1]
        dh0 = all_reduce_(torch.zeros_like(h0) if got[-1] is None
                          else got[-1].contiguous(), pod)
        (d_table,) = torch.autograd.grad(h_in, [model.embed.table], dh0)
        grads = {k: torch.zeros_like(named[k], dtype=torch.float32)
                 if g is None else g.float() for k, g in zip(names, got)}
        grads["embed.table"] = grads["embed.table"] + d_table.float()
        loss = loss.detach()
        if plan.batch:
            loss = all_reduce_(loss.reshape(1), plan.batch.group)[0]
        buckets: dict[tuple, list] = {}
        for k, g in grads.items():
            axes = plan.grad_sync_axes(axes_of[k])
            if axes:
                buckets.setdefault(axes, []).append(g)
        for axes, tensors in buckets.items():
            flat_all_reduce_(tensors, mesh.group(axes))
        # the whole tree's norm: the stage's layers' squares summed over
        # pod, the replicated leaves' counted once
        own = {k: g for k, g in grads.items() if k.startswith("layers.")}
        shared = {k: g for k, g in grads.items()
                  if not k.startswith("layers.")}
        sq = sharded_square_sum(own, axes_of, plan).reshape(1).clone()
        all_reduce_(sq, pod)
        return loss, grads, (sq[0] + sharded_square_sum(
            shared, axes_of, plan)).sqrt()

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        loss, grads, gnorm = grad_step(model, batch)
        _, opt, opt_metrics = apply_updates(
            dict(model.named_parameters()), grads, state["opt"], opt_cfg,
            total_steps, gnorm=gnorm)
        metrics = dict(opt_metrics)
        metrics["loss"] = loss
        return {"params": model, "opt": opt}, metrics

    train_step.grad_step = grad_step    # for tests and gradient probes
    return train_step
