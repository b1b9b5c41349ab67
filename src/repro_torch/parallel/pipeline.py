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
rank runs the ``_Shift`` backwards in the same order. The last stage's
outputs reach every rank through one fp32 sum over ``pod`` (the
reference's ``psum`` of ``out_acc``).

Gradients: the loss path's (final norm, unembedding) are the same on every
rank; the input path's gradient to the embedding exists only on stage 0,
so its gradient with respect to the embeddings is summed over ``pod``
before it reaches the table, and every rank's replicated leaves stay
equal. Under ``pp_rules`` the batch may also be split over ``data``: then
every gradient is summed over ``data`` as in the data-parallel step. As in
the reference, the MoE aux loss is not part of the pipeline's loss.

Scope: uniform-attention archs (block pattern period 1) in train mode,
repeats divisible by the stage count, microbatches >= stages.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import (
    BlockKind,
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import embed, rmsnorm
from repro_torch.parallel.collectives import (
    all_reduce_,
    exchange,
    flat_all_reduce_,
    replicated_sum,
)
from repro_torch.parallel.sharding import ShardingRules, require_executable
from repro_torch.training.losses import chunked_cross_entropy
from repro_torch.training.optimizer import (
    apply_updates,
    global_norm,
    init_opt_state,
)
from repro_torch.training.train_step import _on_device


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


def stage_param_names(model, cfg: ModelConfig, stages: int,
                      stage: int) -> list[str]:
    """The parameters a stage updates: its layers' and the replicated
    ones (embedding, final norm)."""
    mine = {f"layers.{i}." for i in stage_layers(cfg, stages, stage)}
    return [k for k, _ in model.named_parameters()
            if not k.startswith("layers.")
            or any(k.startswith(p) for p in mine)]


def init_pp_train_state(cfg: ModelConfig, model, mesh) -> dict:
    """``{"params": model, "opt": ...}`` with gradients on and the AdamW
    state of this rank's stage's parameters only."""
    stages, stage = int(mesh.shape["pod"]), mesh.coordinate()["pod"]
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    names = stage_param_names(model, cfg, stages, stage)
    return {"params": model,
            "opt": init_opt_state({k: named[k] for k in names})}


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
    stage count) slices of it go through the stages."""
    require_executable(rules, pipeline=True)
    mesh = rules.mesh
    assert pp_applicable(cfg, shape, mesh, pc)
    stages = int(mesh.shape["pod"])
    coord = mesh.coordinate()
    stage = coord["pod"]
    mb = max(stages, pc.microbatches)
    pod = mesh.group("pod")
    batch_axes = rules.rules.get("batch")
    dp = rules.axis_size("batch")
    data = mesh.group(batch_axes) if dp > 1 else None
    data_index = mesh.axes_index(batch_axes) if dp > 1 else 0

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
                                     ssm_chunk)
            else:
                h, _ = checkpoint(lm_mod._layer, model.layers[i], h,
                                  positions, cfg, ssm_chunk,
                                  use_reentrant=False,
                                  **lm_mod._REMAT[pc.remat])
        return h

    def pp_loss(model, h0, labels, total_count, h_recv):
        """``h0 (M, b, s, d)`` embedded microbatches, ``labels (M, b, s)``,
        ``h_recv`` the chain's zero start (a leaf asking for a gradient, so
        that the gradient of the loss with respect to it runs every
        ``_Shift`` backward): this rank's share of the cross-entropy of the
        whole batch."""
        m_, b, s, d = h0.shape
        positions = lm_mod._positions(b, s, h0.device)
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
        # only the last stage wrote its outputs: one fp32 sum over pod
        h_final = replicated_sum(torch.stack(outs), pod)
        total = h0.new_zeros((), dtype=torch.float32)
        for i in range(m_):
            h_last = rmsnorm(model.final_norm, h_final[i].to(h0.dtype),
                             cfg.norm_eps)
            share, _ = chunked_cross_entropy(model.embed, h_last, labels[i],
                                             cfg, total_count=total_count)
            total = total + share
        return total

    def grad_step(model, batch: dict, names: list[str]):
        """``(loss, grads, norm)``: the loss, the fp32 gradients of the
        parameters ``names`` (this stage's and the replicated ones, as
        every rank of the stage's ``data`` slice holds them after the
        all-reduce) and the whole tree's gradient norm."""
        named = dict(model.named_parameters())
        batch = _on_device(batch, next(iter(named.values())).device)
        tokens, labels = batch["tokens"], batch["labels"]
        rows = tokens.shape[0]
        if rows % (mb * dp):
            raise ValueError(f"{mb} microbatches over {dp} batch ranks do "
                             f"not divide a batch of {rows} rows")
        n = rows // mb
        split = [t.reshape(mb, n, *t.shape[1:]) for t in (tokens, labels)]
        total_count = (split[1] >= 0).sum().float()
        lo = data_index * (n // dp)
        tokens_mb, labels_mb = (t[:, lo:lo + n // dp] for t in split)

        # the input path stops at h0: its gradient is summed over pod
        # before it reaches the table
        with torch.no_grad():
            h0 = embed(model.embed, tokens_mb)
        h0.requires_grad_(True)
        start = torch.zeros_like(h0[0], requires_grad=True)
        loss = pp_loss(model, h0, labels_mb, total_count, start)
        got = torch.autograd.grad(
            loss, [named[k] for k in names] + [h0, start], allow_unused=True)
        got = got[:-1]
        dh0 = all_reduce_(torch.zeros_like(h0) if got[-1] is None
                          else got[-1].contiguous(), pod)
        emb = embed(model.embed, tokens_mb)
        (d_table,) = torch.autograd.grad(emb, [model.embed.table], dh0)
        grads = {k: torch.zeros_like(named[k], dtype=torch.float32)
                 if g is None else g.float() for k, g in zip(names, got)}
        grads["embed.table"] = grads["embed.table"] + d_table.float()
        loss = loss.detach()
        if data is not None:
            loss = all_reduce_(loss.reshape(1), data)[0]
            flat_all_reduce_(list(grads.values()), data)
        # the whole tree's norm: the stage's layers' squares summed over pod
        own = [g for k, g in grads.items() if k.startswith("layers.")]
        shared = [g for k, g in grads.items() if not k.startswith("layers.")]
        sq = torch.stack([global_norm(dict(enumerate(own))).square(),
                          global_norm(dict(enumerate(shared))).square()])
        all_reduce_(sq[:1], pod)
        return loss, grads, sq.sum().sqrt()

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        named = dict(model.named_parameters())
        names = list(state["opt"]["master"])
        loss, grads, gnorm = grad_step(model, batch, names)
        _, opt, opt_metrics = apply_updates(
            {k: named[k] for k in names}, grads, state["opt"], opt_cfg,
            total_steps, gnorm=gnorm)
        metrics = dict(opt_metrics)
        metrics["loss"] = loss
        return {"params": model, "opt": opt}, metrics

    train_step.grad_step = grad_step    # for tests and gradient probes
    return train_step
