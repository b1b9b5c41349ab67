"""Train-step builder: microbatch gradient accumulation, remat and AdamW
(the port of ``repro/training/train_step.py``).

``make_train_step(cfg, shape, opt_cfg, pc)`` returns
``train_step(state, batch) -> (state, metrics)``, where ``state`` is
``{"params": the LM, "opt": the optimizer state}`` (``init_train_state``)
and ``batch`` holds numpy arrays or tensors (moved to the model's device).
The step updates the model's parameters in place. Gradients come from
``torch.autograd.grad``, never through ``.grad``: with ``pc.microbatches``
above 1 the global batch is split into that many slices run in turn, and
their gradients are summed into fp32 accumulators divided by the count,
as the reference sums them (``.grad`` would accumulate in the parameters'
bf16). Under sharding rules that split the batch over ranks the step is
data-parallel; under rules that split more (tensor, sequence, expert and
inner parallelism and ZeRO-3) each rank holds its shards of the
parameters and of the optimizer state (``make_train_step``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.config import (
    Frontend,
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.models.lm import LM, forward_hidden, plan_for
from repro_torch.parallel.collectives import (
    all_reduce_,
    flat_all_reduce_,
    gather_dim,
    reduce_scatter_dim,
)
from repro_torch.parallel.sharding import (
    ShardingRules,
    current_rules,
    require_executable,
    use_rules,
)
from repro_torch.parallel.tensor import TensorPlan, tensor_plan
from repro_torch.training.losses import (
    chunked_cross_entropy,
    vocab_input,
    vocab_labels,
    whole_sequence,
)
from repro_torch.training.optimizer import apply_updates, init_opt_state

AUX_LOSS_WEIGHT = 0.01


def init_train_state(cfg: ModelConfig, model: LM) -> dict:
    """Turn every parameter's gradient on (modules are built frozen) and
    make the optimizer state: ``{"params": model, "opt": ...}``."""
    for p in model.parameters():
        p.requires_grad_(True)
    return {"params": model,
            "opt": init_opt_state(dict(model.named_parameters()))}


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def _loss_fn(model: LM, batch: dict, cfg: ModelConfig, pc: ParallelConfig,
             q_chunk: int, ssm_chunk: int, total_count=None, plan=None):
    """``(loss, {"ce", "aux", "tokens"})``: the chunked cross-entropy over
    the text positions (after the vision stub's patches) plus the MoE aux
    loss times ``AUX_LOSS_WEIGHT``. With ``total_count`` (the tokens of the
    whole batch whose rows these are) the cross-entropy is this rank's
    share of the whole batch's mean. Under a ``TensorPlan`` the loss is
    the same on every rank of a batch block."""
    plan = plan_for(cfg, plan)
    h, aux = forward_hidden(model, batch, remat=pc.remat, q_chunk=q_chunk,
                            ssm_chunk=ssm_chunk, plan=plan)
    h = vocab_input(h, plan)
    labels = batch["labels"]
    if cfg.frontend == Frontend.VISION_STUB.value:
        # loss over text positions only: cut where the rank holds them all,
        # else the patches' positions masked
        if whole_sequence(plan):
            h = h[:, cfg.stub_patches:]
        else:
            labels = torch.cat([labels.new_full(
                (labels.shape[0], cfg.stub_patches), -1), labels], dim=1)
    ce, count = chunked_cross_entropy(model.embed, h,
                                      vocab_labels(labels, plan), cfg,
                                      total_count=total_count, plan=plan)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux, "tokens": count}


def make_grad_fn(cfg: ModelConfig, pc: ParallelConfig, q_chunk: int = 1024,
                 ssm_chunk: int = 128):
    """``grad_fn(model, batch, total_count=None) -> (loss, metrics,
    grads)``: one forward and backward over the whole ``batch``, ``grads``
    keyed by parameter name in the parameters' dtypes (``total_count`` as
    in ``_loss_fn``)."""
    def grad_fn(model: LM, batch: dict, total_count=None):
        named = dict(model.named_parameters())
        batch = _on_device(batch, next(iter(named.values())).device)
        loss, metrics = _loss_fn(model, batch, cfg, pc, q_chunk, ssm_chunk,
                                 total_count)
        grads = torch.autograd.grad(loss, list(named.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))
    return grad_fn


def _batch_split(rules: ShardingRules | None):
    """``(group, ranks, index)`` of the batch axes under ``rules``: their
    process group (``None`` unless the batch is split over more than one
    rank), how many ranks split it, and this rank's block."""
    if rules is None or rules.mesh is None or rules.axis_size("batch") == 1:
        return None, 1, 0
    axes = rules.rules["batch"]
    return (rules.mesh.group(axes), rules.axis_size("batch"),
            rules.mesh.axes_index(axes))


def _rows(batch: dict, i: int, n: int) -> dict:
    """Block ``i`` of ``n`` contiguous row blocks of every entry."""
    rows = next(iter(batch.values())).shape[0] // n
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def text_tokens(batch: dict) -> torch.Tensor:
    """The unmasked labels of ``batch``: the cross-entropy's count."""
    return (batch["labels"] >= 0).sum().float()


def _backward_into(loss: torch.Tensor, wrt: dict, acc: dict,
                   mb: int) -> None:
    """``loss.backward()``, each tensor of ``wrt``'s gradient added to
    ``acc`` of its name in fp32 over ``mb`` the moment autograd has made it,
    and then dropped: a microbatch's gradients in the parameters' dtype
    never all exist at once beside the accumulators (the planner prices
    the accumulators alone, ``Hardware.accum_bytes``)."""
    def adder(name):
        def add(t):
            acc[name].add_(t.grad.float() / mb)
            t.grad = None
        return add

    handles = []
    for name, t in wrt.items():
        t.grad = None
        handles.append(t.register_post_accumulate_grad_hook(adder(name)))
    try:
        loss.backward()
    finally:
        for h in handles:
            h.remove()


def leaf_axes(cfg: ModelConfig) -> dict:
    """Every parameter's logical axes, by the port's parameter name."""
    from repro_torch.models.convert import _meta_leaves
    return {k: a for k, (_, a) in _meta_leaves(cfg).items()}


def inner_partial_leaves(model: LM, kind: str = "INNER_PARTIAL"
                         ) -> set[str]:
    """The parameters a recurrent block's inner split leaves whole whose
    gradient each inner rank only partly computes (a module's
    ``INNER_PARTIAL``: the sLSTM's ``r_gates``), or, with ``kind=
    "INNER_WHOLE"``, those whose gradient every inner rank has whole (the
    gates' biases)."""
    return {f"{mod_name}.{leaf}" for mod_name, mod in model.named_modules()
            for leaf in getattr(type(mod), kind, ())}


def sharded_global_norm(grads: dict, axes_of: dict,
                        plan: TensorPlan) -> torch.Tensor:
    """The fp32 L2 norm of the whole gradient tree whose leaves ``grads``
    are this rank's shards: each leaf's sum of squares summed over the
    ranks that hold its other shards (one all-reduce a set of mesh axes),
    every replicated leaf counted once."""
    return sharded_square_sum(grads, axes_of, plan).sqrt()


def sharded_square_sum(grads: dict, axes_of: dict,
                       plan: TensorPlan) -> torch.Tensor:
    """The square of ``sharded_global_norm``: the fp32 sum of the squares of
    every element of the tree, on every rank alike."""
    sums: dict[tuple, torch.Tensor] = {}
    for name, g in grads.items():
        sharded = plan.leaf_axes(axes_of[name])
        key = tuple(a for a in plan.mesh.axis_names if a in sharded)
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        sums[key] = sums[key] + sq if key in sums else sq
    total = None
    for key, sq in sums.items():
        if key:
            sq = all_reduce_(sq.reshape(1).clone(), plan.mesh.group(key))[0]
        total = sq if total is None else total + sq
    return total


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    opt_cfg: OptimizerConfig, pc: ParallelConfig,
                    total_steps: int = 10000, q_chunk: int = 1024,
                    ssm_chunk: int = 128, regather=None,
                    rules: ShardingRules | None = None):
    """The step for ``pc.microbatches`` slices of each batch under
    ``pc.remat``. ``q_chunk`` is unused (K4 tiles its own queries);
    ``ssm_chunk`` is the Mamba and mLSTM chunk.

    ``rules`` (the active ``use_rules`` context's by default) may split the
    batch over mesh axes: data parallelism. Every rank then receives the
    same global batch and takes its rows as the reference's rules shard
    them: the microbatches are cut first, and each is split over the batch
    axes in contiguous blocks. Each rank's loss is its share of the
    microbatch's mean (``total_count``), the MoE aux is the whole
    microbatch's on every rank (``models.moe.moe``), and the fp32 gradients
    are summed over the batch axes by one all-reduce a bucket: every rank
    ends the step with the global loss's gradient and the same parameters
    and optimizer state.

    Rules that split more than the batch (every production cell's:
    ``tp``, ``seq_tp``, ``decode_kv_shard``, the experts' and the
    recurrent blocks' inner splits, ``pure_dp``; ``require_executable``
    refuses the rest) run on the model's shards
    (``convert.shard_params``) through the rules' ``TensorPlan``: each
    microbatch's gradients are its shards' (ZeRO-3 leaves reduce-scattered
    by their gathers' backward), summed in fp32; after the last one each
    leaf is summed over ``TensorPlan.grad_sync_axes`` (one all-reduce a
    bucket a set of axes), the clip norm is the whole tree's
    (``sharded_global_norm``) and AdamW updates the shards and their
    state. With ``pc.zero2`` and a true ``regather`` every ``w_embed``
    shard is gathered once a step, before the first microbatch, the
    microbatches' gradients of the gathered weights are summed, and each
    is reduce-scattered to its shard once (the reference's ``regather``
    gathers inside the loss of each microbatch; the sum is the same)."""
    rules = current_rules() if rules is None else rules
    require_executable(rules, cfg=cfg)
    regather = bool(regather) and pc.zero2
    mb = max(1, pc.microbatches)
    grad_fn = make_grad_fn(cfg, pc, q_chunk, ssm_chunk)
    group, dp, index = _batch_split(rules)
    axes_of = leaf_axes(cfg)

    def accumulate(model: LM, batch: dict, wrt: dict, plan):
        """The microbatches in turn: ``(loss, the last microbatch's
        metrics, fp32 gradients of ``wrt`` summed over the microbatches and
        divided by their count, this rank's share of the mean
        cross-entropy, the aux's mean, the last token count)``."""
        rows = next(iter(batch.values())).shape[0]
        if rows % (mb * dp):
            raise ValueError(f"{mb} microbatches over {dp} batch ranks do "
                             f"not divide a batch of {rows} rows")
        grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for k, t in wrt.items()}
        loss, ce_share, aux_mean, count = 0.0, 0.0, 0.0, None
        for i in range(mb):
            part = _rows(batch, i, mb)
            if dp > 1:
                count = text_tokens(part)
                part = _rows(part, index, dp)
            mb_loss, metrics = _loss_fn(model, part, cfg, pc, q_chunk,
                                        ssm_chunk, count, plan)
            _backward_into(mb_loss, wrt, grads, mb)
            metrics = {k: v.detach() for k, v in metrics.items()}
            loss = loss + mb_loss.detach() / mb
            ce_share = ce_share + metrics["ce"] / mb
            aux_mean = aux_mean + metrics["aux"] / mb
        return loss, metrics, grads, ce_share, aux_mean, count

    def shared(loss, metrics, ce_share, aux_mean, count):
        """The ranks' shares of the mean cross-entropy and of the last
        microbatch's summed over the batch axes (the aux is already every
        rank's): the whole batch's loss and metrics."""
        if dp == 1:
            return loss, metrics
        shares = torch.stack([ce_share, metrics["ce"]]).float()
        all_reduce_(shares, group)
        return (shares[0] + AUX_LOSS_WEIGHT * aux_mean,
                {"ce": shares[1], "aux": metrics["aux"], "tokens": count})

    def tp_step(model: LM, batch: dict, plan: TensorPlan):
        """``local_step`` under a ``TensorPlan``: ``(loss, metrics, fp32
        grads of this rank's shards, the clip norm)``."""
        named = dict(model.named_parameters())
        wrt, zero = dict(named), {}
        if regather:
            with torch.no_grad():
                for name, p in named.items():
                    found = plan.zero_dim_of(axes_of[name])
                    if found is None:
                        continue
                    full = gather_dim(p.detach(), found[0], found[1].group)
                    plan.gathered[id(p)] = wrt[name] = full.requires_grad_()
                    zero[name] = found
        try:
            loss, metrics, grads, ce_share, aux_mean, count = accumulate(
                model, batch, wrt, plan)
        finally:
            plan.gathered.clear()
        for name, (dim, split) in zero.items():
            grads[name] = reduce_scatter_dim(grads[name], dim, split.group) \
                / plan.repeats(split.axes)
        buckets: dict[tuple, list] = {}
        partial = inner_partial_leaves(model)
        whole = inner_partial_leaves(model, "INNER_WHOLE")
        for name, g in grads.items():
            axes = plan.grad_sync_axes(axes_of[name], name in partial,
                                       name in whole)
            if axes:
                buckets.setdefault(axes, []).append(g)
        for axes, tensors in buckets.items():
            flat_all_reduce_(tensors, plan.mesh.group(axes))
        loss, metrics = shared(loss, metrics, ce_share, aux_mean, count)
        return loss, metrics, grads, sharded_global_norm(grads, axes_of,
                                                         plan)

    def local_step(model: LM, batch: dict):
        if mb == 1 and dp == 1:
            return grad_fn(model, batch)
        loss, metrics, grads, ce_share, aux_mean, count = accumulate(
            model, batch, dict(model.named_parameters()), None)
        if dp > 1:
            flat_all_reduce_(list(grads.values()), group)
        loss, metrics = shared(loss, metrics, ce_share, aux_mean, count)
        return loss, metrics, grads

    def norm_step(model: LM, batch: dict):
        """``(loss, metrics, grads, the clip norm or None)``."""
        batch = _on_device(batch, next(model.parameters()).device)
        plan = tensor_plan(rules)
        with use_rules(rules):
            if plan is not None:
                return tp_step(model, batch, plan)
            return (*local_step(model, batch), None)

    def grad_step(model: LM, batch: dict):
        """``(loss, metrics, grads)`` of one step, before the update: the
        gradients every rank holds after the all-reduce (under a
        ``TensorPlan``, of its shards)."""
        return norm_step(model, batch)[:3]

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        loss, metrics, grads, gnorm = norm_step(model, batch)
        named = dict(model.named_parameters())
        _, opt, opt_metrics = apply_updates(named, grads, state["opt"],
                                            opt_cfg, total_steps, gnorm)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return {"params": model, "opt": opt}, metrics

    train_step.grad_step = grad_step    # for tests and gradient probes
    return train_step


def make_eval_step(cfg: ModelConfig, pc: ParallelConfig, q_chunk: int = 1024,
                   ssm_chunk: int = 128):
    """``eval_step(model, batch) -> {"ce", "aux", "tokens"}`` without
    gradients."""
    def eval_step(model: LM, batch: dict) -> dict[str, Any]:
        with torch.no_grad():
            dev = next(model.parameters()).device
            _, metrics = _loss_fn(model, _on_device(batch, dev), cfg, pc,
                                  q_chunk, ssm_chunk)
        return metrics
    return eval_step
