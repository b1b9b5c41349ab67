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
data-parallel (``make_train_step``).
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
from repro_torch.models.lm import LM, forward_hidden
from repro_torch.parallel.collectives import all_reduce_, flat_all_reduce_
from repro_torch.parallel.sharding import (
    ShardingRules,
    current_rules,
    require_executable,
    use_rules,
)
from repro_torch.training.losses import chunked_cross_entropy
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
             q_chunk: int, ssm_chunk: int, total_count=None):
    """``(loss, {"ce", "aux", "tokens"})``: the chunked cross-entropy over
    the text positions (after the vision stub's patches) plus the MoE aux
    loss times ``AUX_LOSS_WEIGHT``. With ``total_count`` (the tokens of the
    whole batch whose rows these are) the cross-entropy is this rank's
    share of the whole batch's mean."""
    h, aux = forward_hidden(model, batch, remat=pc.remat, q_chunk=q_chunk,
                            ssm_chunk=ssm_chunk)
    if cfg.frontend == Frontend.VISION_STUB.value:
        h = h[:, cfg.stub_patches:]        # loss over text positions only
    ce, count = chunked_cross_entropy(model.embed, h, batch["labels"], cfg,
                                      total_count=total_count)
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
    and optimizer state. Rules that shard anything else over more than one
    rank are refused (``require_executable``), as is ``regather``: both
    are ROADMAP item 11.4b."""
    rules = current_rules() if rules is None else rules
    require_executable(rules)
    if regather is not None:
        raise NotImplementedError(
            "regather (ZeRO-2 weight gathering) needs ZeRO sharding: ROADMAP "
            "Queue 1 item 11.4b")
    mb = max(1, pc.microbatches)
    grad_fn = make_grad_fn(cfg, pc, q_chunk, ssm_chunk)
    group, dp, index = _batch_split(rules)

    def local_step(model: LM, batch: dict):
        rows = next(iter(batch.values())).shape[0]
        if mb == 1 and dp == 1:
            return grad_fn(model, batch)
        if rows % (mb * dp):
            raise ValueError(f"{mb} microbatches over {dp} batch ranks do "
                             f"not divide a batch of {rows} rows")
        grads, loss, ce_share, aux_mean = None, 0.0, 0.0, 0.0
        for i in range(mb):
            part = _rows(batch, i, mb)
            count = None
            if dp > 1:
                count = text_tokens(part)
                part = _rows(part, index, dp)
            mb_loss, metrics, mb_grads = grad_fn(model, part, count)
            if grads is None:
                grads = {k: g.float() / mb for k, g in mb_grads.items()}
            else:
                for k, g in mb_grads.items():
                    grads[k].add_(g.float() / mb)
            del mb_grads
            loss = loss + mb_loss / mb
            ce_share = ce_share + metrics["ce"] / mb
            aux_mean = aux_mean + metrics["aux"] / mb
        if dp > 1:
            # the ranks' shares of the mean cross-entropy and of the last
            # microbatch's; the aux is already every rank's
            shares = torch.stack([ce_share, metrics["ce"]]).float()
            all_reduce_(shares, group)
            flat_all_reduce_(list(grads.values()), group)
            loss = shares[0] + AUX_LOSS_WEIGHT * aux_mean
            metrics = {"ce": shares[1], "aux": metrics["aux"],
                       "tokens": count}
        return loss, metrics, grads

    def grad_step(model: LM, batch: dict):
        """``(loss, metrics, grads)`` of one step, before the update: the
        gradients every rank holds after the all-reduce."""
        batch = _on_device(batch, next(model.parameters()).device)
        with use_rules(rules):
            return local_step(model, batch)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        loss, metrics, grads = grad_step(model, batch)
        named = dict(model.named_parameters())
        _, opt, opt_metrics = apply_updates(named, grads, state["opt"],
                                            opt_cfg, total_steps)
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
