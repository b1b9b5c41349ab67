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
bf16).
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
             q_chunk: int, ssm_chunk: int):
    """``(loss, {"ce", "aux", "tokens"})``: the chunked cross-entropy over
    the text positions (after the vision stub's patches) plus the MoE aux
    loss times ``AUX_LOSS_WEIGHT``."""
    h, aux = forward_hidden(model, batch, remat=pc.remat, q_chunk=q_chunk,
                            ssm_chunk=ssm_chunk)
    if cfg.frontend == Frontend.VISION_STUB.value:
        h = h[:, cfg.stub_patches:]        # loss over text positions only
    ce, count = chunked_cross_entropy(model.embed, h, batch["labels"], cfg)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux, "tokens": count}


def make_grad_fn(cfg: ModelConfig, pc: ParallelConfig, q_chunk: int = 1024,
                 ssm_chunk: int = 128):
    """``grad_fn(model, batch) -> (loss, metrics, grads)``: one forward and
    backward over the whole ``batch``, ``grads`` keyed by parameter name in
    the parameters' dtypes."""
    def grad_fn(model: LM, batch: dict):
        named = dict(model.named_parameters())
        batch = _on_device(batch, next(iter(named.values())).device)
        loss, metrics = _loss_fn(model, batch, cfg, pc, q_chunk, ssm_chunk)
        grads = torch.autograd.grad(loss, list(named.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))
    return grad_fn


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    opt_cfg: OptimizerConfig, pc: ParallelConfig,
                    total_steps: int = 10000, q_chunk: int = 1024,
                    ssm_chunk: int = 128, regather=None):
    """The step for ``pc.microbatches`` slices of each batch under
    ``pc.remat``. ``q_chunk`` is unused (K4 tiles its own queries);
    ``ssm_chunk`` is the Mamba and mLSTM chunk. ``regather`` needs a mesh
    and is refused."""
    if regather is not None:
        raise NotImplementedError(
            "regather (ZeRO-2 weight gathering) needs a mesh: ROADMAP Queue 1"
            " item 11.4")
    mb = max(1, pc.microbatches)
    grad_fn = make_grad_fn(cfg, pc, q_chunk, ssm_chunk)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        if mb == 1:
            loss, metrics, grads = grad_fn(model, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % mb:
                raise ValueError(f"{mb} microbatches do not divide a batch "
                                 f"of {rows} rows")

            def slice_mb(t, i):
                n = t.shape[0] // mb
                return t[i * n:(i + 1) * n]

            grads, loss = None, 0.0
            for i in range(mb):
                part = {k: slice_mb(v, i) for k, v in batch.items()}
                mb_loss, metrics, mb_grads = grad_fn(model, part)
                if grads is None:
                    grads = {k: g.float() / mb for k, g in mb_grads.items()}
                else:
                    for k, g in mb_grads.items():
                        grads[k].add_(g.float() / mb)
                del mb_grads
                loss = loss + mb_loss / mb
        named = dict(model.named_parameters())
        _, opt, opt_metrics = apply_updates(named, grads, state["opt"],
                                            opt_cfg, total_steps)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return {"params": model, "opt": opt}, metrics

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
