"""AdamW with fp32 master weights, global-norm clipping and a warmup +
cosine learning rate (the port of ``repro/training/optimizer.py``).

The state mirrors the parameters by name: ``master``, ``m`` and ``v`` are
fp32 tensors on the parameters' device, ``step`` a device int32 scalar.
``apply_updates`` does the math in fp32 whatever the parameters' dtype and
writes the parameters in place from the master copy. The learning rate,
the norm and the clip scale stay device tensors, so a step makes no host
sync unless its caller reads a metric. ``opt_state_axes`` gives the state's
logical axes (those of the parameters), as in the reference.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Mapping

import torch

from repro_torch.core.config import OptimizerConfig


def init_opt_state(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"step": 0, "master": fp32 copies, "m": zeros, "v": zeros}`` of a
    mapping from names to parameters."""
    first = next(iter(params.values()))
    with torch.no_grad():
        return {
            "step": torch.zeros((), dtype=torch.int32, device=first.device),
            "master": {k: p.detach().float().clone()
                       for k, p in params.items()},
            "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
        }


def opt_state_axes(param_axes: Any) -> dict:
    """Logical axes for the optimizer state (same sharding as params):
    ``param_axes`` is ``repro_torch.models.convert.param_axes``'s tree."""
    return {"step": (), "master": copy.deepcopy(param_axes),
            "m": copy.deepcopy(param_axes), "v": copy.deepcopy(param_axes)}


def lr_schedule(cfg: OptimizerConfig, step, total_steps: int = 10000
                ) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine down
    to a tenth of it at ``total_steps``; fp32, on ``step``'s device."""
    step_f = torch.as_tensor(step).float()
    warm = torch.clamp(step_f / max(1, cfg.warmup_steps), max=1.0)
    progress = torch.clamp((step_f - cfg.warmup_steps)
                           / max(1, total_steps - cfg.warmup_steps), 0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm over every tensor of ``tree``."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in tree.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


def decays(name: str, leaf: torch.Tensor) -> bool:
    """Whether AdamW decays the parameter ``name``: the reference decays
    its leaves of ``ndim >= 2``, and holds each layer's leaves stacked over
    the repeats (``models/convert.py``), one dimension more than the
    port's ``layers.{i}.*``."""
    return leaf.dim() >= 2 or name.startswith("layers.")


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: dict,
                  cfg: OptimizerConfig, total_steps: int = 10000,
                  gnorm: torch.Tensor | None = None
                  ) -> tuple[Mapping[str, torch.Tensor], dict, dict]:
    """One AdamW step. ``grads`` (any float dtype) are keyed as ``params``;
    the math is fp32. Updates ``state`` and writes every parameter in place
    from its new master copy; returns ``(params, state, {"grad_norm": the
    pre-clip norm, "lr"})``. Weight decay applies where the reference
    applies it, to the leaves of ``ndim >= 2`` in its layout: the
    matrices, and every layer's leaf (``layers.*``), which it stacks over
    the repeats, its norm scales and biases too (``decays``). ``gnorm``,
    where given, is the norm to clip by (a
    pipeline stage holds part of the gradient tree; the norm is the
    whole tree's)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step, total_steps)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.where(gnorm > cfg.grad_clip,
                        cfg.grad_clip / (gnorm + 1e-9),
                        torch.ones_like(gnorm))
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.float()
    bc1 = 1.0 - torch.pow(b1, step_f)
    bc2 = 1.0 - torch.pow(b2, step_f)
    for name, p in params.items():
        master, m, v = state["master"][name], state["m"][name], \
            state["v"][name]
        g32 = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32.square())
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decays(name, master):
            update = update + cfg.weight_decay * master
        master.sub_(lr * update)
        p.copy_(master)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
