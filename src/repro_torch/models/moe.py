"""Token-choice top-k MoE with sort-based capacity dispatch (the port of
``repro/models/moe.py``, its local path).

Each batch row's assignments (token, choice) are grouped by expert, stably,
as the reference's per-row ``argsort`` groups them; an assignment's position
in its expert's run is its slot in the ``(B, E, C, D)`` dispatch buffer, and
slots at or past the capacity ``C`` are dropped. The port computes that
bookkeeping with K2 (``ops.grouping_indices``): one stable grouping of all
of a chunk's assignments by the composite id ``row * E + expert``, whose
offsets are the runs' starts (``dispatch``). On CPU tensors K2's wrapper
runs its plain version. ``dispatch_plain`` is the reference's per-row
argsort, kept as the contract that the tests and ``chip_smoke.py`` hold the
K2 dispatch to.

The router, the expert products, the gather, the scatter into the buffer
and the combine are plain tensor operations, as they are plain jnp in the
reference. Data parallelism runs this path on each rank's rows, with the
aux loss's batch means summed over the ranks (``aux_loss``, called by
``lm.forward_hidden`` outside the layer's checkpoint, so that a
recomputed layer makes no collective); that is also what the reference's
``moe_shard_map_local`` computes. The expert-parallel
all-to-all (``moe_shard_map``, under a ``model`` axis larger than 1) is
ROADMAP item 11.4c; under ``model=1`` its rules run this local path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.core.config import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.kernels.partition import MAX_SCATTER_PARTITIONS
from repro_torch.models.layers import init_normal
from repro_torch.parallel.collectives import replicated_sum


class MoE(nn.Module):
    """``router (d, E)`` in fp32, ``gate`` and ``up (E, d, f)`` and
    ``down (E, f, d)`` in the config's dtype: the reference's leaves."""

    AXES = {"router": ("w_embed", None),
            "gate": ("expert", "w_embed", "mlp"),
            "up": ("expert", "w_embed", "mlp"),
            "down": ("expert", "mlp", "w_embed")}

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_expert
        dtype = getattr(torch, cfg.dtype)
        self.router = init_normal((d, e), d ** -0.5, torch.float32,
                                  generator, device)
        self.gate = init_normal((e, d, f), d ** -0.5, dtype, generator,
                                device)
        self.up = init_normal((e, d, f), d ** -0.5, dtype, generator, device)
        self.down = init_normal((e, f, d), f ** -0.5, dtype, generator,
                                device)


def capacity(tokens: int, m: MoEConfig) -> int:
    """Slots per expert and row for a chunk of ``tokens`` tokens, rounded
    up to a multiple of 4 (at least 4)."""
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, -(-c // 4) * 4)


class Dispatch(NamedTuple):
    """The reference's bookkeeping, each ``(R, S*k)`` in grouped order:
    the expert of each assignment, its slot (clamped to ``C - 1``), its
    source token, its index in the row's ``(S*k,)`` assignments, and
    whether it fits under the capacity."""

    sorted_e: torch.Tensor
    slot: torch.Tensor
    token_src: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor


def _bookkeeping(sorted_e, run_pos, order, top_k: int, cap: int) -> Dispatch:
    return Dispatch(sorted_e, run_pos.clamp(max=cap - 1), order // top_k,
                    order, run_pos < cap)


def dispatch(top_i: torch.Tensor, num_experts: int, cap: int) -> Dispatch:
    """The dispatch bookkeeping of ``top_i (R, S, k)`` through K2: every
    assignment gets the composite id ``row * E + expert``, one
    ``grouping_indices`` call groups them stably, and an assignment's slot
    is its grouped position less its bucket's offset. Rows go to K2 in
    groups of at most ``(MAX_SCATTER_PARTITIONS - 1) // E`` (all of them
    for a batch of 4 with 32 experts)."""
    r, s, k = top_i.shape
    n = s * k
    dev = top_i.device
    flat = top_i.reshape(r, n).to(torch.int32)
    per_call = max(1, (MAX_SCATTER_PARTITIONS - 1) // num_experts)
    orders, runs = [], []
    for lo in range(0, r, per_call):
        sub = flat[lo:lo + per_call]
        g = sub.shape[0]
        base = torch.arange(g, dtype=torch.int64, device=dev)[:, None]
        ids = (base.to(torch.int32) * num_experts + sub).reshape(-1)
        order, offsets = ops.grouping_indices(ids, g * num_experts)
        order = order.long()
        run_start = offsets.long()[ids[order].long()]
        runs.append((torch.arange(g * n, device=dev) - run_start).view(g, n))
        orders.append(order.view(g, n) - base * n)
    order = torch.cat(orders)
    return _bookkeeping(flat.long().gather(1, order), torch.cat(runs), order,
                        k, cap)


def dispatch_plain(top_i: torch.Tensor, cap: int) -> Dispatch:
    """``dispatch``'s contract, as the reference computes it: a stable
    argsort of each row's experts, and each run's start by a running max
    over its boundaries."""
    r, s, k = top_i.shape
    flat = top_i.reshape(r, s * k).long()
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = flat.gather(1, order)
    idx = torch.arange(s * k, device=flat.device).expand(r, -1)
    boundary = torch.ones_like(sorted_e, dtype=torch.bool)
    boundary[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    return _bookkeeping(sorted_e, idx - run_start, order, k, cap)


def _expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of every expert over its slots: ``(B, E, C, D)`` ->
    ``(B, E, C, D)``, one batched product over the experts each
    (the reference's ``einsum("becd,edf->becf")``)."""
    b, e, c, d = buf.shape
    xs = buf.transpose(0, 1).reshape(e, b * c, d)
    gate = torch.bmm(xs, p.gate)
    up = torch.bmm(xs, p.up)
    hidden = F.silu(gate.float()).to(buf.dtype) * up
    return torch.bmm(hidden, p.down).view(e, b, c, d).transpose(0, 1)


def _moe_chunk(p: MoE, x: torch.Tensor, top_p: torch.Tensor,
               top_i: torch.Tensor, cap: int) -> torch.Tensor:
    """One chunk ``x (B, C_s, D)``: dispatch, experts, combine (the
    reference's ``_dispatch_row``, ``_expert_ffn`` and ``_combine_row``
    over every row at once)."""
    b, s, d = x.shape
    bk = dispatch(top_i, p.router.shape[1], cap)
    rows = torch.arange(b, device=x.device)[:, None].expand_as(bk.slot)
    gathered = x[rows, bk.token_src] * bk.keep[..., None].to(x.dtype)
    buf = torch.zeros((b, p.router.shape[1], cap, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((rows, bk.sorted_e, bk.slot), gathered, accumulate=True)
    out = _expert_ffn(p, buf)
    back = out[rows, bk.sorted_e, bk.slot]
    w = top_p.reshape(b, -1).gather(1, bk.order)
    back = back * (w * bk.keep).to(back.dtype)[..., None]
    y = torch.zeros_like(x)
    y.view(b * s, d).index_add_(0, (rows * s + bk.token_src).reshape(-1),
                                back.reshape(-1, d))
    return y


def route(p: MoE, x: torch.Tensor, top_k: int):
    """The router: fp32 probabilities over the experts ``(B, S, E)``, and
    each token's ``top_k`` experts ``top_i`` with their probabilities
    renormalized to sum to 1, ``top_p``. Returns ``(probs, top_p, top_i)``."""
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def moe_parts(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              s_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, D)`` -> ``(y, stats)``: the layer's output and its
    load-balance statistics ``stats (2, E)``, the fraction of ``x``'s
    tokens routed first to each expert and each expert's mean probability
    (``aux_loss`` makes the aux of them). The router and its softmax run
    in fp32; the sequence is dispatched in chunks of ``s_chunk`` tokens,
    each with its own capacity."""
    m = cfg.moe
    b, s, _ = x.shape
    e, k = m.num_experts, m.top_k
    probs, top_p, top_i = route(p, x, k)
    frac = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    stats = torch.stack([frac, probs.mean(dim=(0, 1))])

    s_chunk = min(s_chunk, s)
    if s % s_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{s_chunk}")
    cap = capacity(s_chunk, m)
    ys = [_moe_chunk(p, x[:, lo:lo + s_chunk], top_p[:, lo:lo + s_chunk],
                     top_i[:, lo:lo + s_chunk], cap)
          for lo in range(0, s, s_chunk)]
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), stats


def aux_loss(stats: torch.Tensor, cfg: ModelConfig,
             group=None) -> torch.Tensor:
    """The Switch-style load-balance loss of ``moe_parts``'s ``stats``:
    ``E * sum(fraction routed first * mean probability)``. With ``group``
    (the ranks a data-parallel batch is split over, each holding as many
    rows) both means are first summed over the ranks, differentiably, and
    averaged: the whole batch's, as the reference takes them."""
    if group is not None:
        stats = replicated_sum(stats, group) / dist.get_world_size(group)
    return cfg.moe.num_experts * (stats[0] * stats[1]).sum()


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig,
        s_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, D)`` -> ``(y, aux)``, ``aux`` the load-balance loss of
    ``x``'s tokens (``moe_parts``, ``aux_loss``)."""
    y, stats = moe_parts(p, x, cfg, s_chunk)
    return y, aux_loss(stats, cfg)
