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
``lm.forward_hidden`` outside the layer's checkpoint).

Under rules that split more than the batch (``moe_parts`` with a
``TensorPlan``) the rules pick one of four data planes, three of them the
reference's ``moe``'s and one the plane GSPMD makes of its chunked
``moe`` under ``expert_act``:

- ``moe_shard_map`` (``moe_impl="shard_map_a2a"``, experts over
  ``model``, the residual whole or split over axes that include
  ``model``): each rank dispatches its block of the sequence at that
  block's capacity and trades ``(tp, B, E_loc, C, D)`` buffers with the
  experts' owners through two differentiable all-to-alls
  (``collectives.exchange_rows``): the assignments dropped are the
  reference's ``moe_shard_map``'s, not its chunked ``moe``'s. On a
  residual split over other axes the reference's experts' ranks each
  send the same block; the port runs the ``gather`` plane on each rank's
  block at that block's capacity, which computes the same;
- ``all_to_all`` (``expert_act`` over any axes with the experts split,
  the planner's baseline profile; also the experts under a sequence
  split over their own axes without ``moe_impl``): the same exchanges,
  but the capacity is that of the unsharded layer's chunks of
  ``s_chunk`` global positions, so the function, drops included, is the
  unsharded ``moe``'s. A rank whose block is part of a chunk starts its
  slots after those of the chunk's earlier positions (``dispatch``'s
  ``start``), and the experts' owners add the chunk's sources up
  (``_moe_a2a``);
- ``gather`` (``_moe_partial``: experts over ``model`` with no
  ``moe_impl``, every decode cell; the experts on their mlp dimension,
  ``expert`` whole and ``mlp`` over ``model``, which ``make_rules`` gives
  where ``model`` does not divide the experts; any other split beside a
  sequence split): every rank dispatches all the tokens it takes and
  runs its block of the experts and of their ``d_expert`` columns, and
  the ranks' outputs are summed over the block's axes. The reference
  lets GSPMD assemble the same sum; the port sums each rank's combine of
  its own rows (one all-reduce of ``(B, S, D)``), which never moves the
  ``(B, E, C, D)`` buffer. Under a sequence split the layer takes the
  sequence through ``tensor.Reshard``: gathered over the sequence's axes
  (only those the block splits, where each rank's block holds whole
  chunks), and the rank's block of the sum given back;
- ``moe_shard_map_local`` (``pure_dp``, the batch over the whole mesh):
  the local path on each rank's rows, in one chunk, the ZeRO-sharded
  leaves gathered.

The aux statistics are the whole batch's on every plane: each rank's
tokens' means, averaged over the ranks that hold other tokens
(``TensorPlan.stats``: the batch axes and a sequence split). The
reference's ``moe_shard_map`` averages over ``model`` only, which is one
data shard's aux where ``data`` > 1; under ``data=1`` the two agree
(ROADMAP Queue 3, "Kept on purpose").
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
from repro_torch.parallel import collectives as C
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


def _bookkeeping(sorted_e, run_pos, order, top_k: int, cap: int,
                 start=None) -> Dispatch:
    if start is not None:
        run_pos = run_pos + start.long().gather(1, sorted_e)
    return Dispatch(sorted_e, run_pos.clamp(max=cap - 1), order // top_k,
                    order, run_pos < cap)


def dispatch(top_i: torch.Tensor, num_experts: int, cap: int,
             start: torch.Tensor | None = None) -> Dispatch:
    """The dispatch bookkeeping of ``top_i (R, S, k)`` through K2: every
    assignment gets the composite id ``row * E + expert``, one
    ``grouping_indices`` call groups them stably, and an assignment's slot
    is its grouped position less its bucket's offset. Rows go to K2 in
    groups of at most ``(MAX_SCATTER_PARTITIONS - 1) // E`` (all of them
    for a batch of 4 with 32 experts). ``start (R, E)``: the slot each
    row's run of each expert starts at (the assignments of the chunk that
    precede these positions, held elsewhere), else 0."""
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
                        k, cap, start)


def dispatch_plain(top_i: torch.Tensor, cap: int,
                   start: torch.Tensor | None = None) -> Dispatch:
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
    return _bookkeeping(sorted_e, idx - run_start, order, k, cap, start)


def _weights(p: MoE, plan) -> dict:
    """The layer's four leaves as this rank computes with them: its
    parameters, or under a ``plan`` its shards with ``w_embed`` gathered
    (``TensorPlan.weight``)."""
    return {leaf: getattr(p, leaf) if plan is None else plan.weight(p, leaf)
            for leaf in ("router", "gate", "up", "down")}


def _expert_ffn(w: dict, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of every expert of ``w`` over its slots: ``(B, E, C, D)``
    -> ``(B, E, C, D)``, one batched product over the experts each (the
    reference's ``einsum("becd,edf->becf")``)."""
    b, e, c, d = buf.shape
    xs = buf.transpose(0, 1).reshape(e, b * c, d)
    gate = torch.bmm(xs, w["gate"])
    up = torch.bmm(xs, w["up"])
    hidden = F.silu(gate.float()).to(buf.dtype) * up
    return torch.bmm(hidden, w["down"]).view(e, b, c, d).transpose(0, 1)


def _block(bk: Dispatch, first: int, count: int, total: int):
    """Each assignment's expert as an index into the block of experts
    ``[first, first + count)`` of ``total``, and whether it is kept and
    falls in the block."""
    if count == total:
        return bk.sorted_e, bk.keep
    e = bk.sorted_e - first
    return e.clamp(0, count - 1), bk.keep & (e >= 0) & (e < count)


def _scatter(x: torch.Tensor, bk: Dispatch, cap: int, first: int,
             count: int, total: int) -> torch.Tensor:
    """The ``(B, count, C, D)`` dispatch buffer of experts ``[first,
    first + count)`` of ``total``: each kept assignment's token at its slot
    (the reference's ``buf.at[sorted_e, slot].add``)."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None].expand_as(bk.slot)
    e, keep = _block(bk, first, count, total)
    gathered = x[rows, bk.token_src] * keep[..., None].to(x.dtype)
    buf = torch.zeros((b, count, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((rows, e, bk.slot), gathered, accumulate=True)
    return buf


def _combine(out: torch.Tensor, bk: Dispatch, top_p: torch.Tensor, s: int,
             first: int, total: int) -> torch.Tensor:
    """Each token's sum of its kept assignments' expert outputs weighted by
    their routing probabilities, from the ``(B, E', C, D)`` buffer ``out``
    of experts ``[first, first + E')`` of ``total`` (the others'
    assignments add 0): the reference's ``_combine_row`` over every
    row."""
    b, count, _, d = out.shape
    rows = torch.arange(b, device=out.device)[:, None].expand_as(bk.slot)
    e, keep = _block(bk, first, count, total)
    back = out[rows, e, bk.slot]
    w = top_p.reshape(b, -1).gather(1, bk.order)
    back = back * (w * keep).to(back.dtype)[..., None]
    y = out.new_zeros((b, s, d))
    y.view(b * s, d).index_add_(0, (rows * s + bk.token_src).reshape(-1),
                                back.reshape(-1, d))
    return y


def _moe_chunk(w: dict, x: torch.Tensor, top_p: torch.Tensor,
               top_i: torch.Tensor, cap: int,
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    """One chunk ``x (B, C_s, D)``: dispatch, experts, combine (the
    reference's ``_dispatch_row``, ``_expert_ffn`` and ``_combine_row``
    over every row at once). ``experts = (first, count)``: the experts of
    ``w`` (a rank's block under the ``gather`` plane), else all."""
    e = w["router"].shape[1]
    first, count = experts or (0, e)
    bk = dispatch(top_i, e, cap)
    out = _expert_ffn(w, _scatter(x, bk, cap, first, count, e))
    return _combine(out, bk, top_p, x.shape[1], first, e)


def route(p: MoE, x: torch.Tensor, top_k: int, router=None):
    """The router (``router``, else ``p.router``): fp32 probabilities over
    the experts ``(B, S, E)``, and each token's ``top_k`` experts ``top_i``
    with their probabilities renormalized to sum to 1, ``top_p``. Returns
    ``(probs, top_p, top_i)``."""
    probs = torch.softmax(x.float() @ (p.router if router is None
                                       else router), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def _stats(probs: torch.Tensor, top_i: torch.Tensor, e: int) -> torch.Tensor:
    frac = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    return torch.stack([frac, probs.mean(dim=(0, 1))])


def _chunk_layout(s_loc: int, n: int, s_chunk: int | None):
    """``(chunk, chunks held, ranks a chunk)`` of a rank holding ``s_loc``
    positions of ``n * s_loc``: the chunk is ``s_loc`` itself where
    ``s_chunk`` is ``None`` (capacity per source block), else
    ``min(s_chunk, n * s_loc)`` global positions, which must nest with the
    ranks' blocks. ``None`` where they do not."""
    if s_chunk is None:
        return s_loc, 1, 1
    sc = min(s_chunk, n * s_loc)
    if (n * s_loc) % sc:
        raise ValueError(f"sequence {n * s_loc} is not a multiple of the "
                         f"chunk {sc}")
    if s_loc % sc == 0:
        return sc, s_loc // sc, 1
    if sc % s_loc == 0:
        return sc, 1, sc // s_loc
    return None


def _moe_a2a(p: MoE, w: dict, x: torch.Tensor, cfg: ModelConfig, plan,
             s_chunk: int | None = None):
    """The all-to-all planes: each ``expert`` rank dispatches its block of
    the sequence (the rows it holds where the residual is sequence-sharded,
    else its ``1/tp`` of a sequence every rank holds, routed whole on
    every rank and split with ``split_along``), exchanges buffers with the
    experts' owners, runs its ``E_loc`` experts over the slots every
    source sent, and exchanges the outputs back; a sequence split here is
    gathered again (``gather_replicated``).

    ``s_chunk=None`` is ``moe_shard_map``: the capacity of each source
    block. Else (``all_to_all``) the capacity of the unsharded layer's
    chunks of ``s_chunk`` global positions: a rank holding ``nco`` whole
    chunks sends ``(tp, B, E_loc, nco, C, D)``; ``g`` ranks sharing a
    chunk each send the chunk's ``(tp, B, E_loc, 1, C, D)`` buffer with
    their own tokens only, their runs of each expert starting after the
    earlier ranks' (``start``: counted from ``top_i`` where the residual
    is whole, else one ``all_gather`` of each rank's ``(B, E)`` counts),
    and each owner sums the chunk's ``g`` sources (each slot is one
    token's, so the sum is exact) and sends the chunk's outputs back to
    all ``g``. A layer's forward moves per rank two all-to-alls of
    ``B * E * nco * C * D`` elements (``nco * C`` about
    ``s_loc * top_k * capacity_factor / E``, times ``g`` where a chunk is
    shared), its backward the same two; the whole residual adds a
    gather of ``y`` forward and of ``x``'s and ``top_p``'s gradients
    backward."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    ex = plan.expert
    tp, group = ex.n, ex.group
    e_loc = e // tp
    b, s, d = x.shape
    probs, top_p, top_i = route(p, x, k, w["router"])
    stats = _stats(probs, top_i, e)
    whole_i = top_i
    lo = 0
    if not plan.seq:
        lo, n = ex.block(s)
        x = C.split_along(x, 1, group)
        top_p = C.split_along(top_p, 1, group)
        top_i = top_i[:, lo:lo + n]
    s_loc = x.shape[1]
    layout = _chunk_layout(s_loc, tp, s_chunk)
    if layout is None:
        raise ValueError(f"chunks of {s_chunk} positions do not nest with "
                         f"blocks of {s_loc}")
    sc, nco, g = layout
    cap = capacity(sc, m)
    start = None
    if g > 1:
        if plan.seq:
            ones = torch.ones_like(top_i.reshape(b, -1))
            hist = torch.zeros((b, e), dtype=ones.dtype, device=x.device) \
                .scatter_add_(1, top_i.reshape(b, -1), ones)
            every = C.all_gather(hist, group)       # (tp, B, E)
            i = ex.index
            start = every[i - i % g:i].sum(0)
        else:
            first = (lo // sc) * sc
            earlier = whole_i[:, first:lo].reshape(b, -1)
            start = torch.zeros((b, e), dtype=torch.int64,
                                device=x.device).scatter_add_(
                1, earlier, torch.ones_like(earlier))
    rows = s_loc // nco
    bk = dispatch(top_i.reshape(b * nco, rows, k), e, cap, start)
    buf = _scatter(x.reshape(b * nco, rows, d), bk, cap, 0, e, e)
    send = buf.view(b, nco, tp, e_loc, cap, d).permute(2, 0, 3, 1, 4, 5) \
        .contiguous()                             # (owner, B, E_loc, nco, C, D)
    recv = C.exchange_rows(send, group)           # (source, B, E_loc, nco, C, D)
    if g > 1:                                     # (chunk, B, E_loc, 1, C, D)
        recv = recv.view(tp // g, g, b, e_loc, 1, cap, d).sum(1)
    t = recv.shape[0]
    mine = recv.permute(1, 2, 0, 3, 4, 5).reshape(b, e_loc, t * nco * cap, d)
    out = _expert_ffn(w, mine)
    back = out.view(b, e_loc, t, nco, cap, d).permute(2, 0, 1, 3, 4, 5)
    if g > 1:
        back = back.repeat_interleave(g, dim=0)
    ret = C.exchange_rows(back.contiguous(), group)
    ret = ret.permute(1, 3, 0, 2, 4, 5).reshape(b * nco, e, cap, d)
    y = _combine(ret, bk, top_p.reshape(b * nco, rows, k), rows, 0, e) \
        .view(b, s_loc, d)
    if not plan.seq:
        y = C.gather_replicated(y, 1, group)
    return y, stats


def _moe_partial(p: MoE, w: dict, x: torch.Tensor, cfg: ModelConfig, plan,
                 s_chunk: int, per_block: bool = False):
    """The ``gather`` plane, and every layout the all-to-alls do not take:
    each rank routes and dispatches every token of the sequence it takes
    (as the unsharded layer does, chunk by chunk), runs its block of the
    experts (``plan.expert``) and of their ``d_expert`` columns of
    ``gate``/``up`` and rows of ``down`` (``plan.moe_inside``, where the
    rules split the experts on their mlp dimension) and combines its
    rows; the ranks' partial outputs are summed over the block's ranks.
    The router runs alike on every rank; the dispatch input and the
    routing weights enter through ``copy_to``.

    Under a sequence split the block takes the sequence as
    ``tensor.Reshard`` gives it: only its ranks' blocks where each rank's
    block holds whole chunks (``per_block``: the chunk is the rank's
    block, ``moe_shard_map``'s capacity), else the whole sequence, and it
    gives back the rank's block of the sum."""
    m = cfg.moe
    r = plan.reshard(plan.moe_block)
    first, count = plan.expert.block(m.num_experts) if plan.expert \
        else (0, m.num_experts)
    if per_block:
        s_chunk, local = x.shape[1], True
    else:
        local = x.shape[1] % min(s_chunk, x.shape[1] * plan.seq.n) == 0
    x = r.gather(x, local)
    probs, top_p, top_i = route(p, x, m.top_k, w["router"])
    stats = _stats(probs, top_i, m.num_experts)
    y = _chunked(w, r.replicate(x), r.replicate(top_p), top_i, cfg, s_chunk,
                 (first, count))
    return r.leave(y, local), stats


def _chunked(w: dict, x, top_p, top_i, cfg: ModelConfig, s_chunk: int,
             experts=None) -> torch.Tensor:
    s = x.shape[1]
    s_chunk = min(s_chunk, s)
    if s % s_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{s_chunk}")
    cap = capacity(s_chunk, cfg.moe)
    ys = [_moe_chunk(w, x[:, lo:lo + s_chunk], top_p[:, lo:lo + s_chunk],
                     top_i[:, lo:lo + s_chunk], cap, experts)
          for lo in range(0, s, s_chunk)]
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)


def moe_parts(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              s_chunk: int = 1024, plan=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, D)`` -> ``(y, stats)``: the layer's output and its
    load-balance statistics ``stats (2, E)``, the fraction of ``x``'s
    tokens routed first to each expert and each expert's mean probability
    (``aux_loss`` makes the aux of them). The router and its softmax run
    in fp32; the sequence is dispatched in chunks of ``s_chunk`` tokens,
    each with its own capacity.

    Under a ``plan`` (``parallel.tensor.TensorPlan``) the rules pick the
    plane (module docstring): ``moe_impl="shard_map_a2a"`` runs
    ``_moe_a2a`` at the capacity of each source block, no chunks, where
    the experts' axes are among the sequence's (or the residual is whole),
    else ``_moe_partial`` on each rank's block at its capacity (the
    reference's ``moe_shard_map`` on a residual split over other axes
    sends every expert rank the same block); ``expert_act`` split (the
    planner's baseline profile turns its ``shard_map_a2a`` plans into
    GSPMD's ``all_to_all``) or a residual split over the experts' own
    axes runs ``_moe_a2a`` in the unsharded layer's chunks; every other
    split (the experts without either, the experts on their mlp
    dimension, a sequence split over other axes than the experts',
    ``expert_act`` where a whole residual does not split over the
    experts' ranks in nesting blocks) runs ``_moe_partial``, which
    computes the unsharded layer's chunks too. Without any split but the
    batch every rank runs this local path on its rows, the ZeRO-sharded
    leaves gathered, in one chunk under ``moe_impl="shard_map_local"``
    (the reference's ``moe_shard_map_local``: capacity of the whole local
    sequence). ``stats`` are then this rank's tokens' (``plan.stats``
    names the axes whose ranks hold other tokens)."""
    m = cfg.moe
    w = _weights(p, plan)
    if plan is not None:
        if plan.moe_impl == "shard_map_a2a":
            if plan.expert and (not plan.seq or set(plan.expert.axes)
                                <= set(plan.seq.axes)):
                return _moe_a2a(p, _whole_mlp(w, plan), x, cfg, plan)
            return _moe_partial(p, w, x, cfg, plan, s_chunk, per_block=True)
        if plan.expert and not plan.moe_inside:
            s = x.shape[1]
            if plan.seq.axes == plan.expert.axes or (
                    not plan.seq and plan.expert_act
                    and s % plan.expert.n == 0
                    and _chunk_layout(s // plan.expert.n, plan.expert.n,
                                      s_chunk)):
                return _moe_a2a(p, w, x, cfg, plan, s_chunk)
        if plan.moe_block or plan.seq:
            return _moe_partial(p, w, x, cfg, plan, s_chunk)
        if plan.moe_impl == "shard_map_local":
            s_chunk = x.shape[1]
    probs, top_p, top_i = route(p, x, m.top_k, w["router"])
    stats = _stats(probs, top_i, m.num_experts)
    return _chunked(w, x, top_p, top_i, cfg, s_chunk), stats


def _whole_mlp(w: dict, plan) -> dict:
    """The experts' leaves with their ``d_expert`` dimension gathered where
    the rules split it (the reference's ``moe_shard_map`` takes them whole
    on it, ``mlp_unused``): the gradient is reduce-scattered back, over
    the ranks that repeat each other's rows (``TensorPlan.repeats``)."""
    inside = plan.moe_inside
    if not inside:
        return w
    scale = 1.0 / plan.repeats(inside.axes)
    return dict(w, **{leaf: C.gather_along(w[leaf], dim, inside.group, scale)
                      for leaf, dim in (("gate", 2), ("up", 2),
                                        ("down", 1))})


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
        s_chunk: int = 1024, plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, D)`` -> ``(y, aux)``, ``aux`` the load-balance loss of
    the tokens of ``x`` (``moe_parts``, ``aux_loss``; under a ``plan``,
    of every rank's tokens: ``plan.stats``)."""
    y, stats = moe_parts(p, x, cfg, s_chunk, plan)
    return y, aux_loss(stats, cfg, None if plan is None else
                       plan.stats.group)
