"""Grouped-query attention (the port of ``repro/models/attention.py``).

The attention cores go through the port's kernel dispatch point
(``repro_torch.kernels.ops``): the full and prefill paths through K4
(``flash_attention``, on the K kv heads, which it groups itself as the
reference's ``jnp.repeat`` does), the decode path through K5
(``decode_attention``, on the ``(B, S, K, hd)`` cache in place).
On the card those are the CUDA kernels; on CPU tensors their plain
versions.

Under data parallelism each rank runs this path on its rows. Under rules
that split more than the batch each function takes the rank's
``TensorPlan`` (``plan``) and runs the reference's strategies with
explicit collectives:

- ``head_tp``: ``wq``, ``wk``/``wv`` (where the kv heads divide) and
  ``wo`` hold this rank's heads; the replicated input enters through
  ``copy_to`` and the output projection's partial sums meet in one
  all-reduce. Where the kv heads do not divide, or the rules split them
  over other axes than the query heads (their projections then gathered
  whole over that split: ``TensorPlan.kv_gather``), every rank projects
  them all and keeps those its query heads read. Its decode cache holds
  every kv head where they do not divide (decode gathers the query heads
  whole), and only those its query heads read under ``kv_gather``
  (decode runs K5 on the rank's own heads).
- ``seq_tp``: each rank projects its block of the sequence, gathers K and
  V whole (on the int8 wire of ``collectives.int8_gather_along`` under
  ``kv_compress``, the reference's ``_int8_broadcast``) and runs K4 on its
  queries at their offset in the sequence.
- ``decode_kv_shard``: each rank holds its ``cache_seq`` block of the
  cache (all kv heads), writes the new token's K and V where its position
  falls in the block, runs K5 on the block with its own lengths and the
  log-sum-exp, and the ranks' outputs are combined by their log-sum-exp
  (the flash-decode split that GSPMD inferred in the reference).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, init_normal
from repro_torch.parallel import collectives as C


class Attention(nn.Module):
    """``wq (d, H, hd)``, ``wk``/``wv (d, K, hd)``, ``wo (H, hd, d)`` and,
    with ``qkv_bias``, ``bq (H, hd)``, ``bk``/``bv (K, hd)``: the
    reference's layouts."""

    AXES = {"wq": ("w_embed", "heads", "qkv"),
            "wk": ("w_embed", "kv_heads", "qkv"),
            "wv": ("w_embed", "kv_heads", "qkv"),
            "wo": ("heads", "qkv", "w_embed"),
            "bq": ("heads", "qkv"), "bk": ("kv_heads", "qkv"),
            "bv": ("kv_heads", "qkv")}

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d, h, kh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        dtype = getattr(torch, cfg.dtype)
        self.wq = init_normal((d, h, hd), d ** -0.5, dtype, generator, device)
        self.wk = init_normal((d, kh, hd), d ** -0.5, dtype, generator,
                              device)
        self.wv = init_normal((d, kh, hd), d ** -0.5, dtype, generator,
                              device)
        self.wo = init_normal((h, hd, d), (h * hd) ** -0.5, dtype, generator,
                              device)
        if cfg.qkv_bias:
            for name, heads in (("bq", h), ("bk", kh), ("bv", kh)):
                setattr(self, name, nn.Parameter(
                    torch.zeros((heads, hd), dtype=dtype, device=device),
                    requires_grad=False))


def init_attention(cfg: ModelConfig, generator, device) -> Attention:
    return Attention(cfg, generator, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


_HEAD_DIM = {"wq": 1, "bq": 0, "wo": 0}     # each query-head leaf's heads


def _q_block(cfg: ModelConfig, plan) -> tuple[int, int]:
    """``(first, count)`` of the query heads this rank computes: its block
    of the head split, or, where only the kv heads are split, the query
    heads that read its kv heads."""
    if plan is None or not plan.q_heads:
        return 0, cfg.num_heads
    if plan.heads:
        return plan.heads.block(cfg.num_heads)
    g = cfg.num_heads // cfg.num_kv_heads
    k0, k_loc = plan.kv_heads.block(cfg.num_kv_heads)
    return k0 * g, k_loc * g


def _weights(p: Attention, plan, names=("wq", "wk", "wv"), cfg=None):
    """The leaves as this rank computes with them: under a ``plan``, its
    shards (``w_embed`` gathered) and, where only the kv heads are split,
    its query heads' block of the query-head leaves (whole on every
    rank, so each rank's gradient of them is a partial sum)."""
    if plan is None:
        return [getattr(p, n) for n in names]
    out = [plan.weight(p, n) for n in names]
    if plan.heads or not plan.kv_heads:
        return out
    q0, h_loc = _q_block(cfg, plan)
    return [w.narrow(_HEAD_DIM[n], q0, h_loc) if n in _HEAD_DIM else w
            for n, w in zip(names, out)]


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, plan=None):
    names = ("wq", "wk", "wv") + (("bq", "bk", "bv") if cfg.qkv_bias
                                  else ())
    w = _weights(p, plan, names, cfg)
    q, k, v = _proj(x, w[0]), _proj(x, w[1]), _proj(x, w[2])
    if cfg.qkv_bias:
        q, k, v = q + w[3], k + w[4], v + w[5]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: Attention, out: torch.Tensor, cfg: ModelConfig, plan=None,
         reduce: bool = True) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product (under a ``plan``
    that splits the query heads, this rank's heads' rows of ``wo``, the
    partial sums summed over the head ranks unless ``reduce`` is off)."""
    (wo,) = _weights(p, plan, ("wo",), cfg)
    h, hd, d = wo.shape
    y = out.flatten(-2) @ wo.reshape(h * hd, d)
    if reduce and plan is not None and plan.q_heads:
        y = C.reduce_from(y, plan.q_heads.group)
    return y


def _kv_read(cfg: ModelConfig, plan) -> range | list[int] | None:
    """The kv heads this rank's query heads read where the heads are split
    and the kv heads are not (or are gathered, ``TensorPlan.kv_gather``):
    a ``range`` of whole groups of query heads, or of a part of one group
    (query head i reads kv head i // (H_local // K_local), K4's and K5's
    grouping), or else a list of each query head's own. ``None``: the
    rank reads every kv head it holds."""
    if plan is None or not plan.heads or plan.kv_heads:
        return None
    g = cfg.num_heads // cfg.num_kv_heads
    q0, h_loc = plan.heads.block(cfg.num_heads)
    if h_loc % g == 0:
        return range(q0 // g, q0 // g + h_loc // g)
    if g % h_loc == 0 and q0 // g == (q0 + h_loc - 1) // g:
        return range(q0 // g, q0 // g + 1)
    return [i // g for i in range(q0, q0 + h_loc)]


def _local_kv(k: torch.Tensor, cfg: ModelConfig, plan) -> torch.Tensor:
    """``(B, S, K, hd)`` K or V with all kv heads, cut to those this rank's
    query heads read (``_kv_read``)."""
    read = _kv_read(cfg, plan)
    if read is None:
        return k
    if isinstance(read, range):
        return k[:, :, read.start:read.stop]
    return k.index_select(2, torch.tensor(read, device=k.device))


def _head_input(x: torch.Tensor, plan) -> torch.Tensor:
    """The replicated input of a head-split projection (``copy_to``)."""
    if plan is not None and plan.q_heads:
        return C.copy_to(x, plan.q_heads.group)
    return x


def _gather_kv(k: torch.Tensor, plan, compress: bool) -> torch.Tensor:
    """A sequence-sharded K or V gathered whole along the sequence (the
    int8 wire where ``compress``)."""
    if compress:
        return C.int8_gather_along(k, 1, plan.seq.group)
    return C.gather_along(k, 1, plan.seq.group)


def _resharded(plan):
    """The ``tensor.Reshard`` of the query heads where their split shares
    axes with the residual's sequence split (then the block takes the whole
    sequence: Megatron's sequence parallelism), else ``None`` (each rank
    projects its block of the sequence and gathers K and V)."""
    if plan is None or not plan.seq \
            or not set(plan.q_heads.axes) & set(plan.seq.axes):
        return None
    return plan.reshard(plan.q_heads)


def _attend(p: Attention, x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, causal: bool, plan, compress: bool):
    """The core of ``attention`` and ``prefill_attention``: ``(y, k, v,
    reshard)``, ``y`` before ``reshard.leave`` (``None``: as the residual
    takes it), ``k`` and ``v`` the whole sequence's, this rank's kv
    heads."""
    r = _resharded(plan)
    offset = 0
    if r is not None:
        x = r.enter(x)
        positions = C.gather_dim(positions, 1, plan.seq.group)
    else:
        x = _head_input(x, plan)
    q, k, v = _project_qkv(p, x, positions, cfg, plan)
    if r is None and plan is not None and plan.seq:
        offset = plan.seq.index * q.shape[1]
        k = _gather_kv(k, plan, compress)
        v = _gather_kv(v, plan, compress)
    out = ops.flash_attention(q, _local_kv(k, cfg, plan),
                              _local_kv(v, cfg, plan), causal=causal,
                              q_offset=offset)
    return _out(p, out, cfg, plan, reduce=r is None), k, v, r


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, causal: bool = True,
              plan=None) -> torch.Tensor:
    """Full (train / prefill) attention. x: ``(B, S, D)``, under a ``plan``
    with a sequence-sharded residual this rank's block of the sequence
    (``positions`` its own)."""
    y, _, _, r = _attend(p, x, positions, cfg, causal, plan,
                         plan is not None and plan.kv_compress)
    return y if r is None else r.leave(y)


def _write_prefill(cache: torch.Tensor, kv: torch.Tensor,
                   cache_split) -> None:
    """Positions ``[0, S)`` of ``kv (B, S, K, hd)`` into the cache, or into
    this rank's block of it where ``cache_split`` splits the cache's
    sequence."""
    s = kv.shape[1]
    if cache_split is None or not cache_split:
        cache[:, :s] = kv
        return
    lo = cache_split.index * cache.shape[1]
    n = max(0, min(s - lo, cache.shape[1]))
    if n:
        cache[:, :n] = kv[:, lo:lo + n]


def prefill_attention(p: Attention, cache: tuple[torch.Tensor, torch.Tensor],
                      x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, plan=None, cache_split=None):
    """Process whole prompts and populate the KV cache. x: ``(B, S, D)``.

    Writes the prompt's K/V into positions ``[0, S)`` of the caches in
    place (the reference returns updated copies) and returns
    ``(y, cache)``. Under a ``plan`` x is this rank's block of the sequence
    where the residual is sequence-sharded, and the whole prompt's K and V
    (all kv heads; under ``kv_gather`` those the rank's query heads read)
    go into this rank's block of the cache where ``cache_split`` (a
    ``tensor.Split``) splits its sequence."""
    y, k, v, r = _attend(p, x, positions, cfg, True, plan, False)
    if plan is not None and plan.kv_heads:
        k = C.gather_dim(k, 2, plan.kv_heads.group)
        v = C.gather_dim(v, 2, plan.kv_heads.group)
    elif plan is not None and plan.kv_gather:
        k, v = _local_kv(k, cfg, plan), _local_kv(v, cfg, plan)
    k_cache, v_cache = cache
    _write_prefill(k_cache, k, cache_split)
    _write_prefill(v_cache, v, cache_split)
    return y if r is None else r.leave(y), (k_cache, v_cache)


# -- Decode path ---------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                  dtype=None, cache_split=None, plan=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(B, max_seq, K, hd)`` K and V caches; with ``cache_split``
    (a ``tensor.Split`` of ``cache_seq``) this rank's block of
    ``max_seq / n`` positions; under a ``plan`` with ``kv_gather`` the
    kv heads this rank's query heads read."""
    dtype = dtype or getattr(torch, cfg.dtype)
    if cache_split is not None and cache_split:
        max_seq = cache_split.block(max_seq)[1]
    kv = cfg.num_kv_heads
    if plan is not None and plan.kv_gather:
        kv = len(_kv_read(cfg, plan))
    shape = (batch, max_seq, kv, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p: Attention, cache: tuple[torch.Tensor, torch.Tensor],
                     x: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig, plan=None, cache_split=None):
    """One decode step. x: ``(B, 1, D)``; positions: ``(B,)`` current index.

    Writes the new K/V at ``positions`` of the caches in place, then
    attends each sequence's query over its cache prefix ``[0, pos]``
    (K5 with ``length = positions + 1``). Returns ``(y, cache)``.

    Under a ``plan`` the rank's query (and kv) heads are gathered whole
    over the head ranks (under ``kv_gather`` the rank keeps its query
    heads and the kv heads they read, as its cache does), and where
    ``cache_split`` splits the cache's sequence the rank writes the new
    K/V only where the position falls in its block, runs K5 on the block
    with its lengths and log-sum-exp, and the blocks' outputs are combined
    by the ranks' log-sum-exp: one max and one sum over the cache ranks. The rank's heads' share of the
    output projection is then summed over the head ranks."""
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode takes one token per sequence, got {one}")
    if plan is None and cache_split is None:
        # one rank: the cache written in place with no mask (a host-bound
        # decode step pays for every eager op a layer adds)
        q, k_new, v_new = _project_qkv(p, x, positions[:, None], cfg)
        k_cache, v_cache = cache
        rows, at = torch.arange(b, device=x.device), positions.long()
        k_cache[rows, at] = k_new[:, 0]
        v_cache[rows, at] = v_new[:, 0]
        length = (positions + 1).to(torch.int32)
        out = ops.decode_attention(q[:, 0], k_cache, v_cache, length)
        return _out(p, out[:, None], cfg), (k_cache, v_cache)
    q, k_new, v_new = _project_qkv(p, x, positions[:, None], cfg, plan)
    own = plan is not None and bool(plan.kv_gather)
    heads = plan.q_heads if plan is not None and not own else None
    if own:
        k_new = _local_kv(k_new, cfg, plan)
        v_new = _local_kv(v_new, cfg, plan)
    if heads:
        q = C.gather_dim(q, 2, heads.group)
    if plan is not None and plan.kv_heads:
        k_new = C.gather_dim(k_new, 2, plan.kv_heads.group)
        v_new = C.gather_dim(v_new, 2, plan.kv_heads.group)
    k_cache, v_cache = cache
    rows = torch.arange(b, device=x.device)
    split = cache_split if cache_split is not None and cache_split else None
    lo = split.index * k_cache.shape[1] if split is not None else 0
    local = positions.long() - lo
    inside = ((local >= 0) & (local < k_cache.shape[1]))[:, None, None]
    at = local.clamp(0, k_cache.shape[1] - 1)
    k_cache[rows, at] = torch.where(inside, k_new[:, 0], k_cache[rows, at])
    v_cache[rows, at] = torch.where(inside, v_new[:, 0], v_cache[rows, at])
    length = (positions + 1 - lo).clamp(0, k_cache.shape[1]).to(torch.int32)
    if split is None:
        out = ops.decode_attention(q[:, 0], k_cache, v_cache, length)
    else:
        part, lse = ops.decode_attention(q[:, 0], k_cache, v_cache, length,
                                         return_lse=True)
        out = _combine_by_lse(part, lse, split.group).to(q.dtype)
    if heads:
        lo_h, n_h = _q_block(cfg, plan)
        out = out[:, lo_h:lo_h + n_h]
    return _out(p, out[:, None], cfg, plan), (k_cache, v_cache)


def _combine_by_lse(part: torch.Tensor, lse: torch.Tensor,
                    group) -> torch.Tensor:
    """The softmax over the union of the ranks' key blocks from each
    rank's normalized output ``part (B, H, hd)`` and log-sum-exp ``lse
    (B, H)`` (``-inf`` for a rank whose block holds no key yet): fp32
    ``sum_r exp(lse_r - m) part_r / sum_r exp(lse_r - m)``, ``m`` the
    ranks' largest lse."""
    m = C.all_reduce_(lse.clone(), group, dist.ReduceOp.MAX)
    w = torch.exp(lse - m)                       # 0 where lse is -inf
    both = torch.cat([part.float() * w[..., None], w[..., None]], dim=-1)
    both = C.all_reduce_(both, group)
    return both[..., :-1] / both[..., -1:]
