"""Grouped-query attention (the port of ``repro/models/attention.py``).

The attention cores go through the port's kernel dispatch point
(``repro_torch.kernels.ops``): the full and prefill paths through K4
(``flash_attention``, on the K kv heads, which it groups itself as the
reference's ``jnp.repeat`` does), the decode path through K5
(``decode_attention``, on the ``(B, S, K, hd)`` cache in place).
On the card those are the CUDA kernels; on CPU tensors their plain
versions.

Under data parallelism each rank runs this path on its rows. The
reference's tensor-parallel attention (head_tp / seq_tp, the int8 KV
broadcast of ``_int8_broadcast``) needs a ``model`` axis larger than 1 and
is ROADMAP Queue 1 item 11.4b.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, init_normal


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


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, hd, d = p.wo.shape
    return out.flatten(-2) @ p.wo.reshape(h * hd, d)


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, causal: bool = True) -> torch.Tensor:
    """Full (train / prefill) attention. x: ``(B, S, D)``."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    out = ops.flash_attention(q, k, v, causal=causal)
    return _out(p, out)


def prefill_attention(p: Attention, cache: tuple[torch.Tensor, torch.Tensor],
                      x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig):
    """Process whole prompts and populate the KV cache. x: ``(B, S, D)``.

    Writes the prompt's K/V into positions ``[0, S)`` of the caches in
    place (the reference returns updated copies) and returns
    ``(y, cache)``."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, positions, cfg)
    k_cache, v_cache = cache
    k_cache[:, :s] = k
    v_cache[:, :s] = v
    out = ops.flash_attention(q, k, v, causal=True)
    return _out(p, out), (k_cache, v_cache)


# -- Decode path ---------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                  dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p: Attention, cache: tuple[torch.Tensor, torch.Tensor],
                     x: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig):
    """One decode step. x: ``(B, 1, D)``; positions: ``(B,)`` current index.

    Writes the new K/V at ``positions`` of the caches in place, then
    attends each sequence's query over its cache prefix ``[0, pos]``
    (K5 with ``length = positions + 1``). Returns ``(y, cache)``."""
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode takes one token per sequence, got {one}")
    q, k_new, v_new = _project_qkv(p, x, positions[:, None], cfg)
    k_cache, v_cache = cache
    rows, at = torch.arange(b, device=x.device), positions.long()
    k_cache[rows, at] = k_new[:, 0]
    v_cache[rows, at] = v_new[:, 0]
    length = (positions + 1).to(torch.int32)
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, length)
    return _out(p, out[:, None]), (k_cache, v_cache)
