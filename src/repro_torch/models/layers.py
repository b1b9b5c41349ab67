"""Shared model layers: RMSNorm, embedding and tied unembedding, RoPE, and
the SwiGLU MLP (the port of ``repro/models/layers.py``).

Weights keep the reference's layouts (``(d, d_ff)`` projections, a
``(vocab_padded, d)`` table), so a reference parameter tree carries across
leaf for leaf (``repro_torch.models.convert``). Compute runs in the weights'
dtype with norm, activation and rotation in fp32, cast back, as in the
reference. The reference's sharding annotations (``logical_shard``) do
nothing on one device and are not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

VOCAB_PAD = 128  # vocab padded to a multiple of this, as in the reference


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that asks for no gradient (the port is inference-only)."""
    return nn.Parameter(t, requires_grad=False)


def init_normal(shape, scale: float, dtype, generator, device) -> nn.Parameter:
    """``normal * scale`` drawn in fp32, then cast: the reference's
    ``_init`` (from a torch generator, so not the reference's numbers)."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return frozen(w.to(dtype))


# -- RMSNorm -----------------------------------------------------------------


class RMSNorm(nn.Module):
    AXES = {"scale": ("embed",)}

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype,
                                             device=device),
                                  requires_grad=False)


def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * norm.scale.float()).to(x.dtype)


# -- Embedding / unembedding ---------------------------------------------------


class Embedding(nn.Module):
    """``table (vocab_padded, d)``, plus ``unembed (d, vocab_padded)`` when
    the embeddings are not tied."""

    AXES = {"table": ("vocab", "w_embed"), "unembed": ("w_embed", "vocab")}

    def __init__(self, vocab: int, d: int, dtype, generator, device,
                 tie: bool = False):
        super().__init__()
        vpad = pad_to_multiple(vocab, VOCAB_PAD)
        self.table = init_normal((vpad, d), d ** -0.5, dtype, generator,
                                 device)
        self.unembed = None if tie else init_normal(
            (d, vpad), d ** -0.5, dtype, generator, device)


def embed(emb: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return emb.table[tokens.long()]


def unembed(emb: Embedding, x: torch.Tensor, true_vocab: int):
    """Logits over the padded vocab in the weights' dtype; the padded
    columns read -1e9 (the caller casts to fp32, as the reference does)."""
    table = emb.table.T if emb.unembed is None else emb.unembed
    logits = x @ table
    if table.shape[-1] != true_vocab:
        logits = logits.float()
        logits[..., true_vocab:] = -1e9
    return logits


# -- Rotary position embeddings ------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Computed in float64 numpy, then cast to float32, as the reference."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    return torch.as_tensor((1.0 / (theta ** exponents)).astype(np.float32),
                           device=device)


@functools.cache
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` made once per (head_dim, theta, device): a
    fresh host-to-device copy in every layer of every step would block the
    host until the device queue drained. Callers only read it."""
    return rope_frequencies(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``(..., seq, heads, head_dim)``; positions broadcastable to
    ``(..., seq)``. Rotates the concatenated halves (not interleaved
    pairs)."""
    freqs = _rope_table(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., s, hd/2)
    sin = torch.sin(angles)[..., None, :]                  # (..., s, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


# -- SwiGLU MLP ----------------------------------------------------------------


class MLP(nn.Module):
    AXES = {"gate": ("w_embed", "mlp"), "up": ("w_embed", "mlp"),
            "down": ("mlp", "w_embed")}

    def __init__(self, d: int, d_ff: int, dtype, generator, device):
        super().__init__()
        self.gate = init_normal((d, d_ff), d ** -0.5, dtype, generator,
                                device)
        self.up = init_normal((d, d_ff), d ** -0.5, dtype, generator, device)
        self.down = init_normal((d_ff, d), d_ff ** -0.5, dtype, generator,
                                device)


def mlp(m: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = x @ m.gate
    up = x @ m.up
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return hidden @ m.down
