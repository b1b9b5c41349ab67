"""Shared model layers: RMSNorm, embedding and tied unembedding, RoPE, and
the SwiGLU MLP (the port of ``repro/models/layers.py``).

Weights keep the reference's layouts (``(d, d_ff)`` projections, a
``(vocab_padded, d)`` table), so a reference parameter tree carries across
leaf for leaf (``repro_torch.models.convert``). Compute runs in the weights'
dtype with norm, activation and rotation in fp32, cast back, as in the
reference. The reference's sharding annotations (``logical_shard``) do
nothing on one device and are not carried over: under sharding rules that
split more than the batch, each function takes the rank's
``repro_torch.parallel.tensor.TensorPlan`` (``plan``) and makes the
collectives GSPMD placed in the reference (``vocab`` and ``mlp`` splits,
the sequence-sharded residual, ZeRO-3's gathers).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.parallel import collectives as C

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


def embed(emb: Embedding, tokens: torch.Tensor, plan=None) -> torch.Tensor:
    """The tokens' rows of the table. Under a ``plan`` that splits the
    vocab, this rank's shard gives its own ids' rows and zeros for the
    rest: a partial sum over ``plan.vocab`` that the caller reduces
    (``residual_from_partial``)."""
    if plan is None:
        return emb.table[tokens.long()]
    table = plan.weight(emb, "table")
    if not plan.vocab:
        return table[tokens.long()]
    lo, n = plan.vocab.block(table.shape[0] * plan.vocab.n)
    local = tokens.long() - lo
    inside = (local >= 0) & (local < n)
    return table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)


def residual_from_partial(h: torch.Tensor, plan) -> torch.Tensor:
    """``(B, S, D)`` embeddings, a partial sum over ``plan.vocab`` where it
    is split, as the residual stream the layers take: summed over the vocab
    ranks, and this rank's block of the sequence where the residual is
    sequence-sharded (``tensor.Reshard.leave``: one reduce-scatter where
    the vocab and the sequence are split over the same axes, whose
    backward gives every vocab rank the whole sequence's gradient)."""
    return plan.reshard(plan.vocab).leave(h)


def unembed_table(emb: Embedding, plan=None) -> torch.Tensor:
    """``(D, V)``: the tied table's transpose or the untied unembedding
    (under a ``plan``, this rank's vocab columns, ``w_embed`` gathered)."""
    if emb.unembed is None:
        table = emb.table if plan is None else plan.weight(emb, "table")
        return table.T
    return emb.unembed if plan is None else plan.weight(emb, "unembed")


def unembed(emb: Embedding, x: torch.Tensor, true_vocab: int, plan=None):
    """Logits over the padded vocab in the weights' dtype; the padded
    columns read -1e9 (the caller casts to fp32, as the reference does).
    Under a ``plan`` ``x`` is replicated over the vocab ranks, each
    computes its vocab columns, and the logits are gathered whole (fp32,
    with no gradient: serving's and ``forward``'s)."""
    table = unembed_table(emb, plan)
    logits = x @ table
    if plan is not None and plan.vocab:
        logits = C.gather_dim(logits.float(), -1, plan.vocab.group)
    if logits.shape[-1] != true_vocab:
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


def _swiglu(x, gate_w, up_w, down_w):
    gate = x @ gate_w
    up = x @ up_w
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return hidden @ down_w


def mlp(m: MLP, x: torch.Tensor, plan=None) -> torch.Tensor:
    """The SwiGLU FFN. Under a ``plan`` that splits ``mlp``, ``gate`` and
    ``up`` are column shards and ``down`` a row shard: the input is
    replicated over the mlp ranks (``copy_to``) or, from a
    sequence-sharded residual, gathered along the sequence over the axes
    the mlp split shares with it, and the partial outputs are summed
    (``reduce_from``) or reduce-scattered back to the sequence blocks
    (``tensor.Reshard``'s ``enter`` and ``leave``, ``local``: the FFN
    works position by position). Otherwise (``mlp_seq`` among them) every
    rank runs the whole FFN on its own positions."""
    if plan is None:
        return _swiglu(x, m.gate, m.up, m.down)
    weights = [plan.weight(m, leaf) for leaf in ("gate", "up", "down")]
    if not plan.mlp:
        return _swiglu(x, *weights)
    r = plan.reshard(plan.mlp)
    return r.leave(_swiglu(r.enter(x, local=True), *weights), local=True)
