"""The language model of the port (``repro/models/lm.py``): a stack of
attention blocks with dense SwiGLU or MoE FFNs, with its full forward, its
prompt prefill and its one-token decode step.

The reference stacks each pattern position's weights over the repeats and
scans over them; the port keeps one module per layer and loops (PyTorch
runs eagerly, so there is no program size to keep small). The decode state
is one ``(B, max_seq, K, hd)`` K and V cache per layer plus the ``(B,)``
int32 positions; prefill and decode write the caches in place.

The blocks the port does not have yet raise ``NotImplementedError`` when a
model is built: Mamba, mLSTM and sLSTM blocks and the vision and audio stub
frontends all wait for ROADMAP Queue 1 item 11. The modules are
inference-only until ``training/`` is ported (no parameter asks for
gradients).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import BlockKind, FFNKind, Frontend, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    MLP,
    Embedding,
    RMSNorm,
    embed,
    mlp,
    rmsnorm,
    unembed,
)

_LATER = "is not ported yet (ROADMAP Queue 1 item 11)"


class Block(nn.Module):
    """One residual layer: ``norm1``, the attention ``block``, ``norm2`` and
    the ``ffn`` (an ``MoE`` where ``cfg.layer_is_moe(layer)``, else the
    dense SwiGLU), named as in the reference's parameter tree."""

    def __init__(self, cfg: ModelConfig, layer: int, generator, device):
        super().__init__()
        kind = cfg.block_kind(layer)
        if kind != BlockKind.ATTENTION:
            raise NotImplementedError(f"the {kind.value} block {_LATER}")
        if cfg.ffn not in (FFNKind.DENSE, FFNKind.MOE):
            raise NotImplementedError(f"the {cfg.ffn.value!r} FFN {_LATER}")
        dtype = getattr(torch, cfg.dtype)
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.block = attn_mod.init_attention(cfg, generator, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        self.ffn = moe_mod.MoE(cfg, generator, device) \
            if cfg.layer_is_moe(layer) \
            else MLP(cfg.d_model, cfg.d_ff, dtype, generator, device)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        if cfg.frontend != Frontend.TOKENS.value:
            raise NotImplementedError(f"the {cfg.frontend!r} frontend "
                                      f"{_LATER}")
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, generator,
                               device, tie=cfg.tie_embeddings)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, i, generator, device) for i in range(cfg.num_layers))


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None) -> LM:
    """A randomly initialized model on ``device`` (the card unless the
    caller passes ``"cpu"``), drawn from ``generator`` (a generator on that
    device seeded with 0 by default). Same scales as the reference's
    ``init_lm``, other numbers: weights that must equal the reference's are
    carried across by ``repro_torch.models.convert.params_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return LM(cfg, generator, dev)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _ffn(layer: Block, h: torch.Tensor, cfg: ModelConfig):
    """The layer's FFN residual update of ``h`` and its MoE aux loss
    (``None`` for a dense FFN)."""
    normed = rmsnorm(layer.norm2, h, cfg.norm_eps)
    if isinstance(layer.ffn, moe_mod.MoE):
        out, aux = moe_mod.moe(layer.ffn, normed, cfg)
        return h + out, aux
    return h + mlp(layer.ffn, normed), None


def forward(model: LM, inputs: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward: ``inputs["tokens"] (B, S)`` (and optionally
    ``inputs["positions"]``) -> ``(fp32 logits (B, S, V_padded), aux)``,
    ``aux`` the reference's MoE load-balance loss summed over the MoE
    layers (0 without them). Every layer's attention runs K4, and every MoE
    layer's dispatch K2."""
    cfg = model.cfg
    h = embed(model.embed, inputs["tokens"])
    b, s, _ = h.shape
    positions = inputs.get("positions")
    if positions is None:
        positions = _positions(b, s, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in model.layers:
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        h = h + attn_mod.attention(layer.block, normed, positions, cfg)
        h, layer_aux = _ffn(layer, h, cfg)
        if layer_aux is not None:
            aux = aux + layer_aux
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, h, cfg.vocab_size).float()
    return logits, aux


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    """Zeroed per-layer KV caches and positions for ``batch`` sequences."""
    layers = []
    for _ in range(cfg.num_layers):
        k, v = attn_mod.init_kv_cache(cfg, batch, max_seq, device)
        layers.append({"k": k, "v": v})
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill_step(model: LM, state: dict, inputs: dict):
    """Process whole prompts ``inputs["tokens"] (B, S)`` at positions
    ``[0, S)``, fill every layer's cache, and return ``(fp32 logits of the
    last position (B, 1, V_padded), state)`` with every row at position S.
    Every layer's attention runs K4, and every MoE layer's dispatch K2."""
    cfg = model.cfg
    h = embed(model.embed, inputs["tokens"])
    b, s, _ = h.shape
    positions = _positions(b, s, h.device)
    for layer, st in zip(model.layers, state["layers"]):
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        out, _ = attn_mod.prefill_attention(
            layer.block, (st["k"], st["v"]), normed, positions, cfg)
        h, _ = _ffn(layer, h + out, cfg)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, h[:, -1:], cfg.vocab_size).float()
    return logits, {"layers": state["layers"],
                    "pos": torch.full((b,), s, dtype=torch.int32,
                                      device=h.device)}


def decode_step(model: LM, state: dict, tokens: torch.Tensor):
    """One token for every sequence: ``tokens (B, 1)`` at ``state["pos"]``
    -> ``(fp32 logits (B, 1, V_padded), state)`` with the positions
    advanced by one. Every layer's attention runs K5 on its cache, and
    every MoE layer's dispatch K2."""
    cfg = model.cfg
    h = embed(model.embed, tokens)
    positions = state["pos"]
    for layer, st in zip(model.layers, state["layers"]):
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        out, _ = attn_mod.decode_attention(
            layer.block, (st["k"], st["v"]), normed, positions, cfg)
        h, _ = _ffn(layer, h + out, cfg)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, h, cfg.vocab_size).float()
    return logits, {"layers": state["layers"], "pos": positions + 1}
