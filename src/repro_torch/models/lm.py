"""The language model of the port (``repro/models/lm.py``): a stack of
attention, Mamba, mLSTM and sLSTM blocks with dense SwiGLU, MoE or no FFNs,
behind a token, vision-stub or audio-stub frontend, with its full forward,
its prompt prefill and its one-token decode step.

The reference stacks each pattern position's weights over the repeats and
scans over them; the port keeps one module per layer and loops (PyTorch
runs eagerly, so there is no program size to keep small). The decode state
is one entry per layer, by its kind: the ``(B, max_seq, K, hd)`` K and V
caches of an attention layer (prefill and decode write them in place),
``{h, conv}`` of a Mamba layer, ``{c, n, m, conv}`` of an mLSTM layer and
``{c, n, h, m, conv}`` of an sLSTM layer (replaced at every call), plus the
``(B,)`` int32 positions.

Parameters are built frozen (no gradient); ``repro_torch.training``'s
``init_train_state`` turns their gradients on. ``forward_hidden`` is the
training entry point: the forward up to the final norm, each layer under
the remat policy asked for.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.config import BlockKind, FFNKind, Frontend, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    MLP,
    Embedding,
    RMSNorm,
    embed,
    init_normal,
    mlp,
    rmsnorm,
    unembed,
)
from repro_torch.parallel.sharding import batch_group

AUDIO_FRAME_DIM = 128   # EnCodec latent dim (stub frontend)

_BLOCK_INIT = {
    BlockKind.ATTENTION: attn_mod.init_attention,
    BlockKind.MAMBA: ssm_mod.init_mamba,
    BlockKind.MLSTM: xlstm_mod.init_mlstm,
    BlockKind.SLSTM: xlstm_mod.init_slstm,
}


class Block(nn.Module):
    """One residual layer: ``norm1`` and the ``block`` of the layer's kind,
    then, unless ``cfg.ffn`` is ``none``, ``norm2`` and the ``ffn`` (an
    ``MoE`` where ``cfg.layer_is_moe(layer)``, else the dense SwiGLU),
    named as in the reference's parameter tree."""

    def __init__(self, cfg: ModelConfig, layer: int, generator, device):
        super().__init__()
        self.kind = cfg.block_kind(layer)
        dtype = getattr(torch, cfg.dtype)
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.block = _BLOCK_INIT[self.kind](cfg, generator, device)
        if cfg.ffn != FFNKind.NONE:
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            self.ffn = moe_mod.MoE(cfg, generator, device) \
                if cfg.layer_is_moe(layer) \
                else MLP(cfg.d_model, cfg.d_ff, dtype, generator, device)


class LM(nn.Module):
    """``embed``, ``final_norm``, the stub frontend's projection
    (``patch_proj (d, d)`` or ``frame_proj (AUDIO_FRAME_DIM, d)``) and the
    ``layers``."""

    AXES = {"patch_proj": ("w_embed", None), "frame_proj": (None, "w_embed")}

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.embed = Embedding(cfg.vocab_size, d, dtype, generator,
                               device, tie=cfg.tie_embeddings)
        self.final_norm = RMSNorm(d, dtype, device)
        if cfg.frontend == Frontend.VISION_STUB.value:
            self.patch_proj = init_normal((d, d), d ** -0.5, dtype,
                                          generator, device)
        elif cfg.frontend == Frontend.AUDIO_STUB.value:
            self.frame_proj = init_normal((AUDIO_FRAME_DIM, d),
                                          AUDIO_FRAME_DIM ** -0.5, dtype,
                                          generator, device)
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


def _frontend_embed(model: LM, inputs: dict) -> torch.Tensor:
    """The token embeddings, with the vision stub's projected patches put
    before them, or the audio stub's projected frames added at every
    position."""
    h = embed(model.embed, inputs["tokens"])
    if model.cfg.frontend == Frontend.VISION_STUB.value:
        patches = inputs["patch_embeds"].to(h.dtype) @ model.patch_proj
        h = torch.cat([patches, h], dim=1)
    elif model.cfg.frontend == Frontend.AUDIO_STUB.value:
        h = h + inputs["frame_embeds"].to(h.dtype) @ model.frame_proj
    return h


def _ffn(layer: Block, h: torch.Tensor, cfg: ModelConfig):
    """The layer's FFN residual update of ``h`` and its MoE load-balance
    statistics (``moe.moe_parts``; ``None`` for a dense FFN or none)."""
    if not hasattr(layer, "ffn"):
        return h, None
    normed = rmsnorm(layer.norm2, h, cfg.norm_eps)
    if isinstance(layer.ffn, moe_mod.MoE):
        out, stats = moe_mod.moe_parts(layer.ffn, normed, cfg)
        return h + out, stats
    return h + mlp(layer.ffn, normed), None


_RECURRENT = {
    BlockKind.MAMBA: ssm_mod.mamba,
    BlockKind.MLSTM: xlstm_mod.mlstm,
    BlockKind.SLSTM: xlstm_mod.slstm,
}


def _layer(layer: Block, h: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, ssm_chunk: int):
    """One residual layer (block, then FFN): ``(h, MoE statistics or
    None)``."""
    normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
    if layer.kind == BlockKind.ATTENTION:
        out = attn_mod.attention(layer.block, normed, positions, cfg)
    else:
        out = _RECURRENT[layer.kind](layer.block, normed, cfg,
                                     chunk=ssm_chunk)
    return _ffn(layer, h + out, cfg)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matrix products' outputs, recompute the
    rest (the reference's ``checkpoint_dots_with_no_batch_dims``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT = {
    "block": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)},
}


def forward_hidden(model: LM, inputs: dict, remat: str = "block",
                   q_chunk: int = 1024, ssm_chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward up to the final norm: ``(h (B, S', D), aux)``,
    ``S'`` counting the stub patches, ``aux`` the MoE load-balance loss
    summed over the MoE layers (0 without them; under rules that split the
    batch over ranks, each layer's the whole batch's: ``moe.aux_loss``,
    outside the layer's checkpoint). The unembedding is left to the
    caller: the training loss fuses it into a sequence-chunked
    cross-entropy.

    ``remat``: ``"none"`` keeps every activation for the backward;
    ``"block"`` checkpoints each layer (its input kept, the rest recomputed
    in the backward; the reference checkpoints a pattern period, which
    computes the same); ``"dots"`` checkpoints each layer but keeps its
    matrix products. Under a recompute every attention layer runs K4
    again, and every MoE layer's dispatch K2. ``q_chunk`` is accepted and
    unused: K4 tiles its own queries. ``ssm_chunk`` is the Mamba and mLSTM
    chunk."""
    if remat != "none" and remat not in _REMAT:
        raise ValueError(f"remat must be none, block or dots, got {remat!r}")
    cfg = model.cfg
    h = _frontend_embed(model, inputs)
    b, s, _ = h.shape
    positions = inputs.get("positions")
    if positions is None:
        positions = _positions(b, s, h.device)
    group = batch_group()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in model.layers:
        if remat == "none":
            h, stats = _layer(layer, h, positions, cfg, ssm_chunk)
        else:
            h, stats = checkpoint(_layer, layer, h, positions, cfg,
                                  ssm_chunk, use_reentrant=False,
                                  **_REMAT[remat])
        if stats is not None:
            aux = aux + moe_mod.aux_loss(stats, cfg, group)
    return rmsnorm(model.final_norm, h, cfg.norm_eps), aux


def forward(model: LM, inputs: dict, ssm_chunk: int = 128
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward: ``inputs["tokens"] (B, S)`` (with the stub
    frontend's ``patch_embeds`` or ``frame_embeds``, and optionally
    ``positions``) -> ``(fp32 logits (B, S', V_padded), aux)``:
    ``forward_hidden`` without remat, and the unembedding. Every attention
    layer runs K4, and every MoE layer's dispatch K2."""
    h, aux = forward_hidden(model, inputs, remat="none", ssm_chunk=ssm_chunk)
    logits = unembed(model.embed, h, model.cfg.vocab_size).float()
    return logits, aux


_INIT_STATE = {
    BlockKind.MAMBA: ssm_mod.init_mamba_state,
    BlockKind.MLSTM: xlstm_mod.init_mlstm_state,
    BlockKind.SLSTM: xlstm_mod.init_slstm_state,
}


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    """Each layer's zeroed state for ``batch`` sequences (K/V caches of
    ``max_seq`` positions for attention, the recurrent state otherwise)
    and the positions."""
    layers = []
    for i in range(cfg.num_layers):
        kind = cfg.block_kind(i)
        if kind == BlockKind.ATTENTION:
            k, v = attn_mod.init_kv_cache(cfg, batch, max_seq, device)
            layers.append({"k": k, "v": v})
        else:
            layers.append(_INIT_STATE[kind](cfg, batch, device))
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill_step(model: LM, state: dict, inputs: dict, ssm_chunk: int = 128):
    """Process whole prompts (``forward``'s inputs) at positions
    ``[0, S')``, fill every layer's state, and return ``(fp32 logits of the
    last position (B, 1, V_padded), state)`` with every row at position
    ``S'``. ``ssm_chunk`` is the Mamba chunk; the mLSTM keeps its own 256,
    as in the reference. Every attention layer runs K4, and every MoE
    layer's dispatch K2."""
    cfg = model.cfg
    h = _frontend_embed(model, inputs)
    b, s, _ = h.shape
    positions = _positions(b, s, h.device)
    layers = []
    for layer, st in zip(model.layers, state["layers"]):
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        if layer.kind == BlockKind.ATTENTION:
            out, _ = attn_mod.prefill_attention(
                layer.block, (st["k"], st["v"]), normed, positions, cfg)
        elif layer.kind == BlockKind.MAMBA:
            out, st = ssm_mod.mamba(layer.block, normed, cfg,
                                    chunk=ssm_chunk, return_state=True)
        else:
            out, st = _RECURRENT[layer.kind](layer.block, normed, cfg,
                                             return_state=True)
        layers.append(st)
        h, _ = _ffn(layer, h + out, cfg)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, h[:, -1:], cfg.vocab_size).float()
    return logits, {"layers": layers,
                    "pos": torch.full((b,), s, dtype=torch.int32,
                                      device=h.device)}


_STEP = {
    BlockKind.MAMBA: ssm_mod.mamba_step,
    BlockKind.MLSTM: xlstm_mod.mlstm_step,
    BlockKind.SLSTM: xlstm_mod.slstm_step,
}


def decode_step(model: LM, state: dict, tokens: torch.Tensor):
    """One token for every sequence: ``tokens (B, 1)`` at ``state["pos"]``
    -> ``(fp32 logits (B, 1, V_padded), state)`` with the positions
    advanced by one (no stub-frontend input, as in the reference). Every
    attention layer runs K5 on its cache, and every MoE layer's dispatch
    K2."""
    cfg = model.cfg
    h = embed(model.embed, tokens)
    positions = state["pos"]
    layers = []
    for layer, st in zip(model.layers, state["layers"]):
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        if layer.kind == BlockKind.ATTENTION:
            out, _ = attn_mod.decode_attention(
                layer.block, (st["k"], st["v"]), normed, positions, cfg)
        else:
            out, st = _STEP[layer.kind](layer.block, st, normed, cfg)
        layers.append(st)
        h, _ = _ffn(layer, h + out, cfg)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, h, cfg.vocab_size).float()
    return logits, {"layers": layers, "pos": positions + 1}
