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

Under sharding rules (``use_rules``) that split more than the batch, a
rank's model holds its shards (``convert.shard_params``) and every entry
point runs on ``repro_torch.parallel.tensor.TensorPlan`` of the rules,
resolved once a call and handed to each layer (so a layer recomputed in
the backward makes the same collectives): attention, Mamba, mLSTM and
sLSTM blocks, dense and MoE FFNs. Under ``seq_tp`` the residual between
the layers is this rank's block of the sequence. ``forward``,
``prefill_step`` and ``decode_step`` return the whole logits on every
rank and do not split the batch (a ``data`` axis repeats the work; the
reference's serving engine takes no rules, and neither does the port's).
A decode state made under rules that split ``cache_seq`` keeps each
layer's block of the cache and records the split in
``state["cache_axes"]``; one made under rules that split ``inner`` keeps
each recurrent layer's block of its state (``ssm.init_mamba_state``,
``xlstm.init_mlstm_state``, ``xlstm.init_slstm_state``) and records the
split in ``state["inner_axes"]``. ``prefill_step`` (under any rules on
the same mesh) fills those blocks: a recurrent state computed under
another inner split is gathered and cut to the state's.
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
    residual_from_partial,
    rmsnorm,
    unembed,
)
from repro_torch.parallel.collectives import gather_along, gather_dim
from repro_torch.parallel.sharding import batch_group, current_rules
from repro_torch.parallel.tensor import Split, tensor_plan

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


def _frontend_embed(model: LM, inputs: dict, plan=None) -> torch.Tensor:
    """The token embeddings, with the vision stub's projected patches put
    before them, or the audio stub's projected frames added at every
    position. Under a ``plan`` the token embeddings are a partial sum over
    the vocab ranks until ``residual_from_partial``; the stub's
    projection, the same on every rank, joins the residual after it (the
    rank's block of the sequence)."""
    h = embed(model.embed, inputs["tokens"], plan)
    frontend = model.cfg.frontend
    extra = None
    if frontend in (Frontend.VISION_STUB.value, Frontend.AUDIO_STUB.value):
        vision = frontend == Frontend.VISION_STUB.value
        name = "patch_proj" if vision else "frame_proj"
        w = getattr(model, name) if plan is None \
            else plan.weight(model, name)
        x = inputs["patch_embeds" if vision else "frame_embeds"]
        extra = x.to(h.dtype) @ w
        if plan is None:
            return torch.cat([extra, h], dim=1) if vision else h + extra
        if vision:
            zeros = torch.zeros_like(h)
            h = torch.cat([torch.zeros_like(extra), h], dim=1)
            extra = torch.cat([extra, zeros], dim=1)
    if plan is None:
        return h
    h = residual_from_partial(h, plan)
    return h if extra is None else h + plan.seq_block(extra)


def _ffn(layer: Block, h: torch.Tensor, cfg: ModelConfig, plan=None):
    """The layer's FFN residual update of ``h`` and its MoE load-balance
    statistics (``moe.moe_parts``; ``None`` for a dense FFN or none)."""
    if not hasattr(layer, "ffn"):
        return h, None
    normed = rmsnorm(layer.norm2, h, cfg.norm_eps)
    if isinstance(layer.ffn, moe_mod.MoE):
        out, stats = moe_mod.moe_parts(layer.ffn, normed, cfg, plan=plan)
        return h + out, stats
    return h + mlp(layer.ffn, normed, plan), None


_RECURRENT = {
    BlockKind.MAMBA: ssm_mod.mamba,
    BlockKind.MLSTM: xlstm_mod.mlstm,
    BlockKind.SLSTM: xlstm_mod.slstm,
}


def _layer(layer: Block, h: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, ssm_chunk: int, plan=None):
    """One residual layer (block, then FFN): ``(h, MoE statistics or
    None)``."""
    normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
    if layer.kind == BlockKind.ATTENTION:
        out = attn_mod.attention(layer.block, normed, positions, cfg,
                                 plan=plan)
    else:
        out = _RECURRENT[layer.kind](layer.block, normed, cfg,
                                     chunk=ssm_chunk, plan=plan)
    return _ffn(layer, h + out, cfg, plan)


def plan_for(cfg: ModelConfig, plan=None):
    """The call's ``TensorPlan`` (``plan``, else the current rules'), or
    ``None``."""
    return tensor_plan(current_rules()) if plan is None else plan


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
                   q_chunk: int = 1024, ssm_chunk: int = 128, plan=None
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
    chunk. ``plan`` (the current rules' ``TensorPlan`` by default) gives
    ``h`` as this rank's block of the sequence under ``seq_tp``."""
    if remat != "none" and remat not in _REMAT:
        raise ValueError(f"remat must be none, block or dots, got {remat!r}")
    cfg = model.cfg
    plan = plan_for(cfg, plan)
    h = _frontend_embed(model, inputs, plan)
    b = h.shape[0]
    positions = inputs.get("positions")
    if positions is None:
        s = h.shape[1] * (plan.seq.n if plan is not None else 1)
        positions = _positions(b, s, h.device)
    if plan is not None:
        positions = plan.local_positions(positions)
    group = batch_group() if plan is None else plan.stats.group
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in model.layers:
        if remat == "none":
            h, stats = _layer(layer, h, positions, cfg, ssm_chunk, plan)
        else:
            h, stats = checkpoint(_layer, layer, h, positions, cfg,
                                  ssm_chunk, plan, use_reentrant=False,
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
    plan = plan_for(model.cfg)
    h, aux = forward_hidden(model, inputs, remat="none", ssm_chunk=ssm_chunk,
                            plan=plan)
    if plan is not None and plan.seq:
        h = gather_along(h, 1, plan.seq.group)
    logits = unembed(model.embed, h, model.cfg.vocab_size, plan).float()
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
    and the positions. Under rules that split ``cache_seq`` each cache is
    this rank's block of the positions, and ``state["cache_axes"]`` names
    the mesh axes of the split; under rules that split ``inner`` each
    recurrent state is this rank's block, ``state["inner_axes"]`` the
    split's axes."""
    plan = plan_for(cfg)
    split = plan.cache if plan is not None and plan.cache else None
    layers, recurrent = [], False
    for i in range(cfg.num_layers):
        kind = cfg.block_kind(i)
        if kind == BlockKind.ATTENTION:
            k, v = attn_mod.init_kv_cache(cfg, batch, max_seq, device,
                                          cache_split=split, plan=plan)
            layers.append({"k": k, "v": v})
        else:
            recurrent = True
            layers.append(_INIT_STATE[kind](cfg, batch, device, plan))
    state = {"layers": layers,
             "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if split is not None:
        state["cache_axes"] = split.axes
    if recurrent and plan is not None and plan.inner:
        state["inner_axes"] = plan.inner.axes
    return state


def _cache_split(state: dict, plan):
    """The ``Split`` the state's caches were made under, or ``None``."""
    axes = state.get("cache_axes")
    if axes is None:
        return None
    if plan is None:
        raise ValueError(f"a cache split over {axes} needs the rules of its "
                         f"mesh (use_rules)")
    return Split(plan.mesh, axes)


def _inner_split(state: dict, plan):
    """The inner ``Split`` the state's recurrent blocks were made under, or
    ``None``."""
    axes = state.get("inner_axes")
    if axes is None:
        return None
    if plan is None:
        raise ValueError(f"an inner split over {axes} needs the rules of its "
                         f"mesh (use_rules)")
    return Split(plan.mesh, axes)


# each recurrent state's tensors split along ``inner``, by the dimension
# (``"values"``: the mLSTM memory's ``(heads, dk, dv)`` value block)
_INNER_DIMS = {BlockKind.MAMBA: {"h": 1, "conv": 2},
               BlockKind.MLSTM: {"c": "values", "conv": 2},
               BlockKind.SLSTM: {"conv": 2}}


def _relayout(kind, st: dict, cfg: ModelConfig, src, dst) -> dict:
    """A recurrent layer's state computed under the inner split ``src``
    as the inner split ``dst`` holds it (each a ``Split`` or ``None``):
    gathered whole over ``src`` and cut to ``dst``'s block."""
    if (src.axes if src else ()) == (dst.axes if dst else ()):
        return st
    out = dict(st)
    for key, dim in _INNER_DIMS[kind].items():
        t = st[key]
        if dim == "values":                # (B, heads, dk, dv) features
            t = t.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], -1)
            full = gather_dim(t.contiguous(), 2, src.group) if src else t
            vals = xlstm_mod.values_of(cfg, dst)
            mine = full[..., vals.lo:vals.lo + vals.n]
            out[key] = mine.unflatten(2, (vals.heads, vals.dv)) \
                .permute(0, 2, 1, 3).contiguous()
            continue
        full = gather_dim(t.contiguous(), dim, src.group) if src else t
        lo, n = dst.block(full.shape[dim]) if dst else (0, full.shape[dim])
        out[key] = full.narrow(dim, lo, n).contiguous()
    return out


def _last_row(h: torch.Tensor, plan) -> torch.Tensor:
    """``h[:, -1:]`` of the whole sequence, on every rank (from the last
    sequence rank where the residual is sequence-sharded)."""
    last = h[:, -1:]
    if plan is None or not plan.seq:
        return last
    return gather_dim(last, 1, plan.seq.group)[:, -1:]


def prefill_step(model: LM, state: dict, inputs: dict, ssm_chunk: int = 128,
                 lengths: torch.Tensor | None = None):
    """Process whole prompts (``forward``'s inputs) at positions
    ``[0, S')``, fill every layer's state, and return ``(fp32 logits of the
    last position (B, 1, V_padded), state)`` with every row at position
    ``S'``. ``ssm_chunk`` is the Mamba chunk; the mLSTM keeps its own 256,
    as in the reference. Every attention layer runs K4, and every MoE
    layer's dispatch K2.

    ``lengths`` (``(B,)``, or ``None``): each row's real length in a batch
    of prompts padded to ``S'`` (the serving engine's). Each recurrent
    block (Mamba, mLSTM, sLSTM) then leaves row ``b``'s state unchanged at
    every position from ``lengths[b] - 1`` on (the blocks' ``stop``), and
    the row is left at position ``lengths[b] - 1`` (0 for an empty row):
    the decode step that follows feeds the row's last real token once,
    which rewrites an attention layer's cache slot there and steps a
    recurrent state that has taken in exactly the tokens before it. The
    returned logits are then those of position ``S' - 1``, not the rows'.
    A recurrent block sees the whole sequence (it gathers a sequence
    split), so ``stop`` counts positions of the whole sequence on every
    rank; under an inner split each rank masks its own block of features.
    MoE layers still route the pad tokens."""
    cfg = model.cfg
    plan = plan_for(cfg)
    split = _cache_split(state, plan)
    inner = _inner_split(state, plan)
    mine = plan.inner if plan is not None and plan.inner else None
    h = _frontend_embed(model, inputs, plan)
    b = h.shape[0]
    s = h.shape[1] * (plan.seq.n if plan is not None else 1)
    positions = _positions(b, s, h.device)
    if plan is not None:
        positions = plan.local_positions(positions)
    stop = None
    if lengths is not None:
        stop = (torch.as_tensor(lengths, device=h.device).long() - 1) \
            .clamp(min=0)
    layers = []
    for layer, st in zip(model.layers, state["layers"]):
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        if layer.kind == BlockKind.ATTENTION:
            out, _ = attn_mod.prefill_attention(
                layer.block, (st["k"], st["v"]), normed, positions, cfg,
                plan, split)
        else:
            kw = {"chunk": ssm_chunk} if layer.kind == BlockKind.MAMBA \
                else {}
            out, st = _RECURRENT[layer.kind](layer.block, normed, cfg,
                                             return_state=True, plan=plan,
                                             stop=stop, **kw)
            st = _relayout(layer.kind, st, cfg, mine, inner)
        layers.append(st)
        h, _ = _ffn(layer, h + out, cfg, plan)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, _last_row(h, plan), cfg.vocab_size,
                     plan).float()
    pos = torch.full((b,), s, dtype=torch.int32, device=h.device) \
        if stop is None else stop.to(torch.int32)
    out = {"layers": layers, "pos": pos}
    for key in ("cache_axes", "inner_axes"):
        if key in state:
            out[key] = state[key]
    return logits, out


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
    plan = plan_for(cfg)
    if plan is not None and plan.seq:
        raise ValueError("a decode step under rules that split the sequence "
                         "of the residual (seq_tp)")
    split = _cache_split(state, plan)
    inner = _inner_split(state, plan)
    mine = plan.inner if plan is not None and plan.inner else None
    if (inner.axes if inner else ()) != (mine.axes if mine else ()):
        raise ValueError(f"a decode state split over {inner and inner.axes} "
                         f"stepped under rules that split inner over "
                         f"{mine and mine.axes}")
    h = embed(model.embed, tokens, plan)
    if plan is not None:
        h = residual_from_partial(h, plan)
    positions = state["pos"]
    layers = []
    for layer, st in zip(model.layers, state["layers"]):
        normed = rmsnorm(layer.norm1, h, cfg.norm_eps)
        if layer.kind == BlockKind.ATTENTION:
            out, _ = attn_mod.decode_attention(
                layer.block, (st["k"], st["v"]), normed, positions, cfg,
                plan, split)
        else:
            out, st = _STEP[layer.kind](layer.block, st, normed, cfg, plan)
        layers.append(st)
        h, _ = _ffn(layer, h + out, cfg, plan)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = unembed(model.embed, h, cfg.vocab_size, plan).float()
    out = {"layers": layers, "pos": positions + 1}
    for key in ("cache_axes", "inner_axes"):
        if key in state:
            out[key] = state[key]
    return logits, out
