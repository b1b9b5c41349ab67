"""Shared by the dry-run's FLOP parity tests: the reference's trip-count-
aware HLO count (``repro.launch.hlo_analysis.analyze``) of its jitted
``forward`` or ``make_train_step`` over ``eval_shape`` parameters, the
port's dispatch count (``repro_torch.launch.dispatch_analysis.analyze``)
of the same step on meta tensors, and the terms the two count differently
on purpose, in closed form.

Each term is the reference's FLOPs less the port's, for ``B`` rows of
``S`` tokens (``U = B * H * S^2 * hd`` an attention layer):

- ``attention``: the reference runs attention as one full ``S x S`` block
  at ``S <= q_chunk`` (``4 U`` forward: scores and values, 2 FLOPs a
  multiply-add); K4 is counted by its causal formula, ``2 U``. Training:
  the reference's backward is four such products (``8 U``) and block
  remat recomputes the forward (``4 U``); the port's is K4b (``5 U``,
  five products over the causal half) and the recompute is K4 again
  (``2 U``). So ``2 U`` a layer (prefill), ``5 U`` (train, no remat),
  ``7 U`` (train, block remat).
- ``loss_recompute`` (train): the port's chunked cross-entropy
  (``training/losses.py``) recomputes each chunk's logits in its
  backward, ``2 B S D V`` FLOPs (``V`` the vocabulary padded to 128) the
  reference does not.
- ``conv``: the causal convolution of the Mamba, mLSTM and sLSTM blocks
  is one grouped ``conv1d`` in the port (``2 B S C K`` FLOPs for ``C``
  channels and ``K`` taps), ``K`` shifted elementwise products in the
  reference (no ``convolution`` instruction): the forward once (prefill),
  and in training also its backward (twice the forward) and, under block
  remat, its recompute.
- ``mamba_outer`` (train): the gradient of the scan's output ``y = C h``
  with respect to ``h`` is an outer product, a batched product with one
  contracted element in the port (``2 B S Din N``, ``N`` the state), an
  elementwise product in the reference.
- ``mlstm_norm``: the mLSTM's normalizer ``q . n`` is a dot in the
  reference (``2 B H S dk`` forward; in training one more in its backward,
  and the forward again under block remat), an elementwise product and a
  sum in the port.
- ``mlstm_carry`` (train): the reference's ``lax.scan`` over the chunks
  differentiates the carry ``C`` through every chunk, the zero ``C`` it
  starts from and the last chunk's update that no loss reads among them
  (``3 x 2 B H c dk dv`` a layer for chunks of ``c``); autograd skips
  both (at two chunks or more: one chunk is a loop XLA unrolls).
- ``slstm_h0`` (train): the same for the sLSTM: the reference's scan
  differentiates the recurrent product of the first position through its
  zero initial hidden state (``2 B H 4 dv dv`` a layer), autograd does
  not.

Nothing else may differ: every other matrix product of the two packages,
forward and backward, the MoE experts' and the Mamba scan's included,
counts the same.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jconfig
from repro.core.config import OptimizerConfig as JOptimizerConfig
from repro.core.config import ParallelConfig as JParallelConfig
from repro.core.config import ShapeConfig as JShapeConfig
from repro.launch.hlo_analysis import analyze as janalyze
from repro.training import make_train_step as jmake_train_step
from repro.training.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import get_config as tconfig
from repro_torch.core.config import (BlockKind, OptimizerConfig,
                                     ParallelConfig, ShapeConfig)
from repro_torch.launch import dispatch_analysis
from repro_torch.models.lm import LM, forward
from repro_torch.training import init_train_state, make_train_step

SSM_CHUNK = 128


def configs(arch: str, layers: int, vocab: int | None = None):
    """The reference's and the port's published configs of ``arch`` cut to
    ``layers`` layers (and ``vocab`` tokens where given)."""
    kw = {"num_layers": layers}
    if vocab is not None:
        kw["vocab_size"] = vocab
    return (dataclasses.replace(jconfig(arch), **kw),
            dataclasses.replace(tconfig(arch), **kw))


def reference_flops(jcfg, mode: str, b: int, s: int, remat: str) -> int:
    """``hlo_analysis.analyze`` of the reference's compiled step."""
    params = jax.eval_shape(lambda: jlm.init_lm(jcfg, jax.random.PRNGKey(0))
                            [0])
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if mode == "prefill":
        fn = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jcfg,
                                              ssm_chunk=SSM_CHUNK))
        lowered = fn.lower(params, tok)
    else:
        fn = jax.jit(jmake_train_step(
            jcfg, JShapeConfig("t", s, b, "train"), JOptimizerConfig(),
            JParallelConfig(remat=remat), ssm_chunk=SSM_CHUNK))
        lowered = fn.lower({"params": params,
                            "opt": jax.eval_shape(jinit_opt_state, params)},
                           {"tokens": tok, "labels": tok})
    return int(janalyze(lowered.compile().as_text()).flops)


def port_costs(tcfg, mode: str, b: int, s: int, remat: str):
    """The port's ``Costs`` of the same step on meta tensors
    (``dispatch_analysis.analyze``: the card's program)."""
    meta = torch.device("meta")
    model = LM(tcfg, None, meta)
    tok = torch.empty((b, s), dtype=torch.int32, device=meta)
    if mode == "prefill":
        with torch.no_grad():
            return dispatch_analysis.analyze(forward, model, {"tokens": tok},
                                             SSM_CHUNK)
    step = make_train_step(tcfg, ShapeConfig("t", s, b, "train"),
                           OptimizerConfig(), ParallelConfig(remat=remat),
                           ssm_chunk=SSM_CHUNK)
    return dispatch_analysis.analyze(step, init_train_state(tcfg, model),
                                     {"tokens": tok, "labels": tok})


def terms(cfg, mode: str, b: int, s: int, remat: str) -> dict:
    """The reference's FLOPs less the port's, by the module docstring's
    names."""
    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    train = mode == "train"
    recompute = int(train and remat != "none")
    out = {}
    n_attn = kinds.count(BlockKind.ATTENTION)
    u = b * cfg.num_heads * s * s * cfg.resolved_head_dim
    out["attention"] = n_attn * u * (7 if recompute else 5 if train else 2)
    if train:
        vpad = -(-cfg.vocab_size // 128) * 128
        out["loss_recompute"] = -2 * b * s * cfg.d_model * vpad
    conv = 0
    for k in kinds:
        if k == BlockKind.MAMBA:
            conv += 2 * b * s * cfg.ssm.expand * cfg.d_model * cfg.ssm.d_conv
        elif k in (BlockKind.MLSTM, BlockKind.SLSTM):
            conv += 2 * b * s * int(cfg.xlstm.proj_factor * cfg.d_model) \
                * cfg.xlstm.conv_kernel
    out["conv"] = -conv * ((3 + recompute) if train else 1)
    if train:
        out["mamba_outer"] = -kinds.count(BlockKind.MAMBA) * 2 * b * s \
            * cfg.ssm.expand * cfg.d_model * cfg.ssm.d_state \
            if cfg.ssm is not None else 0
    if cfg.xlstm is not None:
        d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
        h = cfg.num_heads
        dk, dv = int(cfg.xlstm.qk_dim_factor * d_in) // h, d_in // h
        n_m = kinds.count(BlockKind.MLSTM)
        out["mlstm_norm"] = n_m * 2 * b * h * s * dk \
            * ((2 + recompute) if train else 1)
        if train:
            chunk = min(SSM_CHUNK, s)
            out["mlstm_carry"] = n_m * 3 * 2 * b * h * chunk * dk * dv
            out["slstm_h0"] = kinds.count(BlockKind.SLSTM) * 2 * b * h * 4 \
                * dv * dv
    return out
