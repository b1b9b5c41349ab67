"""The model plane of the PyTorch port against the JAX reference.

Weights come from the reference's ``init_lm`` and are carried across by
``repro_torch.models.convert.params_from_numpy``; inputs are seeded numpy
arrays handed to both packages. Everything runs in fp32
(``dataclasses.replace(cfg, dtype="float32")``), where the point is the
algorithm and not bf16 rounding, and is compared at atol 1e-4.
"""

import dataclasses
from functools import cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
import repro.models.lm as jlm
import repro_torch.models.layers as tlayers
import repro_torch.models.lm as tlm
from repro.configs import get_config as jconfig
from repro_torch.configs import get_config as tconfig
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-4
# the served model (GQA with 3 query heads a kv head, tied embeddings) and
# one with qkv biases, untied embeddings and no grouping
DENSE = ("llama3.2-3b", "qwen1.5-4b")
# MoE FFNs on standard attention: granite (4 experts top-2 in its smoke
# config) and moonshot (8 experts top-2, no grouping)
MOE = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@cache
def _models(arch: str):
    """(reference cfg, reference params, port cfg, port model), fp32; built
    once per architecture (the tests never change the weights)."""
    jcfg = dataclasses.replace(jconfig(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfig(arch, smoke=True), dtype="float32")
    params = jax.jit(lambda key: jlm.init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, tcfg, model


def _tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# -- layers ---------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    norm = tlayers.RMSNorm(48, torch.float32, "cpu")
    norm.scale.data = torch.from_numpy(scale)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5)
    _close(tlayers.rmsnorm(norm, torch.from_numpy(x), 1e-5), want)


@pytest.mark.parametrize("base", [0, 2 ** 16 - 7])
def test_rope_matches_reference(base):
    """Concatenated halves, float64 frequencies cast to float32; positions
    near 2^16 stress the fp32 angles."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = (base + np.arange(12).reshape(2, 6)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    _close(got, want)
    np.testing.assert_array_equal(
        tlayers.rope_frequencies(16, 5e5).numpy(),
        np.asarray(jlayers.rope_frequencies(16, 5e5)))


def test_mlp_matches_reference():
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("gate", (48, 128)), ("up", (48, 128)), ("down", (128, 48)))}
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    m = tlayers.MLP(48, 128, torch.float32, None, "meta")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()},
                      assign=True)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    _close(tlayers.mlp(m, torch.from_numpy(x)), want)


def test_tied_unembed_with_a_padded_vocab_matches_reference():
    """vocab 500 pads to 512: the padded columns read -1e9 on both."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((512, 48)).astype(np.float32)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    emb = tlayers.Embedding(500, 48, torch.float32, None, "meta", tie=True)
    emb.load_state_dict({"table": torch.from_numpy(table)}, assign=True)
    want = jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x),
                           500)
    got = tlayers.unembed(emb, torch.from_numpy(x), 500)
    assert got.shape == (2, 3, 512)
    assert bool((got[..., 500:] == -1e9).all())
    _close(got, want)


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_matches_reference(arch):
    """Logits and the MoE aux loss (0 for a dense model)."""
    jcfg, params, tcfg, model = _models(arch)
    toks = _tokens(5, (2, 9), jcfg.vocab_size)
    want, want_aux = jax.jit(partial(jlm.forward, cfg=jcfg, remat="none",
                                     q_chunk=9))(
        params, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (arch in DENSE)
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_then_decode_matches_reference(arch):
    """A prefill of 7 tokens, then three decode steps from positions the
    engine's rewind leaves (rows at different positions), caches included."""
    jcfg, params, tcfg, model = _models(arch)
    toks = _tokens(6, (2, 7), jcfg.vocab_size)
    jst = jlm.init_decode_state(jcfg, 2, 16)
    jlog, jst = jax.jit(partial(jlm.prefill_step, cfg=jcfg, q_chunk=7))(
        params, jst, {"tokens": jnp.asarray(toks)})
    tst = tlm.init_decode_state(tcfg, 2, 16, "cpu")
    tlog, tst = tlm.prefill_step(model, tst,
                                 {"tokens": torch.from_numpy(toks)})
    _close(tlog, jlog)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    pos = np.array([6, 3], np.int32)
    jst["pos"], tst["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    jdecode = jax.jit(partial(jlm.decode_step, cfg=jcfg))
    for step in range(3):
        nxt = _tokens(7 + step, (2, 1), jcfg.vocab_size)
        jlog, jst = jdecode(params, jst, jnp.asarray(nxt))
        tlog, tst = tlm.decode_step(model, tst, torch.from_numpy(nxt))
        _close(tlog, jlog)
        np.testing.assert_array_equal(tst["pos"].numpy(),
                                      np.asarray(jst["pos"]))
    for i, layer in enumerate(tst["layers"]):
        for name in ("k", "v"):
            _close(layer[name], jst["layers"][0][name][i])


def test_init_lm_has_the_reference_parameter_shapes():
    cfg = tconfig("llama3.2-3b", smoke=True)
    model = tlm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ported = _models("llama3.2-3b")[3]
    assert {n: p.shape for n, p in model.named_parameters()} == \
        {n: p.shape for n, p in ported.named_parameters()}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    again = tlm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b",
                                  "internvl2-1b"])
def test_blocks_not_ported_yet_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        tlm.init_lm(tconfig(arch, smoke=True), device="cpu")
