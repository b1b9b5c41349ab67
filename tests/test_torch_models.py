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
from repro.configs import ARCH_IDS
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
# recurrent blocks: xlstm (mLSTM + sLSTM, no FFN) and jamba (Mamba and
# attention, dense and MoE FFNs; its MoE drop-free, as the reference's
# ``test_decode_continues_prefill`` runs it)
RECURRENT = ("xlstm-1.3b", "jamba-v0.1-52b")
# the stub frontends: patches before the tokens, frames added to them
STUB = ("internvl2-1b", "musicgen-medium")
NEW = RECURRENT + STUB
DROP_FREE = 8.0


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@cache
def _models(arch: str):
    """(reference cfg, reference params, port cfg, port model), fp32; built
    once per architecture (the tests never change the weights)."""
    jcfg = dataclasses.replace(jconfig(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfig(arch, smoke=True), dtype="float32")
    if arch == "jamba-v0.1-52b":
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=DROP_FREE)) for c in (jcfg, tcfg))
    params = jax.jit(lambda key: jlm.init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, tcfg, model


def _tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _inputs(cfg, seed: int, b: int, s: int) -> dict:
    """Seeded numpy inputs: ``s`` tokens a row, and the stub frontend's
    patch or frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.stub_patches, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (b, s, tlm.AUDIO_FRAME_DIM)).astype(np.float32)
    return out


def _both(inputs: dict):
    return ({k: jnp.asarray(v) for k, v in inputs.items()},
            {k: torch.from_numpy(v) for k, v in inputs.items()})


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


def _layer_states_close(tst: dict, jst: dict, period: int) -> None:
    """Layer ``r * P + p`` of the port's state against row ``r`` of the
    reference's pattern position ``p``, leaf by leaf."""
    for i, layer in enumerate(tst["layers"]):
        ref = jst["layers"][i % period]
        assert set(layer) == set(ref)
        for name in ref:
            _close(layer[name], ref[name][i // period])


@pytest.mark.parametrize("arch", DENSE + MOE + NEW)
def test_forward_matches_reference(arch):
    """Logits and the MoE aux loss (0 without MoE layers), at a Mamba and
    mLSTM chunk of 3."""
    jcfg, params, tcfg, model = _models(arch)
    jin, tin = _both(_inputs(jcfg, 5, 2, 9))
    want, want_aux = jax.jit(partial(jlm.forward, cfg=jcfg, remat="none",
                                     ssm_chunk=3))(params, jin)
    got, aux = tlm.forward(model, tin, ssm_chunk=3)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (jcfg.moe is None)
    assert got.shape[1] == 9 + (jcfg.stub_patches if arch == STUB[0] else 0)
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", DENSE + MOE + NEW)
def test_prefill_then_decode_matches_reference(arch):
    """A prefill of 7 tokens (after the patches of the vision stub), then
    three decode steps from positions the engine's rewind leaves (rows at
    different positions), every layer's state included."""
    jcfg, params, tcfg, model = _models(arch)
    jin, tin = _both(_inputs(jcfg, 6, 2, 7))
    jst = jlm.init_decode_state(jcfg, 2, 16)
    jlog, jst = jax.jit(partial(jlm.prefill_step, cfg=jcfg, ssm_chunk=7))(
        params, jst, jin)
    tst = tlm.init_decode_state(tcfg, 2, 16, "cpu")
    tlog, tst = tlm.prefill_step(model, tst, tin, ssm_chunk=7)
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
    _layer_states_close(tst, jst, len(jcfg.block_pattern))


@pytest.mark.parametrize("arch", RECURRENT + STUB[:1])
def test_decode_continues_prefill(arch):
    """prefill(prompt) then one decode step == forward over the extended
    sequence, in the port (the reference's ``test_decode_continues_prefill``
    at fp32 tolerance; jamba's MoE drop-free). Not musicgen: its decode
    step adds no frame embedding, in either package."""
    _, _, tcfg, model = _models(arch)
    inputs = {k: torch.from_numpy(v)
              for k, v in _inputs(tcfg, 8, 1, 12).items()}
    st = tlm.init_decode_state(tcfg, 1, 32, "cpu")
    lg, st = tlm.prefill_step(model, st, inputs, ssm_chunk=4)
    nxt = lg[:, 0, :tcfg.vocab_size].argmax(-1)[:, None].to(torch.int32)
    lg_d, st = tlm.decode_step(model, st, nxt)
    extended = dict(inputs, tokens=torch.cat([inputs["tokens"], nxt], 1))
    lg_f, _ = tlm.forward(model, extended, ssm_chunk=extended[
        "tokens"].shape[1])
    _close(lg_d[:, 0], lg_f[:, -1].numpy())


@pytest.mark.parametrize("arch", NEW)
def test_init_decode_state_matches_the_reference_per_layer(arch):
    """Each layer's state has the shape and dtype of the reference's slice
    for it, and starts at the same values (sLSTM's ``n`` at ones, mLSTM's
    ``m`` at -1e9)."""
    jcfg, tcfg = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    jst = jlm.init_decode_state(jcfg, 2, 16)
    tst = tlm.init_decode_state(tcfg, 2, 16, "cpu")
    period = len(jcfg.block_pattern)
    assert len(tst["layers"]) == jcfg.num_layers
    for i, layer in enumerate(tst["layers"]):
        ref = jst["layers"][i % period]
        assert set(layer) == set(ref)
        for name, t in layer.items():
            want = np.asarray(ref[name][i // period])
            assert tuple(t.shape) == want.shape
            assert str(t.dtype).removeprefix("torch.") == str(want.dtype)
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))
    assert tst["pos"].dtype == torch.int32


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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds(arch):
    """All ten architectures build on the CPU, and a forward at a tiny
    size gives finite logits of the right shape."""
    cfg = tconfig(arch, smoke=True)
    model = tlm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {layer.kind.value for layer in model.layers} \
        == set(cfg.block_pattern)
    assert all(hasattr(layer, "ffn") == (cfg.ffn.value != "none")
               for layer in model.layers)
    inputs = {k: torch.from_numpy(v)
              for k, v in _inputs(cfg, 9, 2, 8).items()}
    logits, aux = tlm.forward(model, inputs, ssm_chunk=4)
    s = 8 + (cfg.stub_patches if cfg.frontend == "vision" else 0)
    assert logits.shape[:2] == (2, s)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_from_numpy_carries_every_arch(arch):
    """The reference's bf16 parameter tree carries across leaf for leaf:
    the port's names, shapes and dtypes (fp32 leaves stay fp32) are those
    of ``init_lm``, and the values are the reference's bits. A leaf of
    another dtype is refused."""
    jcfg, tcfg = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jlm.init_lm(jcfg, key)[0])(jax.random.PRNGKey(1)))
    model = params_from_numpy(tree, tcfg, "cpu")
    fresh = tlm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = {n: (p.shape, p.dtype) for n, p in fresh.named_parameters()}
    assert {n: (p.shape, p.dtype) for n, p in model.named_parameters()} \
        == want
    table = model.embed.table.float().numpy()
    np.testing.assert_array_equal(
        table, tree["embed"]["table"].astype(np.float32))
    last = tree["blocks"][-1]["norm1"]["scale"]
    np.testing.assert_array_equal(
        model.layers[-1].norm1.scale.float().numpy(),
        last[-1].astype(np.float32))
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"].astype(
        np.float32)
    with pytest.raises(ValueError, match="dtype"):
        params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    """``input_specs`` gives the reference's shapes and dtypes in every
    mode, ``applicable_shapes`` its cells, and ``concrete_inputs`` tensors
    of those specs, token ids in range, the same for the same seed."""
    import repro.configs.common as jcommon
    import repro_torch.configs.common as tcommon
    from repro.core.config import ShapeConfig as JShape
    from repro_torch.core.config import ShapeConfig as TShape

    jcfg, tcfg = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    assert tcommon.applicable_shapes(tcfg) == jcommon.applicable_shapes(jcfg)
    for mode in ("train", "prefill", "decode"):
        want = jcommon.input_specs(jcfg, JShape("s", 24, 2, mode))
        got = tcommon.input_specs(tcfg, TShape("s", 24, 2, mode))
        assert {k: (shape, str(dt).removeprefix("torch."))
                for k, (shape, dt) in got.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        shape = TShape("s", 24, 2, mode)
        made = tcommon.concrete_inputs(tcfg, shape,
                                       torch.Generator().manual_seed(3),
                                       "cpu")
        again = tcommon.concrete_inputs(tcfg, shape,
                                        torch.Generator().manual_seed(3),
                                        "cpu")
        for k, (dims, dt) in got.items():
            assert made[k].shape == dims and made[k].dtype == dt
            assert torch.equal(made[k], again[k])
            if not dt.is_floating_point:
                assert 0 <= int(made[k].min()) \
                    and int(made[k].max()) < tcfg.vocab_size
