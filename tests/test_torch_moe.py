"""The MoE FFN of the PyTorch port against the JAX reference.

Seeded numpy inputs go through the reference's ``repro.models.moe`` (no
mesh, so its single-device path) and the port's ``repro_torch.models.moe``
on the CPU, where the port's K2 dispatch runs K2's plain version. The
dispatch bookkeeping must be equal, element for element; outputs and the
load-balance loss agree at atol and rtol 1e-4 in fp32 (the tolerance of
``test_torch_models.py``). Experts are chosen with ``top_k`` from seeded
random weights, where ties between probabilities do not occur.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
import repro.models.moe as jmoe
import repro.serving.engine as jeng
import repro_torch.models.lm as tlm
import repro_torch.models.moe as tmoe
import repro_torch.serving.engine as teng
from repro.configs import get_config as jconfig
from repro.core.config import MoEConfig as JMoEConfig
from repro_torch.configs import get_config as tconfig
from repro_torch.core.config import MoEConfig as TMoEConfig
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-4
GRANITE = "granite-moe-1b-a400m"


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def _choices(seed: int, b: int, s: int, e: int, k: int) -> np.ndarray:
    """``(b, s, k)`` distinct experts per token, as ``top_k`` picks them."""
    scores = np.random.default_rng(seed).standard_normal((b, s, e))
    return np.argsort(-scores, axis=-1)[..., :k].astype(np.int32)


def _reference_bookkeeping(top_i: np.ndarray, e: int, cap: int):
    """The reference's ``_dispatch_row`` over every row (its vmap)."""
    b, s, k = top_i.shape
    x = jnp.zeros((b, s, 1), jnp.float32)
    p = jnp.ones(top_i.shape, jnp.float32)
    _, bk = jax.vmap(lambda xr, pr, ir: jmoe._dispatch_row(
        xr, pr, ir, e, cap, k))(x, p, jnp.asarray(top_i))
    return [np.asarray(a) for a in bk]


# (batch, seq, experts, top_k, capacity): drops at capacity 4; no drops;
# 1000 experts, so that K2 takes one row a call
DISPATCH_CASES = [(2, 16, 4, 2, 4), (3, 9, 8, 3, 12), (3, 5, 1000, 4, 4)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("b,s,e,k,cap", DISPATCH_CASES)
def test_dispatch_bookkeeping_matches_reference(b, s, e, k, cap, seed):
    """``sorted_e``, ``slot``, ``token_src``, ``order`` and ``keep`` equal
    the reference's, through K2 and through the plain argsort alike."""
    top_i = _choices(seed, b, s, e, k)
    want = _reference_bookkeeping(top_i, e, cap)
    t = torch.from_numpy(top_i)
    for got in (tmoe.dispatch(t, e, cap), tmoe.dispatch_plain(t, cap)):
        for name, g, w in zip(tmoe.Dispatch._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if cap == 4 and e == 4:
        assert not want[-1].all(), "the capacity case dropped nothing"


def _moe_pair(seed: int, d: int, e: int, k: int, f: int,
              capacity_factor: float):
    """(reference cfg, params, port cfg, port MoE) from the reference's
    ``init_moe``, in fp32."""
    base = jconfig(GRANITE, smoke=True)
    jcfg = dataclasses.replace(
        base, d_model=d, dtype="float32",
        moe=JMoEConfig(num_experts=e, top_k=k, d_expert=f,
                       capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(
        tconfig(GRANITE, smoke=True), d_model=d, dtype="float32",
        moe=TMoEConfig(num_experts=e, top_k=k, d_expert=f,
                       capacity_factor=capacity_factor))
    params, _ = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    layer = tmoe.MoE(tcfg, None, "meta")
    layer.load_state_dict({n: torch.from_numpy(np.array(v))
                           for n, v in params.items()}, assign=True)
    return jcfg, params, tcfg, layer


# (seq, experts, top_k, capacity factor, chunk): the smoke config's own
# layer; a capacity that drops; a sequence in four chunks of 8
MOE_CASES = [(9, 4, 2, 1.25, 1024), (64, 4, 2, 0.5, 1024),
             (32, 8, 3, 1.25, 8)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s,e,k,cf,s_chunk", MOE_CASES)
def test_moe_matches_reference(s, e, k, cf, s_chunk, seed):
    jcfg, params, tcfg, layer = _moe_pair(seed, 32, e, k, 48, cf)
    x = np.random.default_rng(10 + seed).standard_normal(
        (2, s, 32)).astype(np.float32)
    want_y, want_aux = jmoe.moe(params, jnp.asarray(x), jcfg,
                                s_chunk=s_chunk)
    got_y, got_aux = tmoe.moe(layer, torch.from_numpy(x), tcfg,
                              s_chunk=s_chunk)
    _close(got_y, want_y)
    _close(got_aux, want_aux)
    if cf < 1:
        probs = torch.softmax(torch.from_numpy(x) @ layer.router, -1)
        bk = tmoe.dispatch(torch.topk(probs, k, -1).indices, e,
                           tmoe.capacity(s, tcfg.moe))
        assert not bool(bk.keep.all()), "the capacity case dropped nothing"


def test_moe_refuses_a_ragged_chunking():
    _, _, tcfg, layer = _moe_pair(0, 32, 4, 2, 48, 1.25)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tmoe.moe(layer, torch.zeros((1, 12, 32)), tcfg, s_chunk=8)


def test_params_from_numpy_carries_moe_leaves():
    """Granite's smoke tree in bf16: every MoE leaf lands on its layer,
    row ``r`` of the stacked leaf on layer ``r`` (period 1), the router in
    fp32 and the experts in bf16, bit for bit."""
    jcfg = jconfig(GRANITE, smoke=True)
    tcfg = tconfig(GRANITE, smoke=True)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jcfg,
                                                jax.random.PRNGKey(3))[0])
    model = params_from_numpy(tree, tcfg, "cpu")
    ffn = tree["blocks"][0]["ffn"]
    assert set(ffn) == {"router", "gate", "up", "down"}
    for layer_idx, layer in enumerate(model.layers):
        assert isinstance(layer.ffn, tmoe.MoE)
        for name, want in ffn.items():
            got = getattr(layer.ffn, name)
            assert got.dtype == (torch.float32 if name == "router"
                                 else torch.bfloat16), name
            w = want[layer_idx]
            if w.dtype.name == "bfloat16":
                got, w = got.view(torch.int16).numpy(), w.view(np.int16)
            else:
                got = got.numpy()
            np.testing.assert_array_equal(got, w, err_msg=name)


def test_init_lm_builds_moe_layers():
    cfg = tconfig(GRANITE, smoke=True)
    model = tlm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(isinstance(layer.ffn, tmoe.MoE) for layer in model.layers)
    ported = params_from_numpy(
        jax.tree.map(np.asarray,
                     jlm.init_lm(jconfig(GRANITE, smoke=True),
                                 jax.random.PRNGKey(0))[0]), cfg, "cpu")
    assert {n: (p.shape, p.dtype) for n, p in model.named_parameters()} == \
        {n: (p.shape, p.dtype) for n, p in ported.named_parameters()}


def _serve(eng, cfg, params, prompts, **kw):
    engine = eng.ServingEngine(cfg, params, slo_ms=1e9, **kw)
    for i, prompt in enumerate(prompts):
        engine.submit(eng.Request(i, list(prompt), max_new_tokens=4))
    done = engine.run(max_steps=256)
    return ({r.req_id: r.output for r in done},
            {k: engine.metrics[k] for k in ("steps", "prefills",
                                            "generated")})


def test_engine_serves_granite_as_the_reference():
    """Granite's smoke config, fp32, through both engines: the same tokens
    and counters over three waves (every prefill pads to ``max_seq``, so
    the prefill's capacity is that of 40 tokens)."""
    jcfg = dataclasses.replace(jconfig(GRANITE, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfig(GRANITE, smoke=True), dtype="float32")
    params = jax.jit(lambda key: jlm.init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 200, n).tolist() for n in (9, 4, 13, 6, 2)]
    want = _serve(jeng, jcfg, params, prompts, max_batch=2, max_seq=40)
    got = _serve(teng, tcfg, model, prompts, max_batch=2, max_seq=40,
                 device="cpu")
    assert len(got[0]) == len(prompts)
    assert got == want
