"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``).

The weights are the reference's ``init_mamba`` leaves, loaded into the
port's module; the inputs are seeded numpy arrays handed to both packages.
jamba's smoke config runs in fp32 (``dtype="float32"``), where the point
is the algorithm and not bf16 rounding, compared at atol/rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as jssm
import repro_torch.models.ssm as tssm
from repro.configs import get_config as jconfig
from repro_torch.configs import get_config as tconfig

TOL = 1e-4
ARCH = "jamba-v0.1-52b"


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _cfgs():
    return (dataclasses.replace(jconfig(ARCH, smoke=True), dtype="float32"),
            dataclasses.replace(tconfig(ARCH, smoke=True), dtype="float32"))


def _mamba(seed: int):
    """(reference cfg, params, port cfg, port block) of one seed."""
    jcfg, tcfg = _cfgs()
    params, _ = jssm.init_mamba(jcfg, jax.random.PRNGKey(seed))
    block = tssm.Mamba(tcfg, None, "meta")
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()}, assign=True)
    return jcfg, params, tcfg, block


def _x(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mamba_leaves_have_the_reference_shapes_and_dtypes():
    jcfg = jconfig(ARCH, smoke=True)
    params, _ = jssm.init_mamba(jcfg, jax.random.PRNGKey(0))
    block = tssm.init_mamba(tconfig(ARCH, smoke=True),
                            torch.Generator().manual_seed(0), "cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in block.named_parameters()}
    assert got == {k: (v.shape, str(v.dtype)) for k, v in params.items()}
    assert not any(p.requires_grad for p in block.parameters())
    # S4D-real A and the unit skip, as the reference makes them
    _close(block.a_log, params["a_log"])
    _close(block.d_skip, params["d_skip"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(seed, with_state):
    """The conv and its trailing-inputs state, from zeros or a carried
    state, over a sequence shorter than the kernel too."""
    for s in (5, 2):
        x, w, b = _x(seed, (2, s, 16)), _x(seed + 10, (4, 16)), \
            _x(seed + 20, (16,))
        st = _x(seed + 30, (2, 3, 16)) if with_state else None
        want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
        got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
        for g, w_ in zip(got, want):
            _close(g, w_)


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_chunk_matches_reference(seed):
    """The step-by-step recurrence against the associative scan, with
    decays down to exp(-200): products of them underflow fp32, so a
    cumprod divided out would give inf or nan here."""
    rng = np.random.default_rng(seed)
    a_bar = np.exp(-rng.uniform(0.0, 200.0 / 16, (2, 16, 8, 4))).astype(
        np.float32)
    a_bar[:, ::5] = 1.0
    bx, h0 = _x(seed, (2, 16, 8, 4)), _x(seed + 1, (2, 8, 4))
    want = jssm._scan_chunk(jnp.asarray(h0), jnp.asarray(a_bar),
                            jnp.asarray(bx))
    got = tssm._scan_chunk(torch.from_numpy(h0), torch.from_numpy(a_bar),
                           torch.from_numpy(bx))
    assert bool(torch.isfinite(got[0]).all())
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunk", [4, 8, 128])
def test_mamba_matches_reference(seed, chunk):
    """Output and final ``{h, conv}`` state at several chunks (128: one
    chunk of the whole sequence)."""
    jcfg, params, tcfg, block = _mamba(seed)
    x = _x(seed + 2, (2, 16, jcfg.d_model))
    want, wst = jssm.mamba(params, jnp.asarray(x), jcfg, chunk=chunk,
                           return_state=True)
    got, gst = tssm.mamba(block, torch.from_numpy(x), tcfg, chunk=chunk,
                          return_state=True)
    _close(got, want)
    assert set(gst) == set(wst)
    for k in wst:
        _close(gst[k], wst[k])
    _close(tssm.mamba(block, torch.from_numpy(x), tcfg, chunk=chunk), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_step_over_a_sequence_matches_the_chunked_forward(seed):
    """Twelve decode steps from the initial state give the reference's
    chunked forward position by position and its final state; and one step
    from that state equals the reference's step."""
    jcfg, params, tcfg, block = _mamba(seed)
    x = _x(seed + 3, (2, 12, jcfg.d_model))
    want, wst = jssm.mamba(params, jnp.asarray(x), jcfg, chunk=4,
                           return_state=True)
    st = tssm.init_mamba_state(tcfg, 2, "cpu")
    jst = jssm.init_mamba_state(jcfg, 2)
    for k in st:
        assert st[k].shape == jst[k].shape
        assert str(st[k].dtype).removeprefix("torch.") == str(jst[k].dtype)
    for t in range(12):
        out, st = tssm.mamba_step(block, st, torch.from_numpy(x[:, t:t + 1]),
                                  tcfg)
        _close(out, want[:, t:t + 1])
    for k in wst:
        _close(st[k], wst[k])
    nxt = _x(seed + 4, (2, 1, jcfg.d_model))
    wout, wst = jssm.mamba_step(params, wst, jnp.asarray(nxt), jcfg)
    gout, st = tssm.mamba_step(block, st, torch.from_numpy(nxt), tcfg)
    _close(gout, wout)
    for k in wst:
        _close(st[k], wst[k])


def test_mamba_refuses_what_the_reference_refuses():
    """A sequence that is not a multiple of the chunk fails the same
    assertion in both packages; one at most one chunk long passes."""
    jcfg, params, tcfg, block = _mamba(0)
    x = _x(5, (1, 12, jcfg.d_model))
    with pytest.raises(AssertionError):
        jssm.mamba(params, jnp.asarray(x), jcfg, chunk=8)
    with pytest.raises(AssertionError):
        tssm.mamba(block, torch.from_numpy(x), tcfg, chunk=8)
    assert tssm.mamba(block, torch.from_numpy(x), tcfg, chunk=16).shape \
        == x.shape
