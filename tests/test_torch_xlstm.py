"""The port's mLSTM and sLSTM blocks (``repro_torch.models.xlstm``)
against the JAX reference (``repro.models.xlstm``).

The weights are the reference's ``init_mlstm`` / ``init_slstm`` leaves,
loaded into the port's modules; the inputs are seeded numpy arrays handed
to both packages. xlstm's smoke config runs in fp32 (``dtype="float32"``),
compared at atol/rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as jx
import repro_torch.models.xlstm as tx
from repro.configs import get_config as jconfig
from repro_torch.configs import get_config as tconfig

TOL = 1e-4
ARCH = "xlstm-1.3b"
# (reference init, port module, forward, step, initial state) by kind
KINDS = {
    "mlstm": (jx.init_mlstm, tx.MLSTM, "mlstm", "mlstm_step",
              "init_mlstm_state"),
    "slstm": (jx.init_slstm, tx.SLSTM, "slstm", "slstm_step",
              "init_slstm_state"),
}


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _block(kind: str, seed: int):
    """(reference cfg, params, port cfg, port block) of one seed."""
    jcfg = dataclasses.replace(jconfig(ARCH, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfig(ARCH, smoke=True), dtype="float32")
    init, cls = KINDS[kind][:2]
    params, _ = init(jcfg, jax.random.PRNGKey(seed))
    block = cls(tcfg, None, "meta")
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()}, assign=True)
    return jcfg, params, tcfg, block


def _x(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _fn(kind: str, which: int):
    return getattr(jx, KINDS[kind][which]), getattr(tx, KINDS[kind][which])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_leaves_have_the_reference_shapes_and_dtypes(kind):
    init, cls = KINDS[kind][:2]
    params, _ = init(jconfig(ARCH, smoke=True), jax.random.PRNGKey(0))
    block = cls(tconfig(ARCH, smoke=True), torch.Generator().manual_seed(0),
                "cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in block.named_parameters()}
    assert got == {k: (v.shape, str(v.dtype)) for k, v in params.items()}
    assert not any(p.requires_grad for p in block.parameters())
    for name in ("b_if", "b_gates", "norm"):
        if name in params:
            _close(getattr(block, name).float(),
                   np.asarray(params[name], np.float32))


def test_headnorm_matches_reference():
    h = _x(0, (2, 5, 3, 16)) * 4
    scale = _x(1, (48,))
    _close(tx._headnorm(torch.from_numpy(h), torch.from_numpy(scale)),
           jx._headnorm(jnp.asarray(h), jnp.asarray(scale)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunk", [4, 8, 256])
def test_mlstm_matches_reference(seed, chunk):
    """Output and final ``{c, n, m, conv}`` state at several chunks (256:
    one chunk of the whole sequence)."""
    jcfg, params, tcfg, block = _block("mlstm", seed)
    x = _x(seed + 2, (2, 16, jcfg.d_model))
    want, wst = jx.mlstm(params, jnp.asarray(x), jcfg, chunk=chunk,
                         return_state=True)
    got, gst = tx.mlstm(block, torch.from_numpy(x), tcfg, chunk=chunk,
                        return_state=True)
    _close(got, want)
    assert set(gst) == set(wst)
    for k in wst:
        _close(gst[k], wst[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slstm_matches_reference(seed):
    """Output and final ``{c, n, h, m, conv}`` state; the chunk argument
    is ignored by both."""
    jcfg, params, tcfg, block = _block("slstm", seed)
    x = _x(seed + 2, (2, 16, jcfg.d_model)) * (1 + seed)
    want, wst = jx.slstm(params, jnp.asarray(x), jcfg, return_state=True)
    got, gst = tx.slstm(block, torch.from_numpy(x), tcfg, chunk=8,
                        return_state=True)
    _close(got, want)
    assert set(gst) == set(wst)
    for k in wst:
        _close(gst[k], wst[k])


def test_slstm_step_layout_follows_a_load():
    """``r_step`` is ``r_gates`` laid out for the step, also after new
    weights are loaded."""
    _, params, _, block = _block("slstm", 3)
    r = np.asarray(params["r_gates"])
    g, h, dv, _ = r.shape
    want = r.transpose(1, 2, 0, 3).reshape(h, dv, g * dv)
    np.testing.assert_array_equal(block.r_step.numpy(), want)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("seed", [0, 1])
def test_step_over_a_sequence_matches_the_chunked_forward(kind, seed):
    """Twelve decode steps from the initial state give the reference's
    forward (mLSTM at chunk 4) position by position and its final state,
    and one step from that state equals the reference's step."""
    jcfg, params, tcfg, block = _block(kind, seed)
    jfwd, tfwd = _fn(kind, 2)
    jstep, tstep = _fn(kind, 3)
    jinit, tinit = _fn(kind, 4)
    x = _x(seed + 3, (2, 12, jcfg.d_model))
    want, wst = jfwd(params, jnp.asarray(x), jcfg, chunk=4,
                     return_state=True)
    st, jst = tinit(tcfg, 2, "cpu"), jinit(jcfg, 2)
    for k in jst:
        assert st[k].shape == jst[k].shape
        assert str(st[k].dtype).removeprefix("torch.") == str(jst[k].dtype)
        _close(st[k], jst[k])
    for t in range(12):
        out, st = tstep(block, st, torch.from_numpy(x[:, t:t + 1]), tcfg)
        _close(out, want[:, t:t + 1])
    for k in wst:
        _close(st[k], wst[k])
    nxt = _x(seed + 4, (2, 1, jcfg.d_model))
    wout, wst = jstep(params, wst, jnp.asarray(nxt), jcfg)
    gout, st = tstep(block, st, torch.from_numpy(nxt), tcfg)
    _close(gout, wout)
    for k in wst:
        _close(st[k], wst[k])


def test_mlstm_refuses_what_the_reference_refuses():
    jcfg, params, tcfg, block = _block("mlstm", 0)
    x = _x(5, (1, 12, jcfg.d_model))
    with pytest.raises(AssertionError):
        jx.mlstm(params, jnp.asarray(x), jcfg, chunk=8)
    with pytest.raises(AssertionError):
        tx.mlstm(block, torch.from_numpy(x), tcfg, chunk=8)
    assert tx.mlstm(block, torch.from_numpy(x), tcfg, chunk=16).shape \
        == x.shape
