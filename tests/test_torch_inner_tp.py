"""The Mamba, mLSTM and sLSTM blocks of the port under the inner split
(``repro_torch.models.ssm`` and ``.xlstm`` under a ``TensorPlan`` whose
rules split ``inner``) on spawned ``gloo`` ranks on the CPU, against the
JAX reference's unsharded blocks on the same seeded leaves and inputs.

Leaves: the port's blocks from seed 0 (jamba's smoke config for Mamba,
xlstm's for mLSTM and sLSTM, fp32); ``x``, the loss's weights ``g`` and
a step's input drawn with numpy from seed 9. Each rank keeps its shards
(``in_proj`` / ``up`` as two halves, ``convert.shard_params``), runs the
block forward with its final state, the gradient of ``sum(out * g)``,
and one ``*_step`` from that state. Cases:

- ``inner`` over ``model=2`` (an xlstm rank holds one whole head of two);
- ``inner`` over ``("data", "model")`` on 4 ranks, ``long_500k``'s layout
  (an xlstm rank holds half a head's value features, so its head norm
  sums over the ranks);
- Mamba under ``seq_tp`` (``seq`` and ``inner`` over ``model``, jamba's
  ``train_4k`` / ``prefill_32k`` layout), on 2 ranks and on ``data=2 x
  model=2`` with the batch over ``data``.

Held: the output, the final state and the step's output and state
gathered whole, ``x``'s gradient and every leaf's gradient (summed over
the axes the train step sums it over: the sLSTM's ``r_gates`` over the
inner axes) within ``TOL`` of each array's largest magnitude (at least
1): the same sums in another order, in fp32.
"""

import numpy as np
import pytest

import _torch_dist as D

TOL = 1e-5
B, S, CHUNK = 4, 32, 8
KINDS = ("mamba", "mlstm", "slstm")
M2, D2M2 = {"data": 1, "model": 2}, {"data": 2, "model": 2}
CASES = {
    2: [{"id": f"{k}-model2", "kind": k, "mesh": M2,
         "rules": {"inner": "model"}} for k in KINDS]
    + [{"id": "mamba-seq_tp", "kind": "mamba", "mesh": M2,
        "rules": {"seq": "model", "inner": "model", "vocab": "model"}}],
    4: [{"id": f"{k}-data-model", "kind": k, "mesh": D2M2,
         "rules": {"inner": ("data", "model")}} for k in KINDS]
    + [{"id": "mamba-seq_tp-dp2", "kind": "mamba", "mesh": D2M2,
        "rules": {"batch": "data", "seq": "model", "inner": "model",
                  "vocab": "model"}}],
}
PARAMS = [(w, c) for w, cases in CASES.items() for c in cases]


def _arrays(path):
    rng = np.random.default_rng(9)
    arrays = {}
    for kind in KINDS:
        cfg = D.smoke(D.BLOCK_ARCH[kind])
        block = D.block_module(kind, cfg)[0]
        for leaf, p in block.named_parameters():
            arrays[f"{kind}/{leaf}"] = p.detach().numpy()
        for name, s in (("x", S), ("g", S), ("x1", 1)):
            arrays[f"{kind}/{name}"] = rng.standard_normal(
                (B, s, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


def _reference(arrays) -> dict:
    """The reference's unsharded block: output, final state, the
    gradients of ``sum(out * g)``, and one step from the state."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import ssm, xlstm
    fns = {"mamba": (ssm.mamba, ssm.mamba_step),
           "mlstm": (xlstm.mlstm, xlstm.mlstm_step),
           "slstm": (xlstm.slstm, xlstm.slstm_step)}
    out = {}
    for kind in KINDS:
        cfg = dataclasses.replace(get_config(D.BLOCK_ARCH[kind], smoke=True),
                                  dtype="float32")
        fwd, step = fns[kind]
        leaves = D.block_module(kind, D.smoke(D.BLOCK_ARCH[kind]))[0]
        params = {k: jnp.asarray(arrays[f"{kind}/{k}"])
                  for k, _ in leaves.named_parameters()}
        x, g = jnp.asarray(arrays[f"{kind}/x"]), jnp.asarray(
            arrays[f"{kind}/g"])
        kw = {"chunk": CHUNK} if kind != "slstm" else {}

        def loss(p, x):
            y, state = fwd(p, x, cfg, return_state=True, **kw)
            return jnp.sum(y * g), (y, state)

        (_, (y, state)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
        y1, state1 = jax.jit(lambda p, s, x: step(p, s, x, cfg))(
            params, state, jnp.asarray(arrays[f"{kind}/x1"]))
        out[kind] = {"y": np.asarray(y), "dx": np.asarray(gx),
                     "grads": {k: np.asarray(v) for k, v in gp.items()},
                     "state": {k: np.asarray(v) for k, v in state.items()},
                     "step": np.asarray(y1),
                     "step_state": {k: np.asarray(v)
                                    for k, v in state1.items()}}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("inner")
    path = root / "arrays.npz"
    _arrays(path)
    ranks = {w: D.run_ranks(D.inner_rank, w, root, cases, str(path), CHUNK)
             for w, cases in CASES.items()}
    return ranks, _reference(dict(np.load(path)))


def _close(got, want, what):
    """Within ``TOL`` of ``want``'s largest magnitude (at least 1)."""
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape, (what, np.shape(got),
                                                 want.shape)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1.0), (what, err)


@pytest.mark.parametrize("world,case", PARAMS,
                         ids=[f"{w}ranks-{c['id']}" for w, c in PARAMS])
def test_block_under_inner_split_matches_reference(results, world, case):
    ranks, ref = results
    want = ref[case["kind"]]
    for r in ranks[world]:
        o = r[case["id"]]
        _close(o["y"], want["y"], "y")
        _close(o["dx"], want["dx"], "dx")
        assert set(o["grads"]) == set(want["grads"])
        for leaf, g in o["grads"].items():
            _close(g, want["grads"][leaf], f"grad {leaf}")
        for k, v in want["state"].items():
            _close(o["state"][k], v, f"state {k}")
        if "step" in o:
            _close(o["step"], want["step"], "step")
            for k, v in want["step_state"].items():
                _close(o["step_state"][k], v, f"step state {k}")
    if "seq_tp" in case["id"]:
        assert "step" not in ranks[world][0][case["id"]]
