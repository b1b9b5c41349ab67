"""Shared by ``test_torch_training.py``, ``test_torch_train_families.py``,
``test_torch_data_parallel.py`` and ``test_torch_pp.py``: one train step of
the PyTorch port held against the JAX reference's on the same weights and
batch.

Both packages run an fp32 smoke config. The reference's weights come from
its ``init_lm`` and are carried across with ``params_from_numpy``; its
gradients from ``jax.value_and_grad`` of its ``_loss_fn`` (``remat="none"``,
no mesh, as its own ``tests/test_training.py`` runs it) and its update from
its ``apply_updates``, which is its ``train_step`` at one microbatch. The
port runs ``make_grad_fn`` and ``make_train_step`` under
``remat="block"``. The port's trees go back to the reference's layout with
``params_to_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from pytest import approx

import repro.models.lm as jlm
from repro.configs import get_config as jconfig
from repro.core.config import OptimizerConfig as JOptimizerConfig
from repro.core.config import ParallelConfig as JParallelConfig
from repro.core.config import ShapeConfig as JShapeConfig
from repro.training import apply_updates as japply_updates
from repro.training import init_opt_state as jinit_opt_state
from repro.training import init_train_state as jinit_train_state
from repro.training import make_train_step as jmake_train_step
from repro.training.train_step import _loss_fn as jloss_fn
from repro_torch.configs import get_config as tconfig
from repro_torch.core.config import OptimizerConfig, ParallelConfig, \
    ShapeConfig
from repro_torch.data import SyntheticSource
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_step import make_grad_fn

SHAPE = ShapeConfig("t", 32, 2, "train")
Q_CHUNK, SSM_CHUNK = 16, 8
# loss, ce, aux and grad_norm relative; each gradient leaf's
# |g - g_ref| / |g_ref| (Frobenius); the updated parameters' abs (the
# reference's own, tests/test_training.py)
METRIC_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-4, 1e-4, 5e-3


def configs(arch: str, capacity_factor: float | None = None,
            num_experts: int | None = None):
    """The reference's and the port's smoke configs of ``arch``, in fp32
    (an MoE model's capacity factor and expert count replaced where
    given)."""
    moe = {k: v for k, v in (("capacity_factor", capacity_factor),
                             ("num_experts", num_experts)) if v is not None}
    out = []
    for get in (jconfig, tconfig):
        cfg = dataclasses.replace(get(arch, smoke=True), dtype="float32")
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   **moe))
        out.append(cfg)
    return tuple(out)


def reference_params(jcfg):
    return jax.jit(lambda key: jlm.init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))


def port_model(params, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")


def rel(a, b) -> float:
    """|a - b| / |b| in float64 (Frobenius); 0 where both are 0."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else \
        float(np.linalg.norm(a))


def leaves(tree) -> dict:
    """``{path: leaf}`` of a reference-layout tree."""
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_step(jcfg, params, batch, opt_cfg):
    """The reference's loss, metrics, gradients and updated parameters."""
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, jcfg, JParallelConfig(remat="none"),
                              Q_CHUNK, SSM_CHUNK), has_aux=True))
    (loss, metrics), grads = grad_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    new_params, _, opt_metrics = jax.jit(japply_updates, static_argnums=3)(
        params, grads, jinit_opt_state(params), opt_cfg)
    return loss, {**metrics, **opt_metrics}, grads, new_params


def check_train_step(arch: str) -> dict:
    """One train step of ``arch`` in both packages: the port's loss, ce,
    aux, tokens, grad_norm and lr against the reference's (``METRIC_RTOL``),
    every gradient leaf (``GRAD_RTOL``) and every updated parameter
    (``PARAM_ATOL``). Returns the port's gradients in the reference's
    layout."""
    jcfg, tcfg = configs(arch)
    params = reference_params(jcfg)
    batch = SyntheticSource(tcfg, SHAPE, seed=0).batch(0)
    jopt, topt = JOptimizerConfig(), OptimizerConfig()
    jl, jm, jg, jnew = reference_step(jcfg, params, batch, jopt)

    pc = ParallelConfig(remat="block")
    model = port_model(params, tcfg)
    init_train_state(tcfg, model)
    loss, metrics, grads = make_grad_fn(tcfg, pc, Q_CHUNK, SSM_CHUNK)(
        model, batch)
    state = init_train_state(tcfg, port_model(params, tcfg))
    step = make_train_step(tcfg, SHAPE, topt, pc, q_chunk=Q_CHUNK,
                           ssm_chunk=SSM_CHUNK)
    state, step_metrics = step(state, batch)

    assert rel(float(loss), float(jl)) <= METRIC_RTOL
    for k in ("ce", "aux", "tokens"):
        assert rel(float(metrics[k]), float(jm[k])) <= METRIC_RTOL, k
    for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
        assert rel(float(step_metrics[k]), float(jm.get(k, jl))) \
            <= METRIC_RTOL, k
    got = leaves(params_to_numpy(grads, tcfg))
    want = leaves(jg)
    assert set(got) == set(want)
    for path, g in want.items():
        assert rel(got[path], g) <= GRAD_RTOL, (path, rel(got[path], g))
    new = leaves(params_to_numpy(state["params"], tcfg))
    for path, p in leaves(jnew).items():
        np.testing.assert_allclose(new[path], np.asarray(p), atol=PARAM_ATOL,
                                   err_msg=path)
    return got



def port_named(tree, tcfg) -> dict:
    """A reference-layout tree as ``{port parameter name: numpy array}``."""
    model = params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu")
    return {k: p.detach().numpy().copy()
            for k, p in model.named_parameters()}


def reference_whole_batch_step(arch: str, model, batch: dict,
                               microbatches: int = 1,
                               capacity_factor: float | None = None,
                               opt: dict | None = None,
                               num_experts: int | None = None) -> dict:
    """The reference's ``make_train_step`` on the whole ``batch`` from the
    weights of the port's ``model`` (an ``LM``): its loss and metrics, its
    gradients (the mean of its microbatches', as its step accumulates
    them) and its updated parameters, the trees keyed by the port's
    parameter names. What a data-parallel or pipelined step of the port
    must give on every rank (``capacity_factor`` as in ``configs``; ``opt``
    the AdamW fields that replace the defaults; ``num_experts`` as in
    ``configs``)."""
    jcfg, tcfg = configs(arch, capacity_factor, num_experts)
    params = jax.tree.map(jnp.asarray, params_to_numpy(model, tcfg))
    rows = batch["labels"].shape[0]
    shape = JShapeConfig("t", batch["labels"].shape[1], rows, "train")
    pc = JParallelConfig(remat="none", microbatches=microbatches)
    step = jax.jit(jmake_train_step(jcfg, shape,
                                    JOptimizerConfig(**(opt or {})), pc,
                                    q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK))
    state, metrics = step(jinit_train_state(jcfg, params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    grad_fn = jax.jit(jax.grad(
        lambda p, b: jloss_fn(p, b, jcfg, pc, Q_CHUNK, SSM_CHUNK)[0]))
    n = rows // microbatches
    grads = [grad_fn(params, {k: jnp.asarray(v[i * n:(i + 1) * n])
                              for k, v in batch.items()})
             for i in range(microbatches)]
    grads = jax.tree.map(lambda *g: sum(g) / microbatches, *grads)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": port_named(grads, tcfg),
            "params": port_named(state["params"], tcfg)}


# a tensor- or sequence-parallel step against the reference's unsharded
# one, fp32: the same sums in another order (measured at most 2e-6 of a
# leaf's largest gradient, 1.2e-6 absolute on the updated weights)
TP_LOSS_RTOL, TP_GRAD_TOL, TP_PARAM_ATOL = 1e-5, 1e-5, 1e-5


def held_to_reference(outs, ref, loss_rtol=TP_LOSS_RTOL,
                      grad_tol=TP_GRAD_TOL):
    """Every rank's sharded step (``_torch_dist.tp_train_rank``'s results)
    against the reference's whole-batch step ``ref``
    (``reference_whole_batch_step``): loss and grad norm within
    ``loss_rtol`` relative, each gradient leaf within ``grad_tol`` of its
    largest magnitude, the updated parameters within ``TP_PARAM_ATOL``, and
    every leaf a rank holds whole bit-equal across the ranks."""
    for o in outs:
        assert o["loss"] == approx(ref["metrics"]["loss"], rel=loss_rtol)
        assert o["metrics"]["grad_norm"] == approx(
            ref["metrics"]["grad_norm"], rel=loss_rtol)
        assert set(o["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            err = np.abs(o["grads"][k] - want).max()
            assert err <= grad_tol * max(np.abs(want).max(), 1e-30), \
                (k, err)
        for k, want in ref["params"].items():
            np.testing.assert_allclose(o["params"][k], want,
                                       atol=TP_PARAM_ATOL, err_msg=k)
    whole = [o["whole"] for o in outs]
    assert whole[0], "no leaf is held whole"
    for w in whole[1:]:
        assert w.keys() == whole[0].keys()
        for k in w:
            assert w[k] == whole[0][k], f"{k} differs across the ranks"


# the updated shards against the reference's, under AdamW without warmup
# (``_torch_dist.PP_OPT``), where one step moves every leaf by about the
# 3e-4 rate
SHARD_PARAM_ATOL = 1e-5


def reference_moved(arch: str, model, batch: dict, **kw) -> dict:
    """``reference_whole_batch_step`` under ``_torch_dist.PP_OPT``, with
    ``moved``: how far the step moved each leaf (its largest change)."""
    import _torch_dist as D
    start = {k: p.detach().numpy().copy()
             for k, p in model.named_parameters()}
    ref = reference_whole_batch_step(arch, model, batch, opt=D.PP_OPT, **kw)
    ref["moved"] = {k: float(np.abs(p - start[k]).max())
                    for k, p in ref["params"].items()}
    return ref


def shards_held_to_reference(ranks: list, case: str, ref: dict) -> None:
    """Every rank's step of ``case`` (``_torch_dist.layout_rank``'s or
    ``pp_tp_rank``'s results) against the reference's whole-batch step
    ``ref`` (``reference_moved``): the loss and grad norm within
    ``TP_LOSS_RTOL``, each gradient shard within ``TP_GRAD_TOL`` of the
    whole leaf's largest magnitude of the same slice of the reference's
    (``convert._cuts``), each updated shard within ``SHARD_PARAM_ATOL`` of
    that slice of the reference's updated leaf, every leaf seen on some
    rank, and every leaf a rank holds whole bit-equal on every rank that
    holds it."""
    import torch

    from repro_torch.models.convert import _shard
    assert min(ref["moved"].values()) > 10 * SHARD_PARAM_ATOL, ref["moved"]
    seen = set()
    for o in ranks:
        res = o[case]
        for k in ("loss", "grad_norm"):
            assert res[k] == approx(ref["metrics"][k], rel=TP_LOSS_RTOL), k
        assert set(res["grads"]) == set(res["params"])
        for k, g in res["grads"].items():
            want = ref["grads"][k]
            part = _shard(torch.from_numpy(want), res["cuts"][k]).numpy()
            assert g.shape == part.shape, (k, g.shape, part.shape)
            err = float(np.abs(g - part).max())
            assert err <= TP_GRAD_TOL * max(float(np.abs(want).max()),
                                            1e-30), (k, err)
            new = _shard(torch.from_numpy(ref["params"][k]),
                         res["cuts"][k]).numpy()
            np.testing.assert_allclose(res["params"][k], new, rtol=0,
                                       atol=SHARD_PARAM_ATOL, err_msg=k)
            seen.add(k)
    assert seen == set(ref["params"])
    holders: dict = {}
    for o in ranks:
        for k, bits in o[case]["whole"].items():
            holders.setdefault(k, []).append(bits)
    for k, bits in holders.items():
        assert all(b == bits[0] for b in bits[1:]), k


def reference_serve(arch: str) -> dict:
    """The reference's ``forward``, prefill and decode logits of
    ``_torch_dist.serve_inputs`` on seed 0's weights of the port's smoke
    config of ``arch`` (unsharded): ``{"forward", "prefill", "decode"}``."""
    import torch

    import _torch_dist as D
    from repro_torch.models import init_lm
    jcfg, tcfg = configs(arch)
    model = init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    params = jax.tree.map(jnp.asarray, params_to_numpy(model, tcfg))
    io = D.serve_inputs(tcfg)
    inputs = {k: jnp.asarray(v) for k, v in io["inputs"].items()}
    fwd = jax.jit(lambda p, i: jlm.forward(p, i, jcfg, remat="none"))
    out = {"forward": np.asarray(fwd(params, inputs)[0])}
    state = jlm.init_decode_state(jcfg, D.BATCH, D.MAX_SEQ)
    logits, state = jax.jit(lambda p, s, i: jlm.prefill_step(p, s, i, jcfg))(
        params, state, inputs)
    out["prefill"] = np.asarray(logits)
    state["pos"] = jnp.asarray(io["pos"])
    step = jax.jit(lambda p, s, t: jlm.decode_step(p, s, t, jcfg))
    out["decode"] = []
    for tokens in io["steps"]:
        logits, state = step(params, state, jnp.asarray(tokens))
        out["decode"].append(np.asarray(logits))
    return out
