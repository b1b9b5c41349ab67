"""The MoE, Mamba and xLSTM models of the port under the production rule
sets the planner gives them (``repro_torch.parallel.strategies.
make_rules``), on spawned ``gloo`` ranks on the CPU, against the JAX
reference's unsharded train step, ``forward``, ``prefill_step`` and
``decode_step`` on the same weights (seed 0's, fp32 smoke configs).

Train cases, on 2 ranks (``model=2``) and 4 (``data=2 x model=2``):

- moonshot under ``head_tp`` with its experts over ``model`` and the
  all-to-all (``moe_impl="shard_map_a2a"``: its ``train_4k`` layout);
- granite and jamba under ``seq_tp`` + ``mlp_seq`` + the all-to-all
  (jamba with ``inner`` over ``model`` as well: their 2 x 16 x 16
  ``train_4k`` and ``prefill_32k`` layouts);
- xlstm with ``vocab`` and ``inner`` over ``model``;
- granite and xlstm under ``pure_dp`` (ZeRO-3 over the whole mesh, granite
  on ``moe_impl="shard_map_local"``; their 16 x 16 ``train_4k``
  layout), granite also with ``zero2`` and ``regather``.

The MoE layers run at the drop-free capacity factor ``E / top_k`` in
both packages: the all-to-all dispatches each rank's block of the
sequence at that block's capacity, the reference's unsharded ``moe``
whole chunks at theirs, and only where neither drops do the two compute
the same (``tests/test_torch_ep.py`` holds the drops at 1.25 against the
reference's ``moe_shard_map``).

Serve cases: ``forward`` and ``prefill_step`` under the
``prefill_32k``-shaped rules, then decode steps from rewound positions
under the ``decode_32k`` rules (jamba: ``decode_kv_shard`` with the
experts over ``model`` on the ``gather`` plane; jamba and xlstm with
``inner`` over ``model``), and under ``long_500k``'s (``inner`` and the cache over
``("data", "model")``: the prefill's recurrent states gathered and cut
to the decode state's blocks; on xlstm's 4 ranks a rank holds half a
head's value features).

Held: the loss and grad norm within ``P.TP_LOSS_RTOL`` relative, every
gradient leaf within ``P.TP_GRAD_TOL`` of its largest magnitude, the
updated parameters within ``P.TP_PARAM_ATOL``, every leaf a rank holds
whole bit-equal across the ranks, and every logit within ``LOGIT_TOL``:
the same sums in another order, in fp32.
"""

import functools

import numpy as np
import pytest

import _torch_dist as D
import _torch_train_parity as P

LOGIT_TOL = 1e-4

M2 = {"data": 1, "model": 2}
D2M2 = {"data": 2, "model": 2}
HEAD_A2A = dict(attn_strategy="head_tp", moe_strategy="shard_map_a2a",
                fsdp="off", remat="block")
SEQ_A2A = dict(attn_strategy="seq_tp", moe_strategy="shard_map_a2a",
               mlp_mode="seq", fsdp="off", remat="block")
INNER = dict(fsdp="off", remat="block")
PURE_DP = dict(layout="pure_dp", attn_strategy="replicated", fsdp="on",
               remat="dots")
DECODE = dict(attn_strategy="decode_kv_shard", moe_strategy="gather",
              fsdp="off")
# E / top_k: no expert's slots ever fill (smoke configs: moonshot 8 / 2,
# granite and jamba 4 / 2)
FREE = {"moonshot-v1-16b-a3b": 4.0, "granite-moe-1b-a400m": 2.0,
        "jamba-v0.1-52b": 2.0}


def _case(id_, arch, mesh, pc, **kw):
    return dict(id=id_, arch=arch, mesh=mesh, pc=pc,
                capacity_factor=FREE.get(arch), **kw)


TRAIN = {
    2: [_case("head_tp-a2a-moonshot", "moonshot-v1-16b-a3b", M2, HEAD_A2A),
        _case("seq_tp-a2a-granite", "granite-moe-1b-a400m", M2, SEQ_A2A),
        _case("seq_tp-a2a-inner-jamba", "jamba-v0.1-52b", M2, SEQ_A2A),
        _case("inner-xlstm", "xlstm-1.3b", M2, INNER),
        _case("pure_dp-granite", "granite-moe-1b-a400m",
              {"data": 2, "model": 1}, PURE_DP),
        _case("pure_dp-xlstm", "xlstm-1.3b", {"data": 2, "model": 1},
              PURE_DP)],
    4: [_case("head_tp-a2a-dp2-moonshot", "moonshot-v1-16b-a3b", D2M2,
              HEAD_A2A, mask_rows=1),
        _case("seq_tp-a2a-inner-dp2-jamba", "jamba-v0.1-52b", D2M2,
              SEQ_A2A),
        _case("inner-dp2-xlstm", "xlstm-1.3b", D2M2, INNER),
        _case("pure_dp-zero2-granite", "granite-moe-1b-a400m", D2M2,
              dict(PURE_DP, zero2=True), regather=True)],
}
SERVE = {
    2: [_case("decode-jamba", "jamba-v0.1-52b", M2, SEQ_A2A,
              serve_pc=DECODE),
        _case("decode-xlstm", "xlstm-1.3b", M2, INNER, serve_pc=DECODE)],
    4: [_case("long_500k-jamba", "jamba-v0.1-52b", D2M2, SEQ_A2A,
              serve_pc=DECODE, shape_name="long_500k"),
        _case("long_500k-xlstm", "xlstm-1.3b", D2M2, INNER,
              serve_pc=DECODE, shape_name="long_500k")],
}
TRAIN_PARAMS = [(w, c) for w, cases in TRAIN.items() for c in cases]
SERVE_PARAMS = [(w, c) for w, cases in SERVE.items() for c in cases]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in (2, 4):
        got = D.run_ranks(D.tp_rank, world, tmp_path_factory.mktemp(
            f"fam{world}"), TRAIN[world], SERVE[world], 5)
        for kind in ("train", "serve"):
            out[(kind, world)] = [r[kind] for r in got]
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str, mask_rows: int, capacity_factor) -> dict:
    """The reference's step on the whole batch from seed 0's weights: its
    ``_loss_fn``'s value and gradients and ``apply_updates`` (its train
    step at one microbatch, compiled once less), keyed as
    ``P.reference_whole_batch_step`` keys its results."""
    import jax
    import jax.numpy as jnp

    from repro.core.config import OptimizerConfig as JOptimizerConfig
    from repro_torch.models.convert import params_to_numpy
    jcfg, tcfg = P.configs(arch, capacity_factor)
    params = jax.tree.map(jnp.asarray, params_to_numpy(
        D.model_of(tcfg)["params"], tcfg))
    loss, metrics, grads, new = P.reference_step(
        jcfg, params, D.batch_of(tcfg, mask_rows), JOptimizerConfig())
    return {"metrics": {"loss": float(loss),
                        "grad_norm": float(metrics["grad_norm"])},
            "grads": P.port_named(grads, tcfg),
            "params": P.port_named(new, tcfg)}


@pytest.mark.parametrize("world,case", TRAIN_PARAMS,
                         ids=[f"{w}ranks-{c['id']}" for w, c in TRAIN_PARAMS])
def test_family_train_step_matches_reference(ranks, world, case):
    outs = [r[case["id"]] for r in ranks[("train", world)]]
    P.held_to_reference(outs, _reference(
        case["arch"], case.get("mask_rows", 0), case["capacity_factor"]))
    rules = outs[0]["rules"]
    if case["arch"] in ("jamba-v0.1-52b", "xlstm-1.3b") \
            and case["pc"].get("layout") != "pure_dp":
        assert rules["inner"] == "model"
    if "a2a" in case["id"]:
        assert rules["moe_impl"] == "shard_map_a2a"
        assert rules["expert"] == "model"
    if case["id"] == "pure_dp-granite":
        assert rules["moe_impl"] == "shard_map_local"


def _reference_serve(case):
    """The reference's prefill and decode logits of the case's inputs on
    seed 0's weights (unsharded)."""
    import jax
    import jax.numpy as jnp
    import torch

    import repro.models.lm as jlm
    from repro_torch.models import init_lm
    from repro_torch.models.convert import params_to_numpy
    jcfg, tcfg = P.configs(case["arch"], case["capacity_factor"])
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


@pytest.mark.parametrize("world,case", SERVE_PARAMS,
                         ids=[f"{w}ranks-{c['id']}" for w, c in SERVE_PARAMS])
def test_family_prefill_and_decode_match_reference(ranks, world, case):
    want = _reference_serve(case)
    outs = [r[case["id"]] for r in ranks[("serve", world)]]
    _, decode_rules = outs[0]["rules"]
    if case.get("shape_name") == "long_500k":
        assert decode_rules["inner"] == ("data", "model")
        assert decode_rules["batch"] is None
    else:
        assert decode_rules["inner"] == "model"
    if case["arch"] != "xlstm-1.3b":
        assert decode_rules["expert"] == "model"
        assert decode_rules.get("moe_impl") is None
    for o in outs:
        for name in ("forward", "prefill"):
            np.testing.assert_allclose(o[name], want[name], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=name)
        for i, (got, w) in enumerate(zip(o["decode"], want["decode"])):
            np.testing.assert_allclose(got, w, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=f"step {i}")
