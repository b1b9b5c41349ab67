"""Tensor and sequence parallelism of the port (``repro_torch.parallel.
tensor`` and the model under it) on spawned ``gloo`` ranks on the CPU,
against the JAX reference's unsharded train step, ``forward``,
``prefill_step`` and ``decode_step`` on the same weights: what GSPMD's
sharded result is.

Each rank builds seed 0's whole model, keeps its shards
(``convert.shard_params``) under the planner's ``make_rules`` for the
case's mesh and strategy, and runs; the gradients and updated parameters
come back whole (``convert.gather_named``). Cases, on 2 ranks
(``model=2``) and 4 (``data=2 x model=2``, or ``model=4``):

- ``head_tp``: heads, kv heads, ``mlp`` and ``vocab`` over ``model``; on
  ``model=4`` mistral's two kv heads do not divide, so each rank keeps the
  kv heads its query heads read;
- ``seq_tp`` under ``mlp=model`` and ``mlp_seq``, with and without
  ``kv_compress`` (the int8 KV wire), llama and the vision stub
  (internvl2);
- ``decode_kv_shard``: a prefill under ``seq_tp`` (or ``head_tp``) into a
  cache split along its sequence over ``model`` (over ``("data",
  "model")`` under ``long_500k``'s rules), then decode steps from
  positions that differ by row.

Held, in fp32 smoke configs: the loss within ``LOSS_RTOL`` relative, every
gradient leaf within ``GRAD_TOL`` of its largest magnitude, the updated
parameters within ``P.TP_PARAM_ATOL`` absolute, and every leaf a rank holds
whole bit-equal across the ranks; logits within ``LOGIT_TOL``. Under
``kv_compress`` the keys and values cross the wire rounded to int8 (each
row's error at most its absmax / 254), which the unsharded reference does
not do: the loss within ``INT8_LOSS_RTOL`` and the gradients within
``INT8_GRAD_TOL``. The int8 gather itself is held to its math.
"""

import numpy as np
import pytest

import _torch_dist as D
import _torch_train_parity as P

LOSS_RTOL, GRAD_TOL = P.TP_LOSS_RTOL, P.TP_GRAD_TOL
INT8_LOSS_RTOL, INT8_GRAD_TOL = 5e-3, 5e-2
LOGIT_TOL = 1e-4

HEAD = dict(attn_strategy="head_tp", fsdp="off", remat="block")
SEQ_MLP = dict(attn_strategy="seq_tp", fsdp="off", remat="block",
               mlp_mode="tp")
SEQ_MLP_SEQ_INT8 = dict(attn_strategy="seq_tp", fsdp="off", remat="none",
                        mlp_mode="seq", kv_compress=True)
DECODE = dict(attn_strategy="decode_kv_shard", fsdp="off")
M2 = {"data": 1, "model": 2}
D2M2 = {"data": 2, "model": 2}

TRAIN = {
    2: [{"id": "head_tp-llama", "arch": "llama3.2-3b", "mesh": M2,
         "pc": HEAD},
        {"id": "head_tp-mistral", "arch": "mistral-nemo-12b", "mesh": M2,
         "pc": HEAD},
        {"id": "seq_tp-mlp-llama", "arch": "llama3.2-3b", "mesh": M2,
         "pc": SEQ_MLP},
        {"id": "seq_tp-mlp_seq-int8-llama", "arch": "llama3.2-3b",
         "mesh": M2, "pc": SEQ_MLP_SEQ_INT8},
        {"id": "seq_tp-mlp_seq-mistral", "arch": "mistral-nemo-12b",
         "mesh": M2, "pc": dict(SEQ_MLP_SEQ_INT8, kv_compress=False)},
        {"id": "seq_tp-mlp-int8-internvl2", "arch": "internvl2-1b",
         "mesh": M2, "pc": dict(SEQ_MLP, kv_compress=True)}],
    4: [{"id": "seq_tp-dp2-llama", "arch": "llama3.2-3b", "mesh": D2M2,
         "pc": SEQ_MLP, "mask_rows": 1},
        {"id": "seq_tp-mlp_seq-int8-dp2-llama", "arch": "llama3.2-3b",
         "mesh": D2M2, "pc": SEQ_MLP_SEQ_INT8},
        {"id": "head_tp-model4-mistral", "arch": "mistral-nemo-12b",
         "mesh": {"data": 1, "model": 4}, "pc": HEAD}],
}
SERVE = {
    2: [{"id": "decode-llama", "arch": "llama3.2-3b", "mesh": M2,
         "pc": SEQ_MLP, "serve_pc": DECODE},
        {"id": "decode-after-head_tp-mistral", "arch": "mistral-nemo-12b",
         "mesh": M2, "pc": HEAD, "serve_pc": DECODE}],
    4: [{"id": "long_500k-mistral", "arch": "mistral-nemo-12b",
         "mesh": D2M2, "pc": SEQ_MLP, "serve_pc": DECODE,
         "shape_name": "long_500k"},
        {"id": "decode-dp2-qwen2", "arch": "qwen2-72b", "mesh": D2M2,
         "pc": SEQ_MLP, "serve_pc": DECODE}],
}
TRAIN_PARAMS = [(w, c) for w, cases in TRAIN.items() for c in cases]
SERVE_PARAMS = [(w, c) for w, cases in SERVE.items() for c in cases]


INT8_SEED = 5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in (2, 4):
        got = D.run_ranks(D.tp_rank, world, tmp_path_factory.mktemp(
            f"tp{world}"), TRAIN[world], SERVE[world], INT8_SEED)
        for kind in ("train", "serve", "int8"):
            out[(kind, world)] = [r[kind] for r in got]
    return out


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch, mask in {(c["arch"], c.get("mask_rows", 0))
                       for _, c in TRAIN_PARAMS}:
        cfg = D.smoke(arch)
        out[(arch, mask)] = P.reference_whole_batch_step(
            arch, D.model_of(cfg)["params"], D.batch_of(cfg, mask))
    return out


@pytest.mark.parametrize("world,case", TRAIN_PARAMS,
                         ids=[f"{w}ranks-{c['id']}" for w, c in TRAIN_PARAMS])
def test_tp_train_step_matches_reference(ranks, reference, world, case):
    outs = [r[case["id"]] for r in ranks[("train", world)]]
    ref = reference[(case["arch"], case.get("mask_rows", 0))]
    int8 = case["pc"].get("kv_compress", False)
    P.held_to_reference(outs, ref, INT8_LOSS_RTOL if int8 else LOSS_RTOL,
                       INT8_GRAD_TOL if int8 else GRAD_TOL)
    rules = outs[0]["rules"]
    if case["pc"]["attn_strategy"] == "seq_tp":
        assert rules["seq"] == "model"
        assert (rules["mlp_seq"] == "model") == (case["pc"]["mlp_mode"]
                                                 == "seq")
    else:
        assert rules["heads"] == "model"


@pytest.mark.parametrize("world,case", SERVE_PARAMS,
                         ids=[f"{w}ranks-{c['id']}" for w, c in SERVE_PARAMS])
def test_tp_prefill_and_decode_match_reference(ranks, world, case):
    want = P.reference_serve(case["arch"])
    outs = [r[case["id"]] for r in ranks[("serve", world)]]
    prefill_rules, decode_rules = outs[0]["rules"]
    cache = decode_rules["cache_seq"]
    if case.get("shape_name") == "long_500k":
        assert cache == ("data", "model") and decode_rules["batch"] is None
        assert decode_rules["vocab"] == ("data", "model")
    else:
        assert cache == "model"
    n = 4 if cache == ("data", "model") else 2
    for o in outs:
        assert o["cache_rows"] == D.MAX_SEQ // n
        for name in ("forward", "prefill"):
            np.testing.assert_allclose(o[name], want[name], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=name)
        for i, (got, w) in enumerate(zip(o["decode"], want["decode"])):
            np.testing.assert_allclose(got, w, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("world", [2, 4])
def test_int8_gather_matches_its_math(ranks, world):
    """The twin of the reference's ``_int8_broadcast``: each rank's block
    quantized per row of the last dimension (absmax / 127), gathered and
    dequantized, within 1/254 of each row's largest magnitude of the exact
    gather and within 0.02 of the tensor's; its gradient the sum over the
    ranks of their gradients' blocks (straight through)."""
    outs = ranks[("int8", world)]
    exact = outs[0]["exact"]
    row_max = np.abs(exact).max(axis=-1, keepdims=True)
    grads = sum(o["w"] for o in outs)
    for r, o in enumerate(outs):
        err = np.abs(o["got"] - exact)
        assert (err <= row_max / 254 * (1 + 1e-5) + 1e-7).all()
        assert err.max() <= 0.02 * np.abs(exact).max()
        np.testing.assert_allclose(
            o["grad"], grads[:, 5 * r:5 * (r + 1)], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(o["got"], outs[0]["got"])


DENSE_ARCHS = ("llama3.2-3b", "qwen1.5-4b", "mistral-nemo-12b", "qwen2-72b",
               "internvl2-1b", "musicgen-medium")


def test_require_executable_admits_every_dense_cell():
    """Every (arch x shape) cell the port's planner lays out on the
    reference's 16 x 16 and 2 x 16 x 16 planning meshes is admitted: the
    six dense attention models' 48 cells and, since the expert and inner
    splits run, the 32 of the MoE, Mamba and xLSTM models. The layouts
    seen: ``pure_dp`` (replicated attention), ``seq_tp``,
    ``decode_kv_shard``, ``head_tp`` (moonshot's train and prefill) and
    no attention at all (xlstm); the MoE planes ``shard_map_a2a``,
    ``shard_map_local`` and ``gather``; ``inner`` over ``model`` and over
    ``("data", "model")``."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.config import SHAPES
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.parallel.strategies import make_rules, plan_cell
    admitted, strategies, planes, inner = [], set(), set(), set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            for multi_pod in (False, True):
                mesh = make_production_mesh(multi_pod=multi_pod)
                pc = plan_cell(cfg, shape, mesh)
                rules = make_rules(mesh, cfg, shape, pc)
                require_executable(rules, cfg=cfg)
                admitted.append((arch, shape.name, multi_pod))
                strategies.add((pc.layout, pc.attn_strategy))
                if cfg.moe is not None:
                    planes.add(rules.rules.get("moe_impl") or "gather")
                inner.add(rules.rules.get("inner"))
    assert len(admitted) == 80
    assert {a for a, _, _ in admitted} == set(ARCH_IDS) >= set(DENSE_ARCHS)
    assert strategies == {("pure_dp", "replicated"), ("tp", "seq_tp"),
                          ("tp", "decode_kv_shard"), ("tp", "head_tp"),
                          ("tp", "none")}
    assert planes == {"shard_map_a2a", "shard_map_local", "gather"}
    assert inner == {None, "model", ("data", "model")}
