"""ZeRO-3 of the port (``w_embed`` over ``data`` under the ``tp`` layout
with ``fsdp=on``, over the whole mesh under ``pure_dp``) and ``zero2`` with
``regather`` (each ``w_embed`` shard gathered once a step and kept through
the microbatches), on spawned ``gloo`` ranks on the CPU, against the JAX
reference's unsharded ``make_train_step`` on the same weights and batch.

Each rank keeps its 1/n slice of the embed dimension of every weight
matrix (``convert.shard_params``) and its optimizer state follows it; the
gradients and updated parameters come back whole (``convert.
gather_named``). On 4 ranks ``pure_dp`` with 2 microbatches splits each
microbatch's 2 rows over ``data`` only, while ``w_embed`` spans ``data``
and ``model``: the ``model`` ranks repeat each other's rows, and their
gathers' gradients are summed once, not twice (``TensorPlan.repeats``).

Held, in fp32 smoke configs, as ``test_torch_tp.py`` holds its cases: the
loss and the global gradient norm within ``TP_LOSS_RTOL`` relative, every
gradient leaf within ``TP_GRAD_TOL`` of its largest magnitude, the updated
parameters within ``TP_PARAM_ATOL`` absolute (each rank's slice of the master
weights, gathered), and every leaf a rank holds whole bit-equal across
the ranks (``_torch_train_parity.held_to_reference``).
"""

import pytest

import _torch_dist as D
import _torch_train_parity as P

ZERO3 = dict(attn_strategy="replicated", layout="tp", fsdp="on",
             remat="block")
PURE_DP = dict(attn_strategy="replicated", layout="pure_dp", fsdp="off",
               remat="dots")
ZERO2 = dict(PURE_DP, zero2=True, microbatches=2)

CASES = {
    2: [{"id": "zero3-data-llama", "arch": "llama3.2-3b",
         "mesh": {"data": 2, "model": 1}, "pc": ZERO3},
        {"id": "pure_dp-llama", "arch": "llama3.2-3b",
         "mesh": {"data": 2, "model": 1}, "pc": PURE_DP, "mask_rows": 1},
        {"id": "zero2-regather-llama", "arch": "llama3.2-3b",
         "mesh": {"data": 2, "model": 1}, "pc": ZERO2, "regather": True},
        {"id": "pure_dp-musicgen", "arch": "musicgen-medium",
         "mesh": {"data": 2, "model": 1}, "pc": PURE_DP}],
    4: [{"id": "pure_dp-full-mesh-mistral", "arch": "mistral-nemo-12b",
         "mesh": {"data": 2, "model": 2}, "pc": PURE_DP},
        {"id": "zero3-data-seq_tp-llama", "arch": "llama3.2-3b",
         "mesh": {"data": 2, "model": 2},
         "pc": dict(attn_strategy="seq_tp", fsdp="on", remat="block",
                    mlp_mode="tp")},
        {"id": "zero2-regather-full-mesh-qwen1.5", "arch": "qwen1.5-4b",
         "mesh": {"data": 2, "model": 2}, "pc": ZERO2, "regather": True}],
}
PARAMS = [(w, c) for w, cases in CASES.items() for c in cases]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: D.run_ranks(D.tp_train_rank, w,
                           tmp_path_factory.mktemp(f"zero{w}"), cases)
            for w, cases in CASES.items()}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch, mask, mb in {(c["arch"], c.get("mask_rows", 0),
                            c["pc"].get("microbatches", 1))
                           for _, c in PARAMS}:
        cfg = D.smoke(arch)
        out[(arch, mask, mb)] = P.reference_whole_batch_step(
            arch, D.model_of(cfg)["params"], D.batch_of(cfg, mask), mb)
    return out


@pytest.mark.parametrize("world,case", PARAMS,
                         ids=[f"{w}ranks-{c['id']}" for w, c in PARAMS])
def test_zero_step_matches_reference(ranks, reference, world, case):
    outs = [r[case["id"]] for r in ranks[world]]
    ref = reference[(case["arch"], case.get("mask_rows", 0),
                     case["pc"].get("microbatches", 1))]
    P.held_to_reference(outs, ref)
    rules = outs[0]["rules"]
    if case["pc"].get("layout") == "pure_dp":
        assert rules["w_embed"] == tuple(case["mesh"])
    else:
        assert rules["w_embed"] == "data"


def test_planner_prices_what_the_train_step_keeps():
    """The planner's fixed bytes of a training cell (``state_multiplier``
    times the exact parameter bytes) hold every tensor the port's train step
    keeps through a microbatch: the weights, AdamW's fp32 master, m and v,
    the fp32 gradient accumulators, and the largest transient (one leaf's
    gradient in the weights' dtype and its fp32 quotient; the others are
    added to the accumulators and dropped as autograd makes them). On
    llama's smoke config in bf16 at 2 microbatches; the reference's 16 B a
    parameter (its figures, ``accum_bytes`` 0) does not hold them."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.config import (OptimizerConfig, ParallelConfig,
                                         ShapeConfig)
    from repro_torch.device import H100_SXM
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import init_lm
    from repro_torch.parallel.strategies import (exact_param_bytes_per_chip,
                                                 make_rules, state_multiplier)
    from repro_torch.training import init_train_state, make_train_step

    cfg = get_config("llama3.2-3b", smoke=True)
    assert cfg.dtype == "bfloat16"
    shape = ShapeConfig("t", D.SEQ, D.BATCH, "train")
    pc = ParallelConfig(remat="block", microbatches=2, fsdp="off",
                        attn_strategy="replicated", layout="tp")
    rules = make_rules(make_smoke_mesh(), cfg, shape, pc)
    param_bytes = exact_param_bytes_per_chip(cfg, rules)
    state = init_train_state(cfg, init_lm(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    step = make_train_step(cfg, shape, OptimizerConfig(), pc, rules=rules)
    _, _, grads = step.grad_step(state["params"], D.batch_of(cfg))

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    params = dict(state["params"].named_parameters())
    assert {g.dtype for g in grads.values()} == {torch.float32}
    transient = max(p.numel() * (p.element_size() + 4)
                    for p in params.values())
    kept = nbytes(params) + nbytes(state["opt"]) + nbytes(grads) + transient
    assert nbytes(params) == param_bytes
    assert param_bytes * state_multiplier(shape) >= kept
    reference = dataclasses.replace(H100_SXM, accum_bytes=0.0)
    assert state_multiplier(shape, reference) == 8.0
    assert param_bytes * state_multiplier(shape, reference) < kept
