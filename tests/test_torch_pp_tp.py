"""The port's GPipe pipeline over ``pod`` with tensor, sequence and ZeRO-3
splits inside its stages (``repro_torch.parallel.pipeline`` under the
rules' ``TensorPlan``), on four spawned ``gloo`` ranks on the CPU.

Each case's rules are the planner's for its arch's packing cell
(``train_4k`` on the 2 x 16 x 16 mesh with ``pod_axis_role="pipeline"``
and 4 microbatches, ``_torch_dist.packing_rules``), laid on a mesh of
four ranks:

- llama's fp32 smoke config on ``pod=2 x model=2`` under the optimized
  profile (``seq_tp``: the sequence, ``mlp_seq`` and the vocab over
  ``model``) and under the baseline one (``seq_tp`` with ``mlp``);
- mistral-nemo-12b's (the arch of the reference's own pipeline test)
  under ``head_tp`` by override (heads, kv heads, mlp and vocab over
  ``model``);
- llama's on ``pod=2 x data=2`` with ``fsdp="on"`` (ZeRO-3: ``w_embed``
  over ``data``, the batch over ``data``).

Every case, from two seeds' weights and batches, is held against the JAX
reference's whole-batch ``make_train_step`` from the same weights (the
reference's own pipeline test fails on the installed jax), both taking
one AdamW step under ``_torch_dist.PP_OPT`` (no warmup, so every leaf
moves by about the 3e-4 rate, far above the 1e-5 the updates are held to):
the loss and grad norm within ``TP_LOSS_RTOL``, each rank's gradient
shards (after the sums within the pod) within ``TP_GRAD_TOL`` of the whole
leaf's largest magnitude of the same slice of the reference's gradients,
and its updated shards within 1e-5 of that slice of the reference's
updated leaves; against the port's
one-rank step on the whole batch: the loss and grad norm within 1e-6
relative; and every leaf a rank holds whole is bit-equal on every rank
that holds it.
"""

import numpy as np
import pytest
import torch

import _torch_dist as D
import _torch_train_parity as P
from repro_torch.models.convert import _shard

ONE_RTOL, REF_PARAM_ATOL = 1e-6, 1e-5
SEEDS = (0, 1)
CASES = [
    {"id": "llama-seq_tp-mlp_seq", "arch": "llama3.2-3b",
     "mesh": {"pod": 2, "data": 1, "model": 2}, "profile": "optimized"},
    {"id": "llama-seq_tp-mlp", "arch": "llama3.2-3b",
     "mesh": {"pod": 2, "data": 1, "model": 2}, "profile": "baseline"},
    {"id": "mistral-head_tp", "arch": "mistral-nemo-12b",
     "mesh": {"pod": 2, "data": 1, "model": 2}, "profile": "optimized",
     "override": {"attn_strategy": "head_tp"}},
    {"id": "llama-zero3", "arch": "llama3.2-3b",
     "mesh": {"pod": 2, "data": 2, "model": 1}, "profile": "optimized",
     "override": {"fsdp": "on"}},
]
IDS = [c["id"] for c in CASES]
# what each case must split inside its stages (rules over axes of size 2)
SPLITS = {"llama-seq_tp-mlp_seq": {"seq": "model", "mlp_seq": "model",
                                   "vocab": "model"},
          "llama-seq_tp-mlp": {"seq": "model", "mlp": "model",
                               "vocab": "model"},
          "mistral-head_tp": {"heads": "model", "kv_heads": "model",
                              "mlp": "model", "vocab": "model"},
          "llama-zero3": {"w_embed": "data", "batch": "data"}}


@pytest.fixture(scope="module", params=SEEDS)
def seed(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(seed, tmp_path_factory):
    return D.run_ranks(D.pp_tp_rank, 4, tmp_path_factory.mktemp("pp_tp"),
                       CASES, seed)


@pytest.fixture(scope="module")
def reference(seed):
    out = {}
    for arch in {c["arch"] for c in CASES}:
        cfg = D.smoke(arch)
        model = D.model_of(cfg, seed=seed)["params"]
        start = D.params_np(model)
        out[arch] = P.reference_whole_batch_step(
            arch, model, D.batch_of(cfg, rows=D.PP_ROWS, seed=3 + seed),
            opt=D.PP_OPT)
        out[arch]["moved"] = {k: float(np.abs(p - start[k]).max())
                              for k, p in out[arch]["params"].items()}
    return out


@pytest.fixture(scope="module")
def one_rank(seed):
    return {arch: D.single_rank(arch, seed=seed, rows=D.PP_ROWS)
            for arch in {c["arch"] for c in CASES}}


@pytest.mark.parametrize("case", IDS)
def test_rules_split_inside_the_stages(ranks, case):
    """The planner's packing rules split what the case is for, the layers
    over ``pod``, and every rank ran its stage."""
    for o in ranks:
        got = o[case]["rules"]
        assert got["layers"] == "pod"
        for k, v in SPLITS[case].items():
            assert got.get(k) == v, (case, k, got)
    assert {o[case]["stage"] for o in ranks} == {0, 1}
    if case == "llama-seq_tp-mlp_seq":
        assert "mlp" not in ranks[0][case]["rules"]


@pytest.mark.parametrize("case", IDS)
def test_pp_tp_matches_reference_whole_batch_step(ranks, reference, case):
    arch = next(c["arch"] for c in CASES if c["id"] == case)
    ref = reference[arch]
    # the step moves every leaf well beyond what the updates are held to
    assert min(ref["moved"].values()) > 10 * REF_PARAM_ATOL, ref["moved"]
    seen = set()
    for o in ranks:
        res = o[case]
        for k in ("loss", "grad_norm"):
            assert res[k] == pytest.approx(ref["metrics"][k],
                                           rel=P.TP_LOSS_RTOL), k
        for k, shard in res["params"].items():
            want = _shard(torch.from_numpy(ref["params"][k]),
                          res["cuts"][k]).numpy()
            np.testing.assert_allclose(shard, want, rtol=0,
                                       atol=REF_PARAM_ATOL, err_msg=k)
            seen.add(k)
    assert seen == set(ref["params"])


@pytest.mark.parametrize("case", IDS)
def test_pp_tp_gradients_match_reference_whole_batch_step(ranks, reference,
                                                          case):
    """Each rank's gradient of every shard it updates, after the sums within
    the pod (the pod sum of the embeddings' gradient, the sums over
    ``grad_sync_axes``, the ZeRO-3 reduce-scatter), is the same slice of
    the reference's whole-batch gradient."""
    arch = next(c["arch"] for c in CASES if c["id"] == case)
    ref = reference[arch]["grads"]
    seen = set()
    for o in ranks:
        res = o[case]
        assert set(res["grads"]) == set(res["params"])
        for k, g in res["grads"].items():
            want = ref[k]
            part = _shard(torch.from_numpy(want), res["cuts"][k]).numpy()
            assert g.shape == part.shape, (k, g.shape, part.shape)
            err = float(np.abs(g - part).max())
            assert err <= P.TP_GRAD_TOL * max(float(np.abs(want).max()),
                                              1e-30), (k, err)
            seen.add(k)
    assert seen == set(ref)


@pytest.mark.parametrize("case", IDS)
def test_pp_tp_matches_port_one_rank_step(ranks, one_rank, case):
    arch = next(c["arch"] for c in CASES if c["id"] == case)
    for o in ranks:
        assert o[case]["loss"] == pytest.approx(one_rank[arch]["loss"],
                                                rel=ONE_RTOL)
        assert o[case]["grad_norm"] == pytest.approx(
            one_rank[arch]["metrics"]["grad_norm"], rel=ONE_RTOL)


@pytest.mark.parametrize("case", IDS)
def test_whole_leaves_bit_equal_on_every_rank_that_holds_them(ranks, case):
    holders: dict = {}
    for o in ranks:
        for k, bits in o[case]["whole"].items():
            holders.setdefault(k, []).append(bits)
    assert "final_norm.scale" in holders
    assert len(holders["final_norm.scale"]) == 4
    for k, bits in holders.items():
        assert all(b == bits[0] for b in bits[1:]), k
