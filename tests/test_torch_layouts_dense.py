"""The attention, MLP and vocab layouts the reference runs under
hand-written rules and the port's ``TensorPlan`` lays out since the
sequence's reshard (``parallel.tensor.Reshard``, ``models.attention``),
on spawned ``gloo`` ranks on the CPU, fp32 smoke configs:

- ``seq_beside_heads`` (``sharding.LAYOUTS``: the sequence and the vocab
  over ``model``, the heads, kv heads and mlp over ``data``) on
  ``data=2 x model=2``: llama's and musicgen's (the audio stub's frames
  join the residual after the vocab's sum);
- ``seq_beside_vocab`` (the sequence over ``data``, the vocab and the mlp
  over ``model``: the loss sums each rank's positions) on ``data=2 x
  model=2``: llama's and internvl2's (the vision stub's patches masked
  out of the loss where a rank does not hold the whole sequence);
- ``seq_with_heads`` (heads, kv heads, mlp, vocab and the sequence over
  ``model=2``: Megatron's sequence parallelism, the block taking the
  whole sequence);
- ``kv_heads_alone`` (the kv heads over ``model=2``, the query heads
  whole: each rank computes the query heads that read its kv heads):
  llama's and qwen1.5-4b's (with the qkv biases);
- llama's ``head_tp`` as ``make_rules`` gives it on ``model=3``: 2 query
  heads a rank, groups of 3 reading one kv head, so a rank's heads read
  one kv head each (``attention._local_kv``).

and, in serving, ``forward`` and ``prefill_step`` under
``seq_beside_heads`` (llama) and ``kv_heads_alone`` (qwen), then decode
steps from rewound positions under ``kv_heads_alone``
(``_torch_dist.tp_serve_rank``), each logit within ``LOGIT_TOL`` of the
reference's unsharded ``forward``, ``prefill_step`` and ``decode_step``.

Every case, from seed 0's weights and batch, is held to the reference's
whole-batch ``make_train_step`` from the same weights under AdamW without
warmup (``_torch_train_parity.shards_held_to_reference``): loss and grad
norm within ``TP_LOSS_RTOL``, each rank's gradient shards within
``TP_GRAD_TOL`` of the same slice of the reference's, its updated shards
within 1e-5, the leaves held whole bit-equal across the ranks.
"""

import numpy as np
import pytest

import _torch_dist as D
import _torch_train_parity as P

M2, M3, D2M2 = {"data": 1, "model": 2}, {"data": 1, "model": 3}, \
    {"data": 2, "model": 2}
HEAD_TP = dict(attn_strategy="head_tp", fsdp="off", remat="block")
CASES = {
    2: [{"id": "seq_with_heads/llama", "arch": "llama3.2-3b", "mesh": M2,
         "layout": "seq_with_heads"},
        {"id": "kv_heads_alone/llama", "arch": "llama3.2-3b", "mesh": M2,
         "layout": "kv_heads_alone"},
        {"id": "kv_heads_alone/qwen", "arch": "qwen1.5-4b", "mesh": M2,
         "layout": "kv_heads_alone"}],
    3: [{"id": "head_tp-model3/llama", "arch": "llama3.2-3b", "mesh": M3,
         "pc": HEAD_TP}],
    4: [{"id": "seq_beside_heads/llama", "arch": "llama3.2-3b",
         "mesh": D2M2, "layout": "seq_beside_heads"},
        {"id": "seq_beside_heads/musicgen", "arch": "musicgen-medium",
         "mesh": D2M2, "layout": "seq_beside_heads"},
        {"id": "seq_beside_vocab/llama", "arch": "llama3.2-3b",
         "mesh": D2M2, "layout": "seq_beside_vocab"},
        {"id": "seq_beside_vocab/internvl2", "arch": "internvl2-1b",
         "mesh": D2M2, "layout": "seq_beside_vocab"}]}
SERVE = {
    2: [{"id": "serve/kv_heads_alone/qwen", "arch": "qwen1.5-4b",
         "mesh": M2, "layout": "kv_heads_alone",
         "serve_layout": "kv_heads_alone"}],
    4: [{"id": "serve/seq_beside_heads/llama", "arch": "llama3.2-3b",
         "mesh": D2M2, "layout": "seq_beside_heads",
         "serve_layout": "kv_heads_alone"}]}
PARAMS = [(w, c["id"]) for w, cases in CASES.items() for c in cases]
CASE = {c["id"]: c for cases in CASES.values() for c in cases}
SERVE_PARAMS = [(w, c["id"], c["arch"]) for w, cases in SERVE.items()
                for c in cases]
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("layouts_dense")
    return {w: D.run_ranks(D.layout_rank, w, root, cases, 0,
                           SERVE.get(w, ()))
            for w, cases in CASES.items()}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch in {c["arch"] for c in CASE.values()}:
        cfg = D.smoke(arch)
        out[arch] = P.reference_moved(arch, D.model_of(cfg)["params"],
                                      D.batch_of(cfg, seed=3))
    return out


def test_head_tp_on_three_ranks_splits_the_kv_groups(ranks):
    """``make_rules`` splits llama's 6 query heads over ``model=3`` and
    leaves its 2 kv heads whole: a rank's 2 query heads are neither whole
    groups of 3 nor within one group."""
    rules = ranks[3][0]["head_tp-model3/llama"]["rules"]
    assert rules["heads"] == "model" and "kv_heads" not in rules


@pytest.mark.parametrize("world,case", PARAMS)
def test_layout_matches_reference_whole_batch_step(ranks, reference, world,
                                                   case):
    P.shards_held_to_reference(ranks[world], case,
                               reference[CASE[case]["arch"]])


@pytest.mark.parametrize("world,case,arch", SERVE_PARAMS)
def test_layout_serving_matches_reference(ranks, world, case, arch):
    want = P.reference_serve(arch)
    for o in ranks[world]:
        res = o[case]
        for name in ("forward", "prefill"):
            np.testing.assert_allclose(res[name], want[name],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=name)
        for i, (got, w) in enumerate(zip(res["decode"], want["decode"])):
            np.testing.assert_allclose(got, w, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=f"step {i}")
