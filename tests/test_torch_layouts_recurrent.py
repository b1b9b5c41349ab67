"""The recurrent blocks' inner split beside a sequence split over other
axes (``sharding.LAYOUTS["inner_beside_seq"]``: the sequence over
``data``, the inner features and the vocab over ``model``), which the
port's ``TensorPlan`` lays out since the sequence's reshard
(``parallel.tensor.Reshard``: each block gathers the sequence, its input
enters the inner ranks through ``copy_to``, and its summed output is cut
to the rank's positions), on spawned ``gloo`` ranks on the CPU, fp32
smoke configs:

- jamba's (Mamba, attention, dense and MoE FFNs, the experts whole) and
  xlstm's (mLSTM and sLSTM) on ``data=2 x model=2``;
- xlstm's with the inner split over the sequence's own axis
  (``model=2``: the gates' biases, whose gradient every inner rank has
  whole, ``INNER_WHOLE``), and over ``("data", "model")`` beside the
  sequence over ``model`` (a rank holds half a head's value features);
- jamba's with the sequence over ``("data", "model")`` beside the inner
  split over ``model``.

Every case, from seed 0's weights and batch, is held to the reference's
whole-batch ``make_train_step`` from the same weights under AdamW without
warmup (``_torch_train_parity.shards_held_to_reference``): loss and grad
norm within ``TP_LOSS_RTOL``, each rank's gradient shards within
``TP_GRAD_TOL`` of the same slice of the reference's, its updated shards
within 1e-5, the leaves held whole bit-equal across the ranks; jamba's
MoE drops (its own capacity factor 1.25) are the unsharded layer's.
"""

import pytest

import _torch_dist as D
import _torch_train_parity as P

M2, D2M2 = {"data": 1, "model": 2}, {"data": 2, "model": 2}
BOTH = ("data", "model")
CASES = {
    2: [{"id": "inner_with_seq/xlstm", "arch": "xlstm-1.3b", "mesh": M2,
         "layout": {"seq": "model", "vocab": "model", "inner": "model"}}],
    4: [{"id": "inner_beside_seq/jamba", "arch": "jamba-v0.1-52b",
         "mesh": D2M2, "layout": "inner_beside_seq"},
        {"id": "inner_beside_seq/xlstm", "arch": "xlstm-1.3b",
         "mesh": D2M2, "layout": "inner_beside_seq"},
        {"id": "inner_over_both/xlstm", "arch": "xlstm-1.3b", "mesh": D2M2,
         "layout": {"seq": "model", "vocab": "model", "inner": BOTH}},
        {"id": "seq_over_both/jamba", "arch": "jamba-v0.1-52b",
         "mesh": D2M2,
         "layout": {"seq": BOTH, "vocab": BOTH, "inner": "model"}}]}
PARAMS = [(w, c["id"]) for w, cases in CASES.items() for c in cases]
CASE = {c["id"]: c for cases in CASES.values() for c in cases}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("layouts_recurrent")
    return {w: D.run_ranks(D.layout_rank, w, root, cases, 0)
            for w, cases in CASES.items()}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch in {c["arch"] for c in CASE.values()}:
        cfg = D.smoke(arch)
        model = D.model_of(cfg)["params"]
        batch = D.batch_of(cfg, seed=3)
        out[arch] = P.reference_moved(arch, model, batch)
        out[arch]["drops"] = D.forward_drops(model, batch) if cfg.moe \
            else None
    return out


@pytest.mark.parametrize("world,case", PARAMS)
def test_layout_matches_reference_whole_batch_step(ranks, reference, world,
                                                   case):
    P.shards_held_to_reference(ranks[world], case,
                               reference[CASE[case]["arch"]])


@pytest.mark.parametrize("case", [c["id"] for c in CASES[4]
                                  if c["arch"] == "jamba-v0.1-52b"])
def test_jamba_drops_are_the_unsharded_layers(ranks, reference, case):
    """Every rank dispatches the whole sequence of its rows (the
    sequence's gather), so each rank's drops are the unsharded layer's."""
    want = reference["jamba-v0.1-52b"]["drops"]
    assert want["dropped"] > 0
    for o in ranks[4]:
        assert o[case]["drops"] == want
