"""The MoE layouts the reference runs under hand-written rules and the
port's ``TensorPlan`` lays out since the experts' mlp split and the
sequence's reshard (``repro_torch.models.moe`` ``_moe_partial``,
``parallel.tensor.Reshard``), on spawned ``gloo`` ranks on the CPU.

Granite's fp32 smoke config (4 experts, top 2) at its own capacity factor
1.25, where the layouts compute the unsharded layer's chunks:

- ``experts_on_mlp`` (``sharding.LAYOUTS``: the experts whole, their
  ``d_expert`` over ``model=2``), and the same split as ``make_rules``
  gives it, at 6 experts on ``model=4`` (4 does not divide 6), under the
  ``tp`` layout and under ``seq_tp`` (the sequence over ``model`` as
  well: the layer gathers it and reduce-scatters its output);
- ``expert_act_data`` (``expert_act`` over ``data``, the experts over
  ``model``) on ``data=2 x model=2``;
- ``moe_beside_seq`` (the sequence over ``data``, the experts over
  ``model``: the gather plane on the whole sequence);

and at the drop-free factor ``E / top_k`` = 2.0 the all-to-all
(``moe_impl="shard_map_a2a"``) beside a sequence split over ``data``
(``a2a_beside_seq``: each rank's block at its own capacity, as the
reference's ``moe_shard_map`` runs it) and over ``("data", "model")``
(its experts' axis among the sequence's); and, the residual whole, the
experts over ``model`` with their ``d_expert`` over ``data`` (each rank
its block of both, on the gather plane at 1.25; the all-to-all at 2.0
with the ``d_expert`` gathered whole, as the reference's
``moe_shard_map`` takes it).

Every case, from seed 0's weights and batch, is held to the reference's
whole-batch ``make_train_step`` from the same weights under AdamW without
warmup (``_torch_dist.PP_OPT``; ``_torch_train_parity.
shards_held_to_reference``): loss and grad norm within ``TP_LOSS_RTOL``,
each rank's gradient shards within ``TP_GRAD_TOL`` of the same slice of
the reference's gradients, its updated shards within 1e-5, and the
leaves it holds whole bit-equal across the ranks. The dispatches' drops
in one forward under the case's rules, divided by how many ranks
dispatch each token, equal the unsharded layer's.
"""

import pytest

import _torch_dist as D
import _torch_train_parity as P

ARCH = "granite-moe-1b-a400m"
M2, M4, D2M2 = {"data": 1, "model": 2}, {"data": 1, "model": 4}, \
    {"data": 2, "model": 2}
TP = dict(attn_strategy="replicated", fsdp="off", remat="block")
SEQ_TP = dict(attn_strategy="seq_tp", mlp_mode="seq", fsdp="off",
              remat="block")
CASES = {
    2: [{"id": "experts_on_mlp", "mesh": M2, "layout": "experts_on_mlp"}],
    4: [{"id": "make_rules-tp-6", "mesh": M4, "pc": TP, "num_experts": 6},
        {"id": "make_rules-seq_tp-6", "mesh": M4, "pc": SEQ_TP,
         "num_experts": 6},
        {"id": "expert_act_data", "mesh": D2M2,
         "layout": "expert_act_data"},
        {"id": "moe_beside_seq", "mesh": D2M2, "layout": "moe_beside_seq"},
        {"id": "a2a_beside_seq", "mesh": D2M2, "layout": "a2a_beside_seq",
         "capacity_factor": 2.0},
        {"id": "a2a_seq_over_both", "mesh": D2M2, "capacity_factor": 2.0,
         "layout": {"seq": ("data", "model"), "vocab": ("data", "model"),
                    "expert": "model", "moe_impl": "shard_map_a2a"}},
        {"id": "experts_and_mlp", "mesh": D2M2,
         "layout": {"expert": "model", "mlp": "data", "vocab": "model"}},
        {"id": "a2a_mlp_over_data", "mesh": D2M2, "capacity_factor": 2.0,
         "layout": {"expert": "model", "mlp": "data", "vocab": "model",
                    "moe_impl": "shard_map_a2a"}}]}
for cases in CASES.values():
    for c in cases:
        c["arch"] = ARCH
PARAMS = [(w, c["id"]) for w, cases in CASES.items() for c in cases]
CASE = {c["id"]: c for cases in CASES.values() for c in cases}
# what each case must split (rules over axes larger than 1)
SPLITS = {"experts_on_mlp": {"mlp": "model", "expert": None},
          "make_rules-tp-6": {"mlp": "model", "expert": None},
          "make_rules-seq_tp-6": {"mlp": "model", "expert": None,
                                  "seq": "model"},
          "expert_act_data": {"expert": "model", "expert_act": "data"},
          "moe_beside_seq": {"seq": "data", "expert": "model"},
          "a2a_beside_seq": {"seq": "data", "expert": "model"},
          "a2a_seq_over_both": {"seq": ("data", "model"),
                                "expert": "model"},
          "experts_and_mlp": {"expert": "model", "mlp": "data"},
          "a2a_mlp_over_data": {"expert": "model", "mlp": "data"}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("layouts_moe")
    return {w: D.run_ranks(D.layout_rank, w, root, cases, 0)
            for w, cases in CASES.items()}


def _key(case: dict) -> tuple:
    return case.get("capacity_factor"), case.get("num_experts")


@pytest.fixture(scope="module")
def reference():
    out = {}
    for key in {_key(c) for c in CASE.values()}:
        cfg = D.smoke(ARCH, *key)
        model = D.model_of(cfg)["params"]
        batch = D.batch_of(cfg, seed=3)
        out[key] = P.reference_moved(ARCH, model, batch,
                                     capacity_factor=key[0],
                                     num_experts=key[1])
        out[key]["drops"] = D.forward_drops(model, batch)
    return out


@pytest.mark.parametrize("world,case", PARAMS)
def test_rules_split_what_the_case_is_for(ranks, world, case):
    for o in ranks[world]:
        got = o[case]["rules"]
        for k, v in SPLITS[case].items():
            assert got.get(k) == v, (case, k, got)


@pytest.mark.parametrize("world,case", PARAMS)
def test_layout_matches_reference_whole_batch_step(ranks, reference, world,
                                                   case):
    P.shards_held_to_reference(ranks[world], case,
                               reference[_key(CASE[case])])


@pytest.mark.parametrize("world,case", PARAMS)
def test_drops_are_the_unsharded_layers(ranks, reference, world, case):
    """The ranks' drops over their assignments are the unsharded layer's:
    ``sum(dropped) / unsharded dropped == sum(assignments) / unsharded
    assignments`` (the second ratio counts the ranks that dispatch each
    token), and at 1.25 some assignments are dropped."""
    want = reference[_key(CASE[case])]["drops"]
    got = [o[case]["drops"] for o in ranks[world]]
    dropped = sum(d["dropped"] for d in got)
    assignments = sum(d["assignments"] for d in got)
    assert assignments % want["assignments"] == 0
    assert dropped * want["assignments"] == \
        want["dropped"] * assignments, (got, want)
    if CASE[case].get("capacity_factor") is None:
        assert want["dropped"] > 0
