"""Data parallelism of the port's train step (``repro_torch.training``
under rules that split the batch over ``data``) on spawned ``gloo`` ranks
on the CPU, against the port's single-rank step on the whole batch and
against the JAX reference's ``make_train_step`` on the whole batch, from
the same weights.

Each rank plans its cell with the port's planner on a ``data=N, model=1``
mesh (fsdp off), receives the whole batch and takes its rows. Held, in
fp32 smoke configs: the loss within 1e-6 relative, every gradient leaf
within 1e-5 of its largest magnitude, the updated parameters within 1e-6
absolute and bit-equal across the ranks, and granite's MoE aux equal to
the whole batch's (1e-6 relative): the reference takes its two batch means
over the whole sharded batch. xlstm's sLSTM runs its scan on each rank's
rows; its recurrent weights' gradient is summed by the step's all-reduce.
Against the reference the metrics and gradients are held to the same
bounds, and the updated parameters within 1e-5 absolute (Adam's first
step moves a weight by about the learning rate whatever its gradient's
size, so a gradient near 0 that differs in its last bits moves it by more
than one within the port; measured at most 2e-6, xlstm).
"""

import numpy as np
import pytest

import _torch_dist as D
import _torch_train_parity as P
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import ShardingRules, require_executable
from repro_torch.training.train_step import _rows

LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-6, 1e-5, 1e-6
REF_PARAM_ATOL = 1e-5

CASES = {
    2: [("llama3.2-3b", 1, 0), ("granite-moe-1b-a400m", 1, 0),
        ("xlstm-1.3b", 1, 0), ("granite-moe-1b-a400m", 2, 0),
        ("internvl2-1b", 1, 1)],
    4: [("llama3.2-3b", 1, 0), ("granite-moe-1b-a400m", 1, 0),
        ("xlstm-1.3b", 1, 0)],
}
PARAMS = [(w, c) for w, cases in CASES.items() for c in cases]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: D.run_ranks(D.dp_rank, w, tmp_path_factory.mktemp(f"dp{w}"),
                           cases) for w, cases in CASES.items()}


@pytest.fixture(scope="module")
def single():
    return {c: D.single_rank(*c) for c in {c for _, c in PARAMS}}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch, mb, mask in {c for _, c in PARAMS}:
        cfg = D.smoke(arch)
        out[(arch, mb, mask)] = P.reference_whole_batch_step(
            arch, D.model_of(cfg)["params"], D.batch_of(cfg, mask), mb)
    return out


def _ids(p):
    w, (arch, mb, mask) = p
    return f"{w}ranks-{arch}-mb{mb}" + ("-counts_differ" if mask else "")


@pytest.mark.parametrize("world,case", PARAMS, ids=[_ids(p) for p in PARAMS])
def test_dp_step_matches_single_rank_step(ranks, single, world, case):
    ref = single[case]
    outs = [r[case] for r in ranks[world]]
    assert [o["index"] for o in outs] == list(range(world))
    assert outs[0]["batch_rule"] == ("data",)
    for o in outs:
        assert o["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
            assert o["metrics"][k] == pytest.approx(ref["metrics"][k],
                                                    rel=LOSS_RTOL, abs=1e-12)
        assert set(o["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            scale = max(float(np.abs(g).max()), 1e-30)
            err = float(np.abs(o["grads"][k] - g).max()) / scale
            assert err <= GRAD_TOL, (k, err)
        for k, p in ref["params"].items():
            np.testing.assert_allclose(o["params"][k], p, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    for o in outs[1:]:
        for k, p in outs[0]["params"].items():
            assert np.array_equal(o["params"][k], p), k


@pytest.mark.parametrize("world,case", PARAMS, ids=[_ids(p) for p in PARAMS])
def test_dp_step_matches_reference_whole_batch_step(ranks, reference, world,
                                                    case):
    """Every rank's loss, metrics (granite's aux among them), gradients
    and updated parameters are the reference's single-device step on the
    whole batch."""
    ref = reference[case]
    for o in (r[case] for r in ranks[world]):
        for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
            assert o["metrics"][k] == pytest.approx(ref["metrics"][k],
                                                    rel=LOSS_RTOL, abs=1e-12)
        assert set(o["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            scale = max(float(np.abs(g).max()), 1e-30)
            err = float(np.abs(o["grads"][k] - g).max()) / scale
            assert err <= GRAD_TOL, (k, err)
        for k, p in ref["params"].items():
            np.testing.assert_allclose(o["params"][k], p, rtol=0,
                                       atol=REF_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world", sorted(CASES))
def test_granite_aux_is_the_whole_batch(ranks, single, world):
    """Every rank's aux is the whole batch's, not its own rows'."""
    case = ("granite-moe-1b-a400m", 1, 0)
    for o in (r[case] for r in ranks[world]):
        assert o["aux"] == pytest.approx(single[case]["aux"], rel=LOSS_RTOL)
        assert o["aux"] > 0


@pytest.mark.parametrize("world", sorted(CASES))
def test_rules_give_device_mesh_placements(ranks, world):
    """On a live mesh ``sharding`` and ``make_param_sharding`` give the
    ``DeviceMesh`` placements of the rules' specs: batch over ``data``
    (Shard 0) and vocab over ``model`` (Shard 2); the embedding table's
    vocab over ``model``, replicated over ``data``."""
    for r in ranks[world]:
        o = r[("llama3.2-3b", 1, 0)]
        assert o["placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert o["param_placements"] == "(Replicate(), Shard(dim=0))"


def test_counts_differ_between_ranks_in_the_vision_case(ranks, single):
    """The vision stub's case masks one row's labels: the two ranks'
    token counts differ, and the loss is still the whole batch's mean."""
    cfg = D.smoke("internvl2-1b")
    labels = D.batch_of(cfg, 1)["labels"]
    counts = [(labels[r * 2:(r + 1) * 2] >= 0).sum() for r in range(2)]
    assert counts[0] < counts[1]
    case = ("internvl2-1b", 1, 1)
    assert ranks[2][0][case]["tokens"] == sum(counts)
    assert single[case]["tokens"] == sum(counts)


def test_microbatches_are_cut_before_the_batch_axes():
    """With 2 microbatches over 2 ranks, rank 1 of a batch of 8 rows takes
    rows 2-3 of the first microbatch and 6-7 of the second."""
    batch = {"tokens": np.arange(8)[:, None] * np.ones((1, 3), int)}
    got = [_rows(_rows(batch, i, 2), 1, 2)["tokens"][:, 0].tolist()
           for i in range(2)]
    assert got == [[2, 3], [6, 7]]


ZERO_GRANITE = [{"id": f"zero3-data-granite{tag}",
                 "arch": "granite-moe-1b-a400m",
                 "mesh": {"data": 2, "model": 1},
                 "pc": dict(attn_strategy="replicated", fsdp="on",
                            remat="block", **pc), "regather": regather}
                for tag, pc, regather in (("", {}, None),
                                          ("-zero2-regather",
                                           {"zero2": True}, True))]


def test_train_step_refuses_zero_and_regather(tmp_path):
    """ZeRO's w_embed over data=2, with and without ``zero2`` and
    ``regather``, is admitted for an MoE model (granite) as for a dense
    one (llama), and granite's step runs on two ranks: the MoE layers on
    their gathered leaves, held to the reference's unsharded step as the
    tensor-parallel cases are (``P.held_to_reference``)."""
    rules = ShardingRules(Mesh({"data": 2, "model": 1}),
                          {"batch": "data", "w_embed": "data"})
    require_executable(rules, cfg=D.smoke("llama3.2-3b"))
    cfg = D.smoke("granite-moe-1b-a400m")
    require_executable(rules, cfg=cfg)
    outs = D.run_ranks(D.tp_train_rank, 2, tmp_path, ZERO_GRANITE)
    ref = P.reference_whole_batch_step(
        "granite-moe-1b-a400m", D.model_of(cfg)["params"], D.batch_of(cfg))
    for case in ZERO_GRANITE:
        got = [o[case["id"]] for o in outs]
        assert got[0]["rules"]["w_embed"] == "data"
        P.held_to_reference(got, ref)
