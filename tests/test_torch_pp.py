"""The port's GPipe pipeline over ``pod`` (``repro_torch.parallel.pipeline``)
on spawned ``gloo`` ranks on the CPU.

llama's fp32 smoke config (2 layers: one a stage) over 2 stages, and over
2 stages x 2 data ranks, with microbatches at least the stage count,
against the port's plain ``make_train_step`` on the same weights and the
whole batch: the loss and the gradient norm within 1e-6 relative, every
leaf's gradient (each stage's layers and the replicated embedding and
final norm) within 1e-5 of its largest magnitude, the updated parameters
within 1e-6, and every rank's embedding and final norm bit-equal after
the update. The same holds, with the updated parameters within 1e-5,
against the JAX reference's ``make_train_step`` on the whole batch from
the same weights. ``pp_applicable`` and ``pp_rules`` are held to the
reference's.
"""

import numpy as np
import pytest

import _torch_dist as D
import _torch_train_parity as P
import repro.parallel.pipeline as jpp
from repro.configs import get_config as jconfig
from repro.core import config as jcore
from repro.parallel.sharding import ShardingRules as JRules
from repro_torch.configs import get_config as tconfig
from repro_torch.core import config as tcore
from repro_torch.launch.mesh import Mesh, make_smoke_mesh
from repro_torch.parallel import pipeline as tpp
from repro_torch.parallel.sharding import ShardingRules

LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-6, 1e-5, 1e-6
REF_PARAM_ATOL = 1e-5
ARCH = "llama3.2-3b"
RUNS = {"2stages-mb2": (2, 2, 1), "2stages-mb4": (2, 4, 1),
        "2stages-x-2data-mb2": (4, 2, 2)}


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


@pytest.fixture(scope="module")
def single():
    return D.single_rank(ARCH)


@pytest.fixture(scope="module")
def reference():
    cfg = D.smoke(ARCH)
    return P.reference_whole_batch_step(ARCH, D.model_of(cfg)["params"],
                                        D.batch_of(cfg))


@pytest.fixture(scope="module", params=list(RUNS))
def run(request, tmp_path_factory):
    world, mb, data = RUNS[request.param]
    return D.run_ranks(D.pp_rank, world, tmp_path_factory.mktemp("pp"),
                       ARCH, mb, data)


def test_pipeline_matches_plain_train_step(run, single):
    stages = {o["stage"] for o in run}
    assert stages == {0, 1}
    seen = set()
    for o in run:
        assert o["loss"] == pytest.approx(single["loss"], rel=LOSS_RTOL)
        assert o["grad_norm"] == pytest.approx(
            single["metrics"]["grad_norm"], rel=LOSS_RTOL)
        mine = [k for k in o["names"] if k.startswith("layers.")]
        assert mine == [k for k in single["grads"]
                        if k.startswith(f"layers.{o['stage']}.")]
        for k in o["names"]:
            g = single["grads"][k]
            err = float(np.abs(o["grads"][k] - g).max()) / max(
                float(np.abs(g).max()), 1e-30)
            assert err <= GRAD_TOL, (k, err)
            np.testing.assert_allclose(o["params"][k], single["params"][k],
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
        seen |= set(o["names"])
    assert seen == set(single["grads"])


def test_pipeline_matches_reference_whole_batch_step(run, reference):
    """Every rank's loss, gradient norm, owned gradients and updated
    parameters are the reference's single-device step on the whole
    batch."""
    for o in run:
        for k in ("loss", "grad_norm"):
            assert o[k] == pytest.approx(reference["metrics"][k],
                                         rel=LOSS_RTOL)
        for k in o["names"]:
            g = reference["grads"][k]
            err = float(np.abs(o["grads"][k] - g).max()) / max(
                float(np.abs(g).max()), 1e-30)
            assert err <= GRAD_TOL, (k, err)
            np.testing.assert_allclose(o["params"][k],
                                       reference["params"][k], rtol=0,
                                       atol=REF_PARAM_ATOL, err_msg=k)


def test_replicated_leaves_equal_on_every_rank_after_update(run):
    shared = [k for k in run[0]["names"] if not k.startswith("layers.")]
    assert "embed.table" in shared and "final_norm.scale" in shared
    for o in run[1:]:
        for k in shared:
            assert np.array_equal(o["params"][k], run[0]["params"][k]), k


def test_pp_applicable_and_rules_match_reference():
    """pp_applicable over archs, stage counts and microbatches, and
    pp_rules' dict."""
    shape_j, shape_t = jcore.SHAPES["train_4k"], tcore.SHAPES["train_4k"]
    for arch in ("llama3.2-3b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
                 "xlstm-1.3b", "qwen2-72b"):
        for pods in (2, 4, 3):
            for mb in (1, 2, 4):
                shp = {"pod": pods, "data": 2, "model": 1}
                j = jpp.pp_applicable(jconfig(arch), shape_j, FakeMesh(shp),
                                      jcore.ParallelConfig(microbatches=mb))
                t = tpp.pp_applicable(tconfig(arch), shape_t, Mesh(shp),
                                      tcore.ParallelConfig(microbatches=mb))
                assert t == j, (arch, pods, mb)
    assert not tpp.pp_applicable(tconfig("llama3.2-3b"), shape_t,
                                 make_smoke_mesh(), tcore.ParallelConfig())
    rules = {"batch": ("pod", "data"), "layers": None, "vocab": "model"}
    assert tpp.pp_rules(ShardingRules(None, rules)).rules == \
        jpp.pp_rules(JRules(None, rules)).rules


def test_stage_layers_split_the_repeats():
    cfg = tconfig("qwen2-72b")
    assert [list(tpp.stage_layers(cfg, 4, s))[::19] for s in range(4)] == \
        [[0, 19], [20, 39], [40, 59], [60, 79]]
