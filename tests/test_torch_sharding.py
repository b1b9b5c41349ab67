"""The port's sharding rules, parameter axes and strategy planner
(``repro_torch.parallel.sharding``, ``.strategies``, ``launch.mesh``,
``models.convert.param_axes``/``param_shapes``) against the JAX reference
on the CPU.

The planner is held field for field to the reference's under the
reference's own hardware constants (a ``Hardware`` built from them); the
port's default is the H100's. Cells are chosen to cover every branch of
the decision node (named beside each); the reference plans on a shape-only
mesh, as its own tests do. No parameter is allocated: qwen2-72b is planned
at full width. ``require_executable`` refuses the two layouts the
reference itself raises on, naming its failure, and admits the rest of
what ROADMAP item 11.4d listed.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import repro.parallel.strategies as jstrat
from repro.configs import ARCH_IDS
from repro.configs import get_config as jconfig
from repro.core import config as jcore
from repro.core.decisions import DecisionContext as JContext
from repro.models.lm import init_lm as jinit_lm
from repro.parallel.sharding import ShardingRules as JRules
from repro.training.optimizer import opt_state_axes as jopt_state_axes
from repro_torch.configs import get_config as tconfig
from repro_torch.core import config as tcore
from repro_torch.core.decisions import DecisionContext
from repro_torch.device import H100_SXM, Hardware
from repro_torch.launch.mesh import (
    Mesh,
    make_production_mesh,
    make_smoke_mesh,
    mesh_devices,
)
from repro_torch.models.convert import ParamShape, param_axes, param_shapes
from repro_torch.parallel import pipeline as tpp
from repro_torch.parallel import strategies as tstrat
from repro_torch.parallel.sharding import (
    ShardingRules,
    pad_to_multiple,
    require_executable,
)
from repro_torch.training import opt_state_axes

REF_HW = Hardware(jstrat.PEAK_FLOPS, jstrat.HBM_BW, jstrat.ICI_BW,
                  jstrat.HBM_BYTES)


class FakeMesh:
    """The reference's shape-only stand-in (its tests/test_sharding.py)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1},
          "4x1": {"data": 4, "model": 1}}

# (arch, shape, mesh, overrides, profile): the branch each covers
CELLS = {
    "seq_tp+fsdp_on": ("mistral-nemo-12b", "train_4k", "2x16x16", None,
                       "optimized"),
    "head_tp+shard_map_a2a": ("moonshot-v1-16b-a3b", "train_4k", "16x16",
                              None, "optimized"),
    "head_tp+all_to_all(baseline)": ("moonshot-v1-16b-a3b", "prefill_32k",
                                     "16x16", None, "baseline"),
    "replicated+fsdp_on+microbatches": ("llama3.2-3b", "train_4k", "1x1",
                                        None, "optimized"),
    "replicated+fsdp_off(prefill)": ("qwen1.5-4b", "prefill_32k", "4x1",
                                     None, "optimized"),
    "decode_kv_shard(qwen2-72b full width)": ("qwen2-72b", "decode_32k",
                                              "16x16", None, "optimized"),
    "none": ("xlstm-1.3b", "prefill_32k", "16x16", None, "optimized"),
    "pure_dp+fsdp_on": ("xlstm-1.3b", "train_4k", "16x16", None,
                        "optimized"),
    "pure_dp+gather": ("granite-moe-1b-a400m", "train_4k", "16x16", None,
                       "optimized"),
    "gather(decode)": ("granite-moe-1b-a400m", "decode_32k", "2x16x16", None,
                       "optimized"),
    "pipeline pod role": ("qwen2-72b", "train_4k", "2x16x16",
                          {"pod_axis_role": "auto"}, "optimized"),
    "long_500k": ("jamba-v0.1-52b", "long_500k", "4x1", None, "optimized"),
}


@functools.cache
def _plans(cell):
    arch, shape, mesh, over, profile = CELLS[cell]
    jpc = jcore.ParallelConfig(**over) if over else None
    tpc = tcore.ParallelConfig(**over) if over else None
    jm, tm = FakeMesh(MESHES[mesh]), Mesh(MESHES[mesh])
    ref = jstrat.plan_cell(jconfig(arch), jcore.SHAPES[shape], jm, jpc,
                           profile)
    got = tstrat.plan_cell(tconfig(arch), tcore.SHAPES[shape], tm, tpc,
                           profile, hw=REF_HW)
    return ref, got, (arch, shape, jm, tm)


@pytest.mark.parametrize("cell", list(CELLS))
def test_plan_cell_matches_reference(cell):
    """Every field of the resolved ParallelConfig, and the make_rules dict
    and exact per-chip parameter bytes under it (tolerance: none)."""
    ref, got, (arch, shape, jm, tm) = _plans(cell)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref), cell
    # mlp_mode stays "auto" in the plan: make_rules resolves it
    assert "auto" not in {k: v for k, v in dataclasses.asdict(got).items()
                          if k != "mlp_mode"}.values()
    jrules = jstrat.make_rules(jm, jconfig(arch), jcore.SHAPES[shape], ref)
    trules = tstrat.make_rules(tm, tconfig(arch), tcore.SHAPES[shape], got,
                               REF_HW)
    assert trules.rules == jrules.rules, cell
    assert tstrat.exact_param_bytes_per_chip(tconfig(arch), trules) == \
        jstrat.exact_param_bytes_per_chip(jconfig(arch), jrules)


def test_cells_cover_every_branch():
    """The cells above reach every attention and MoE strategy, both
    layouts, fsdp on and off, both pod roles and the long_500k rules."""
    seen = set()
    for cell in CELLS:
        _, got, (arch, shape, _, tm) = _plans(cell)
        seen |= {("attn", got.attn_strategy), ("moe", got.moe_strategy),
                 ("layout", got.layout), ("fsdp", got.fsdp),
                 ("pod", got.pod_axis_role)}
        if shape == "long_500k":
            rules = tstrat.make_rules(tm, tconfig(arch),
                                      tcore.SHAPES[shape], got, REF_HW)
            seen.add(("long_500k", rules.rules["batch"]))
    want = {("attn", a) for a in ("seq_tp", "head_tp", "replicated",
                                  "decode_kv_shard", "none")}
    want |= {("moe", m) for m in ("shard_map_a2a", "all_to_all", "gather",
                                  "none")}
    want |= {("layout", "pure_dp"), ("layout", "tp"), ("fsdp", "on"),
             ("fsdp", "off"), ("pod", "pipeline"), ("pod", "data"),
             ("long_500k", None)}
    assert want <= seen, want - seen


@pytest.mark.parametrize("cell", ["head_tp+shard_map_a2a",
                                  "replicated+fsdp_on+microbatches",
                                  "pipeline pod role"])
def test_strategy_node_decision_matches_reference(cell):
    """The workflow's Decision (func, scale, schedule, the plan in extras)
    equals the reference's."""
    arch, shape, mesh, _, _ = CELLS[cell]
    jd = jstrat.build_workflow(jconfig(arch), jcore.SHAPES[shape],
                               FakeMesh(MESHES[mesh])).run(
        JContext(), lambda *_: None)
    td = tstrat.build_workflow(tconfig(arch), tcore.SHAPES[shape],
                               Mesh(MESHES[mesh]), REF_HW).run(
        DecisionContext(), lambda *_: None)
    assert list(td) == list(jd)
    for name in jd:
        j, t = jd[name], td[name]
        assert (t.func, t.scale, t.schedule.policy, t.schedule.nodes) == \
            (j.func, j.scale, j.schedule.policy, j.schedule.nodes)
        assert dataclasses.asdict(t.extra("parallel_config")) == \
            dataclasses.asdict(j.extra("parallel_config"))


def test_h100_default_and_reference_figures_differ_where_memory_binds():
    """Under the card's figures the one-card internvl2 train cell needs far
    fewer microbatches than under the reference's 16 GiB chip; the
    default ``hw`` is the H100's. (llama's same cell, priced with the
    port's fp32 gradient accumulators, outgrows the data sheet's 80 GB at
    any microbatch count on one card, as it does the reference's chip.)"""
    cfg, shape = tconfig("internvl2-1b"), tcore.SHAPES["train_4k"]
    mesh = make_smoke_mesh()
    ref = tstrat.plan_cell(cfg, shape, mesh, hw=REF_HW)
    card = tstrat.plan_cell(cfg, shape, mesh)
    assert card == tstrat.plan_cell(cfg, shape, mesh, hw=H100_SXM)
    assert card.microbatches < ref.microbatches


def test_qwen2_72b_planned_without_allocation():
    """param_shapes walks qwen2-72b at full width on the meta device: its
    bytes equal the analytic parameter count's in bf16."""
    cfg = tconfig("qwen2-72b")
    total = sum(s.nbytes for s in tstrat._leaves(param_shapes(cfg)))
    assert total == pytest.approx(2 * cfg.param_count(), rel=0.01)
    rules = tstrat.make_rules(make_production_mesh(), cfg,
                              tcore.SHAPES["train_4k"],
                              tstrat.plan_cell(cfg, tcore.SHAPES["train_4k"],
                                               make_production_mesh(),
                                               hw=REF_HW), REF_HW)
    assert 0 < tstrat.exact_param_bytes_per_chip(cfg, rules) < total


# -- parameter axes and shapes -------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_and_shapes_match_reference_init(arch):
    """The tree of logical axes equals the reference's init_lm's second
    output, and the shapes and dtypes its parameters' (smoke configs)."""
    jcfg = jconfig(arch, smoke=True)
    captured = {}

    def f():
        p, a = jinit_lm(jcfg, jax.random.PRNGKey(0))
        captured["axes"] = a
        return p

    shapes = jax.eval_shape(f)
    tcfg = tconfig(arch, smoke=True)
    assert param_axes(tcfg) == captured["axes"]
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), shapes)
    got = jax.tree.map(lambda s: (s.shape, str(s.dtype).removeprefix(
        "torch.")), param_shapes(tcfg),
        is_leaf=lambda v: isinstance(v, ParamShape))
    assert got == want


def test_opt_state_axes_match_reference():
    cfg = tconfig("granite-moe-1b-a400m", smoke=True)
    assert opt_state_axes(param_axes(cfg)) == jopt_state_axes(
        param_axes(cfg))


# -- rules ---------------------------------------------------------------------


def test_spec_matches_reference_partition_spec():
    """Dedup of a reused mesh axis, tuple axes and their partial dedup."""
    rules = {"seq": "model", "mlp": "model", "batch": ("pod", "data"),
             "w_embed": "data", "vocab": None}
    j, t = JRules(None, rules), ShardingRules(None, rules)
    for axes in [("batch", "seq", "mlp"), ("batch", None), ("w_embed",
                                                            "batch"),
                 ("vocab", "mlp", "seq"), ("seq", "embed")]:
        assert t.spec(*axes) == tuple(j.spec(*axes)), axes


def test_axis_size_and_pad():
    mesh = Mesh({"pod": 2, "data": 4, "model": 1})
    rules = ShardingRules(mesh, {"batch": ("pod", "data"), "vocab": "model",
                                 "w_embed": "data"})
    jr = JRules(FakeMesh(mesh.shape), rules.rules)
    for name in ("batch", "vocab", "w_embed", "seq"):
        assert rules.axis_size(name) == jr.axis_size(name)
    assert pad_to_multiple(151655, 128) == 151680
    assert mesh_devices(make_production_mesh(multi_pod=True)) == 512
    assert mesh_devices(make_production_mesh()) == 256
    assert make_smoke_mesh().shape == {"data": 1, "model": 1}
    assert rules.sharding("batch") is None      # no process group here


def test_mesh_axes_index_is_row_major():
    mesh = Mesh({"pod": 2, "data": 3, "model": 1})
    assert mesh.devices.shape == (2, 3, 1)
    assert [mesh.axes_index(("pod", "data"), r) for r in range(6)] == \
        list(range(6))
    assert [mesh.axes_index("data", r) for r in range(6)] == [0, 1, 2] * 2
    assert mesh.coordinate(4) == {"pod": 1, "data": 1, "model": 0}


@pytest.mark.parametrize("case", ["head_tp", "w_embed", "shard_map_a2a"])
def test_require_executable_refuses_what_waits_for_11_4b(case):
    """What the dense half of item 11.4b left, admitted since the expert
    and inner splits run (item 11.4c): head TP of an MoE model on model=2
    (moonshot, its experts split), ZeRO's w_embed over data=2 of an MoE
    model (granite, as llama's), the MoE all-to-all over model=2 with the
    experts over model (granite's ``seq_tp`` rules). The all-to-all
    without the experts split, which no production cell reaches and the
    reference's ``moe_shard_map`` cannot run (its local experts do not
    match its buffers), stays refused, naming that failure."""
    shape = tcore.SHAPES["train_4k"]
    if case == "head_tp":
        cfg = tconfig("moonshot-v1-16b-a3b")
        mesh = Mesh({"data": 1, "model": 2})
        rules = tstrat.make_rules(mesh, cfg, shape, tcore.ParallelConfig(
            attn_strategy="head_tp", fsdp="off"))
        assert rules.rules["expert"] == "model"
    elif case == "w_embed":
        mesh = Mesh({"data": 2, "model": 1})
        rules = tstrat.make_rules(mesh, tconfig("llama3.2-3b"), shape,
                                  tcore.ParallelConfig(
                                      attn_strategy="replicated", fsdp="on"))
        assert rules.rules["w_embed"] == "data"
        require_executable(rules, cfg=tconfig("llama3.2-3b"))
        cfg = tconfig("granite-moe-1b-a400m")
    else:
        mesh = Mesh({"data": 1, "model": 2})
        with pytest.raises(NotImplementedError,
                           match="repro/models/moe.py:138"):
            require_executable(ShardingRules(
                mesh, {"batch": "data", "moe_impl": "shard_map_a2a"}))
        cfg = tconfig("granite-moe-1b-a400m")
        rules = tstrat.make_rules(mesh, cfg, shape, tcore.ParallelConfig(
            attn_strategy="seq_tp", moe_strategy="shard_map_a2a",
            fsdp="off"))
        assert rules.rules["moe_impl"] == "shard_map_a2a"
        assert rules.rules["expert"] == "model"
    require_executable(rules, cfg=cfg)


BASELINE_A2A = {(arch, shape, multi)
                for arch in ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m",
                             "jamba-v0.1-52b")
                for shape in ("train_4k", "prefill_32k")
                for multi in (False, True)}


@pytest.mark.parametrize("profile", ["optimized", "baseline"])
def test_require_executable_admits_every_applicable_cell(profile):
    """Every one of the 64 applicable production cells (each arch's
    ``applicable_shapes`` on the 16 x 16 and 2 x 16 x 16 meshes, as the
    dry-run plans them: ``pp_rules`` under the pipeline) is admitted under
    both of the planner's profiles. The baseline profile's GSPMD
    ``all_to_all`` (``expert_act`` over ``model``) is planned for the
    train and prefill cells of moonshot (under ``head_tp``), granite and
    jamba (under ``seq_tp``), and for no cell of the optimized one."""
    from repro_torch.launch.dryrun import applicable_shapes, plan
    admitted, act = [], set()
    for arch in ARCH_IDS:
        cfg = tconfig(arch)
        for name, shape in tcore.SHAPES.items():
            if name not in applicable_shapes(cfg):
                continue
            for multi in (False, True):
                mesh = make_production_mesh(multi_pod=multi)
                pc, rules, pipeline = plan(cfg, shape, mesh, profile=profile)
                require_executable(rules, pipeline, cfg=cfg)
                admitted.append((arch, name, multi))
                if rules.rules.get("expert_act"):
                    act.add((arch, name, multi))
                    assert pc.moe_strategy == "all_to_all"
                    assert rules.rules["expert_act"] == \
                        rules.rules["expert"] == "model"
    assert len(admitted) == 64
    assert act == (BASELINE_A2A if profile == "baseline" else set())


REFUSED = {
    # (mesh, rules, pipeline, arch or None, the reference failure a refusal
    # names or None where the rules are admitted): the rule sets item 11.4d
    # listed
    "a2a_without_experts": ({"data": 1, "model": 2},
                            {"batch": "data", "moe_impl": "shard_map_a2a"},
                            False, None, "repro/models/moe.py:138"),
    "expert_act_without_experts": ({"data": 1, "model": 2},
                                   {"expert_act": "model"}, False, None,
                                   None),
    "experts_on_mlp": ({"data": 1, "model": 2}, {"mlp": "model"}, False,
                       "granite-moe-1b-a400m", None),
    "seq_without_experts": ({"data": 1, "model": 2},
                            {"seq": "model", "vocab": "model"}, False,
                            "granite-moe-1b-a400m", None),
    "inner_beside_seq": ({"data": 2, "model": 2},
                         {"seq": "model", "vocab": "model",
                          "inner": ("data", "model")}, False, None, None),
    # granite's packing-cell rules (the all-to-all under seq_tp), which
    # run without the pipeline
    "experts_under_pipeline": ({"pod": 2, "data": 1, "model": 2},
                               {"batch": "data", "layers": "pod",
                                "seq": "model", "mlp_seq": "model",
                                "vocab": "model", "expert": "model",
                                "moe_impl": "shard_map_a2a"}, True,
                               "granite-moe-1b-a400m",
                               "repro/parallel/pipeline.py:80"),
    # the experts whole but on their mlp dimension, which run without it
    "experts_on_mlp_under_pipeline": ({"pod": 2, "data": 1, "model": 2},
                                      {"batch": "data", "layers": "pod",
                                       "mlp": "model", "vocab": "model"},
                                      True, "granite-moe-1b-a400m",
                                      "repro/parallel/pipeline.py:80"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_require_executable_refuses_what_11_4d_keeps(case):
    """Of the rule sets item 11.4d listed, only the two the reference
    raises on stay refused, each naming the reference's failure: the
    all-to-all without the experts over ``model`` and an MoE layer whose
    experts are split, over the experts or on their mlp dimension, under
    the pipeline (whose rules run without it).
    ``expert_act`` alone, the experts on their mlp dimension, an MoE layer
    under a sequence split without its experts over the same axes and
    ``inner`` beside a sequence split over other axes are admitted."""
    mesh, rules, pipeline, arch, failure = REFUSED[case]
    cfg = tconfig(arch) if arch else None
    rules = ShardingRules(Mesh(mesh), rules)
    if failure is None:
        require_executable(rules, pipeline, cfg=cfg)
        return
    with pytest.raises(NotImplementedError, match=failure):
        require_executable(rules, pipeline, cfg=cfg)
    if pipeline:
        require_executable(rules, cfg=cfg)


PACKING = {"pod_axis_role": "pipeline", "microbatches": 4}
DENSE = ("qwen1.5-4b", "mistral-nemo-12b", "llama3.2-3b", "qwen2-72b",
         "internvl2-1b", "musicgen-medium")
MOE_PP = ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m")
# the two whose weights outgrow a chip: ZeRO-3 inside the stages, and the
# MLP split over model (its weights' gathers would cost more than the
# activations')
ZERO3 = ("mistral-nemo-12b", "qwen2-72b")


@pytest.mark.parametrize("profile", ["optimized", "baseline"])
@pytest.mark.parametrize("arch", DENSE + MOE_PP)
def test_require_executable_admits_the_packing_rules(arch, profile):
    """The packing cell (``train_4k`` on 2 x 16 x 16 with the pipeline's
    pod role and 4 microbatches, as the dry-run plans it: ``pp_rules``) of
    every arch ``pp_applicable`` admits: the dense archs' rules, which
    split the sequence (with ``mlp_seq`` under the optimized profile,
    ``mlp`` under the baseline one) and the vocab over ``model`` inside
    the stages, are admitted; the MoE archs', whose experts are split,
    are refused, naming the reference's own failure on any MoE layer in
    its pipeline."""
    from repro_torch.launch.dryrun import plan
    cfg, shape = tconfig(arch), tcore.SHAPES["train_4k"]
    mesh = make_production_mesh(multi_pod=True)
    pc, rules, pipeline = plan(cfg, shape, mesh, PACKING, profile=profile)
    assert pipeline and tpp.pp_applicable(cfg, shape, mesh, pc)
    assert rules.rules["layers"] == "pod" and rules.rules["batch"] == "data"
    assert rules.rules["vocab"] == "model"
    if arch in MOE_PP:
        assert rules.rules["expert"] == "model"
        with pytest.raises(NotImplementedError,
                           match="repro/parallel/pipeline.py:80"):
            require_executable(rules, pipeline, cfg=cfg)
        return
    require_executable(rules, pipeline, cfg=cfg)
    mlp = "mlp_seq" if profile == "optimized" and arch not in ZERO3 \
        else "mlp"
    assert rules.rules["seq"] == rules.rules[mlp] == "model"
    assert rules.rules["w_embed"] == ("data" if arch in ZERO3 else None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_require_executable_passes_model1_fsdp_off_plans(arch):
    """Every rule set of a model=1, fsdp-off plan runs, on data=4 and on
    pod=2 x data=2 with the pipeline variant (a prefill or decode plan
    whose weights outgrow the memory turns fsdp on, and is left out)."""
    cfg = tconfig(arch)
    for mesh_shape in ({"data": 4, "model": 1},
                       {"pod": 2, "data": 2, "model": 1}):
        mesh = Mesh(mesh_shape)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            pc = tstrat.plan_cell(cfg, tcore.SHAPES[shape], mesh,
                                  tcore.ParallelConfig(layout="tp",
                                                       fsdp="off"))
            if pc.fsdp == "on":
                assert shape != "train_4k"
                continue
            rules = tstrat.make_rules(mesh, cfg, tcore.SHAPES[shape], pc)
            require_executable(rules)
            if "pod" in mesh_shape:
                require_executable(tpp.pp_rules(rules), pipeline=True)


def test_port_carries_no_tpu_figures():
    """The card's figures are the port's defaults (the node view, the
    controller, the planner); no TPU constant (v5e: 197 TFLOP/s, 819 GB/s,
    50 GB/s a link, 16 GiB) is written in the port or chip_smoke.py."""
    import re
    from pathlib import Path

    from repro_torch.core.controllers import GlobalController
    from repro_torch.core.decisions import NodeStatus

    status = GlobalController({0: 1}).node_status()
    assert (status.link_bw, status.intra_bw) == (H100_SXM.link_bw,
                                                 H100_SXM.hbm_bw)
    assert (NodeStatus().link_bw, NodeStatus().intra_bw) == \
        (H100_SXM.link_bw, H100_SXM.hbm_bw)
    root = Path(__file__).resolve().parents[1]
    files = list((root / "src" / "repro_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9|16 \* 2 \*\* 30)")
    hits = [(f.name, m.group()) for f in files
            for m in tpu.finditer(f.read_text())]
    assert not hits
