"""The port's dry-run (``repro_torch.launch.dryrun`` and
``launch.dispatch_analysis``) against the JAX reference's
(``repro.launch.dryrun``, ``launch.hlo_analysis``) and against real runs
of the port.

- **Planning**: on all 80 (arch x shape x mesh) cells, under both
  profiles, the record's planning fields (``parallel_config``,
  ``devices``, ``params``, ``active_params``, ``tokens_per_step``,
  ``param_bytes_per_device``) equal what the reference's ``run_cell``
  records from ``plan_cell``, ``make_rules`` (``pp_rules`` under the
  pipeline role) and ``exact_param_bytes_per_chip``, the port planning
  with the reference's figures (``test_torch_sharding.py``'s
  ``REF_HW``: the port carries no TPU figures) on the reference's
  shape-only mesh. A skipped ``long_500k`` cell's record equals the
  reference's. Nothing is traced.
- **Collectives**: one train step of a smoke config under the
  tensor-parallel layout of ``test_torch_tp.py`` (``data=1, model=2``,
  ``seq_tp`` with ``mlp=model``) and the expert-parallel one of
  ``test_torch_ep.py`` (the all-to-all with the sequence and the
  vocabulary over ``model``), and the pipeline of ``test_torch_pp.py``
  (two stages over ``pod``, whose shifts the port records as
  collective-permutes since this slice), runs for real on two ``gloo`` ranks, and
  through the dry-run on a fake process group of two: the calls and
  result bytes by kind equal rank 0's ``COLLECTIVE_STATS``, exactly.
- **FLOPs** of the dense (llama3.2-3b) and MoE (granite-moe-1b-a400m)
  families at full width, prefill and a train step under block remat,
  equal the reference's ``analyze`` of its compiled step once the terms
  ``_torch_flop_terms`` names are set aside (the recurrent families are
  in ``test_torch_dryrun.py``).
"""

import os

import jax
import numpy as np
import pytest

import _torch_dist as D
import _torch_dryrun_ranks as R
import _torch_flop_terms as F
import repro.parallel.pipeline as jpp
import repro.parallel.strategies as jstrat
from repro.configs import ARCH_IDS
from repro.configs import get_config as jconfig
from repro.core import config as jcore
from repro_torch.configs import get_config as tconfig
from repro_torch.core import config as tcore
from repro_torch.device import Hardware
from repro_torch.launch import dryrun
from repro_torch.launch.dispatch_analysis import collective_costs
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import pipeline as tpp

REF_HW = Hardware(jstrat.PEAK_FLOPS, jstrat.HBM_BW, jstrat.ICI_BW,
                  jstrat.HBM_BYTES)
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s, m) for a in ARCH_IDS for s in jcore.SHAPES
         for m in (False, True)]


class FakeMesh:
    """The reference's shape-only stand-in (its tests/test_sharding.py)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the process's ``XLA_FLAGS``
    kept as they were (the module sets them for 512 host devices)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


_INIT_SHAPES: dict = {}


def _once_per_config(fn):
    """``fn`` (the reference's ``exact_param_bytes_per_chip``) run as it
    is, but with its ``jax.eval_shape`` of ``init_lm`` made once per
    config: the closure it hands ``eval_shape`` records the axes as a side
    effect, which is replayed (the reference traces the whole model at
    every call, 1.3 s a call and three calls a cell)."""
    real = jax.eval_shape

    def eval_shape(f):
        free = dict(zip(f.__code__.co_freevars,
                        (c.cell_contents for c in f.__closure__)))
        cfg, captured = free["cfg"], free["captured"]
        if cfg not in _INIT_SHAPES:
            _INIT_SHAPES[cfg] = (real(f), captured["axes"])
        shapes, captured["axes"] = _INIT_SHAPES[cfg]
        return shapes

    def wrapped(cfg, rules):
        jax.eval_shape = eval_shape
        try:
            return fn(cfg, rules)
        finally:
            jax.eval_shape = real
    return wrapped


@pytest.fixture
def reference_planner(monkeypatch):
    monkeypatch.setattr(jstrat, "exact_param_bytes_per_chip",
                        _once_per_config(jstrat.exact_param_bytes_per_chip))


def _reference_fields(arch, shape_name, multi, profile,
                      overrides=None) -> dict:
    """The planning fields the reference's ``run_cell`` records, from its
    ``build_cell``'s planning calls (``overrides`` its ``pc_overrides``)."""
    cfg, shape = jconfig(arch), jcore.SHAPES[shape_name]
    mesh = FakeMesh(MESHES[multi])
    pc = jstrat.plan_cell(cfg, shape, mesh, jcore.ParallelConfig(
        **overrides) if overrides else None, profile=profile)
    rules = jstrat.make_rules(mesh, cfg, shape, pc)
    if shape.mode == "train" and pc.pod_axis_role == "pipeline":
        rules = jpp.pp_rules(rules)
    return {"parallel_config": {k: getattr(pc, k) for k in dryrun.PC_FIELDS},
            "devices": int(np.prod(list(mesh.shape.values()))),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens_per_step": shape.tokens_per_step,
            "param_bytes_per_device": jstrat.exact_param_bytes_per_chip(
                cfg, rules)}


@pytest.mark.parametrize("profile", ["optimized", "baseline"])
def test_planning_fields_match_reference_on_every_cell(profile, tmp_path,
                                                     reference_planner):
    """All 80 cells: the planned fields of every applicable cell, and the
    whole record of every skipped one (tolerance: none)."""
    jdry = _reference_dryrun()
    planned = skipped = 0
    for arch, shape_name, multi in CELLS:
        tcfg = tconfig(arch)
        if shape_name not in dryrun.applicable_shapes(tcfg):
            ref = jdry.run_cell(arch, shape_name, multi, tmp_path / "ref",
                                profile=profile)
            got = dryrun.run_cell(arch, shape_name, multi,
                                  tmp_path / "port", profile=profile)
            assert got == ref and got["status"] == "skipped", \
                (arch, shape_name, multi)
            skipped += 1
            continue
        shape, mesh = tcore.SHAPES[shape_name], Mesh(MESHES[multi])
        pc, rules, _ = dryrun.plan(tcfg, shape, mesh, profile=profile,
                                   hw=REF_HW)
        got = dryrun.planned_fields(tcfg, shape, mesh, pc, rules)
        assert got == _reference_fields(arch, shape_name, multi, profile), \
            (arch, shape_name, multi)
        planned += 1
    assert (planned, skipped) == (64, 16)


PACKING = {"pod_axis_role": "pipeline", "microbatches": 4}
PACKING_ARCHS = ("qwen1.5-4b", "mistral-nemo-12b", "llama3.2-3b",
                 "qwen2-72b", "internvl2-1b", "musicgen-medium")


@pytest.mark.parametrize("profile", ["optimized", "baseline"])
@pytest.mark.parametrize("arch", PACKING_ARCHS)
def test_packing_cell_planning_fields_match_reference(arch, profile,
                                                      reference_planner):
    """The dense archs' packing cells (``train_4k`` on 2 x 16 x 16 with
    the pipeline's pod role and 4 microbatches, the reference's
    ``build_cell(pc_overrides=...)``): the planning fields equal the
    reference's (tolerance: none)."""
    tcfg, shape = tconfig(arch), tcore.SHAPES["train_4k"]
    mesh = Mesh(MESHES[True])
    pc, rules, pipeline = dryrun.plan(tcfg, shape, mesh, PACKING,
                                      profile=profile, hw=REF_HW)
    assert pipeline and pc.microbatches == 4
    got = dryrun.planned_fields(tcfg, shape, mesh, pc, rules)
    assert got == _reference_fields(arch, "train_4k", True, profile,
                                    PACKING)


def test_qwen2_72b_packing_cell_traces_ok(tmp_path):
    """qwen2-72b's packing cell, traced on rank 0 of a fake process group
    of 512: the record ends ``ok``; each stage runs 40 of the 80 layers on
    its 4 microbatches (K4 twice and K4b once a layer a microbatch under
    block remat), and the shifts are 4 forward and 4 backward
    collective-permutes of a microbatch's block of the residual."""
    import torch.distributed as dist
    try:
        rec = dryrun.run_cell("qwen2-72b", "train_4k", True, tmp_path,
                              pc_overrides=PACKING)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["parallel_config"]["pod_axis_role"] == "pipeline"
    assert rec["kernel_launches"] == {"flash_attention": 2 * 40 * 4,
                                      "flash_attention_bwd": 40 * 4}
    cfg, shape = tconfig("qwen2-72b"), tcore.SHAPES["train_4k"]
    block = (shape.global_batch // 4 // 16) * (shape.seq_len // 16) \
        * cfg.d_model * 2
    assert rec["collective_counts"]["collective-permute"] == 8
    assert rec["collective_bytes_by_kind"]["collective-permute"] == \
        8 * block


# -- collectives against a real run ---------------------------------------------

COLLECTIVE_CASES = [
    {"id": "tp-seq_tp-mlp-llama", "arch": "llama3.2-3b",
     "mesh": {"data": 1, "model": 2},
     "pc": dict(attn_strategy="seq_tp", fsdp="off", remat="block",
                mlp_mode="tp")},
    {"id": "ep-a2a-seq-granite", "arch": "granite-moe-1b-a400m",
     "mesh": {"data": 1, "model": 2}, "capacity_factor": 8.0,
     "pc": dict(attn_strategy="seq_tp", moe_strategy="shard_map_a2a",
                mlp_mode="seq", fsdp="off", remat="block")},
    # the pipeline of test_torch_pp.py: two stages over pod, GPipe
    {"id": "pp-llama", "arch": "llama3.2-3b", "pipeline": True,
     "mesh": {"pod": 2, "data": 1, "model": 1},
     "pc": dict(pod_axis_role="pipeline", microbatches=2, fsdp="off",
                remat="block")},
    # granite's baseline-profile train layout: GSPMD's all_to_all plane
    # (expert_act over model) under seq_tp, two ranks sharing each chunk
    {"id": "ep-all_to_all-seq-granite", "arch": "granite-moe-1b-a400m",
     "mesh": {"data": 1, "model": 2}, "capacity_factor": 8.0,
     "pc": dict(attn_strategy="seq_tp", moe_strategy="all_to_all",
                mlp_mode="tp", fsdp="off", remat="block")},
]
# on four ranks: the pipeline with splits inside its stages, the packing
# cell's layouts (test_torch_pp_tp.py): seq_tp with mlp_seq on pod=2 x
# model=2, ZeRO-3 with the batch over data on pod=2 x data=2
PP_TP_CASES = [
    {"id": "pp-tp-llama", "arch": "llama3.2-3b", "pipeline": True,
     "mesh": {"pod": 2, "data": 1, "model": 2},
     "pc": dict(pod_axis_role="pipeline", microbatches=4,
                attn_strategy="seq_tp", mlp_mode="seq", fsdp="off",
                remat="block")},
    {"id": "pp-zero3-llama", "arch": "llama3.2-3b", "pipeline": True,
     "mesh": {"pod": 2, "data": 2, "model": 1},
     "pc": dict(pod_axis_role="pipeline", microbatches=2,
                attn_strategy="seq_tp", fsdp="on", remat="block")},
]


@pytest.fixture
def fake_two():
    import torch.distributed as dist
    dryrun.fake_world(2)
    yield
    dist.destroy_process_group()


def test_ep_case_is_the_ep_tests_layout():
    """The expert-parallel case's rules hold ``test_torch_ep.py``'s
    ``a2a-seq`` rules."""
    _, _, _, rules = D.case_rules(COLLECTIVE_CASES[1])
    want = {"expert": "model", "moe_impl": "shard_map_a2a", "seq": "model",
            "vocab": "model"}
    assert {k: rules.rules.get(k) for k in want} == want


def test_baseline_case_is_the_baseline_tests_layout():
    """The baseline case's rules hold ``test_torch_ep_baseline.py``'s
    ``seq`` rules, as the planner's baseline profile gives granite's
    ``train_4k`` cell."""
    _, _, _, rules = D.case_rules(COLLECTIVE_CASES[3])
    want = {"expert": "model", "expert_act": "model", "seq": "model",
            "vocab": "model", "moe_impl": None}
    assert {k: rules.rules.get(k) for k in want} == want


def test_collectives_match_a_real_gloo_run(tmp_path, fake_two):
    """Calls and result bytes by kind of the traced step equal rank 0's
    ``COLLECTIVE_STATS`` of the real step on two ranks (tolerance:
    none)."""
    real = D.run_ranks(R.collective_rank, 2, tmp_path, COLLECTIVE_CASES)[0]
    real.update(D.run_ranks(R.collective_rank, 4, tmp_path,
                            PP_TP_CASES)[0])
    for case in COLLECTIVE_CASES + PP_TP_CASES:
        if case is PP_TP_CASES[0]:
            dryrun.fake_world(4)
        cfg, shape, pc, rules = D.case_rules(case)
        pipeline = bool(case.get("pipeline"))
        if pipeline:
            rules = tpp.pp_rules(rules)
        fn, args = dryrun.build_step(cfg, shape, pc, rules, pipeline,
                                     ssm_chunk=D.SSM_CHUNK)
        traced = dryrun.traced_fields(fn, args)
        want_bytes, want_counts = collective_costs(real[case["id"]])
        assert traced["collective_counts"] == want_counts, case["id"]
        assert traced["collective_bytes_by_kind"] == want_bytes, case["id"]
    # the layouts make all-reduces and all-gathers, the expert-parallel
    # one all-to-alls, the pipeline collective-permutes (its shifts)
    kinds = {k: set(collective_costs(v)[1]) for k, v in real.items()}
    assert {"all-reduce", "all-gather"} <= kinds["tp-seq_tp-mlp-llama"]
    assert "all-to-all" in kinds["ep-a2a-seq-granite"]
    assert {"all-to-all", "all-gather"} <= kinds["ep-all_to_all-seq-granite"]
    assert "collective-permute" in kinds["pp-llama"]
    for case in ("pp-tp-llama", "pp-zero3-llama"):
        assert {"all-reduce", "all-gather", "collective-permute"} <= \
            kinds[case]
    _, _, _, rules = D.case_rules(PP_TP_CASES[0])
    assert rules.rules["seq"] == rules.rules["mlp_seq"] == "model"
    _, _, _, rules = D.case_rules(PP_TP_CASES[1])
    assert rules.rules["w_embed"] == "data"


# -- FLOPs against the reference's HLO count -----------------------------------

FLOP_CASES = {
    # arch, layers, vocab, B, S: llama at the vocabulary of the count
    # that the closed form was first checked on
    "llama3.2-3b": ("llama3.2-3b", 2, 2048, 2, 512),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", 2, None, 2, 256),
}


@pytest.mark.parametrize("mode,remat", [("prefill", "none"),
                                        ("train", "block")])
@pytest.mark.parametrize("case", list(FLOP_CASES))
def test_flops_match_reference_but_the_named_terms(case, mode, remat):
    arch, layers, vocab, b, s = FLOP_CASES[case]
    jcfg, tcfg = F.configs(arch, layers, vocab)
    ref = F.reference_flops(jcfg, mode, b, s, remat)
    got = F.port_costs(tcfg, mode, b, s, remat)
    named = F.terms(tcfg, mode, b, s, remat)
    assert ref - int(got.flops) == sum(named.values()), (named, ref,
                                                         got.flops)
    # K4's part is its formula's: the attention term is a pure multiple
    assert got.attention_flops == sum(got.kernel_flops.values())
