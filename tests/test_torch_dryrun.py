"""The port's dry-run itself (``repro_torch.launch.dryrun``,
``launch.dispatch_analysis``) and the kernels' work formulas.

- ``run_cell`` writes a record with every field the dry-run promises, on a
  small config and mesh (``get_config``, ``SHAPES`` and
  ``make_production_mesh`` monkeypatched); a cell whose step raises
  becomes an ``error`` record with its traceback, and ``main --all`` then
  exits non-zero.
- The card's program and the CPU's (``--device cpu``: the kernels' plain
  routes) give the same FLOPs, collectives and kernel calls on a dense and
  an MoE production cell; their peaks differ (the plain attention keeps
  its scores).
- The trace's output cache changes nothing it counts (against running
  every operation on its meta tensors).
- Neither module imports ``jax`` or ``repro`` (a fresh interpreter).
- The work each kernel module gives (``attention.*_work``,
  ``partition.*_work``) prices PERF.md's Bound ms at the table's shapes.
- FLOPs of xlstm-1.3b (one 8-layer period at full width, ``S`` = 256: two
  mLSTM chunks of 128) equal the reference's ``analyze`` of its compiled
  step but the terms ``_torch_flop_terms`` names, prefill and a train
  step. The train step runs without remat: under block remat the two
  recompute different sets of products (the reference checkpoints a
  pattern period of 8 layers, the port each layer, and each leaves out
  the last products of a checkpointed unit whose outputs the backward
  does not read), which no closed form here names.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

import _torch_flop_terms as F
from repro_torch.configs import get_config
from repro_torch.core.config import ShapeConfig
from repro_torch.device import H100_SXM
from repro_torch.kernels import attention as A
from repro_torch.kernels import partition as K
from repro_torch.launch import dispatch_analysis, dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
RECORD_FIELDS = {
    "arch", "shape", "mesh", "status", "parallel_config", "devices",
    "params", "active_params", "tokens_per_step", "param_bytes_per_device",
    "flops_per_device", "collective_bytes_by_kind", "collective_counts",
    "collective_bytes", "argument_bytes", "output_bytes", "peak_bytes",
    "trace_s", "traced_device", "attention_flops", "kernel_launches",
    "kernel_flops", "kernel_bytes", "flops_by_op", "build_s"}
SMALL_SHAPES = {"train_4k": ShapeConfig("train_4k", 64, 4, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 64, 2, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 64, 4, "decode"),
                "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}


@pytest.fixture
def small(monkeypatch):
    """Smoke configs on a 2 x 2 mesh (4 ranks; 2 x 2 x 2 for ``multi``) at
    small shapes."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod: Mesh(
        {"pod": 2, "data": 2, "model": 2} if multi_pod
        else {"data": 2, "model": 2}))
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"),
                                        ("granite-moe-1b-a400m", "decode_32k"),
                                        ("jamba-v0.1-52b", "prefill_32k")])
def test_run_cell_writes_every_field(small, tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, False, tmp_path, tag="t")
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_FIELDS
    on_disk = json.loads((tmp_path / f"{arch}--{shape}--single-t.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert rec["devices"] == 4 and rec["traced_device"] == "cuda"
    assert rec["flops_per_device"] > 0 and rec["peak_bytes"] \
        >= rec["argument_bytes"] > 0
    if shape == "train_4k":          # K4 forward and recompute, K4b
        assert rec["kernel_launches"] == {
            "flash_attention": 4, "flash_attention_bwd": 2}
    if arch.startswith("granite"):   # the MoE dispatch on K2, K5
        assert {"partition_scatter", "decode_attention"} \
            <= set(rec["kernel_launches"])


def test_erring_cell_is_recorded_and_main_exits_non_zero(small, tmp_path,
                                                         monkeypatch):
    real = dryrun.build_step

    def failing(cfg, *args, **kwargs):
        if cfg.name.startswith("llama"):
            raise RuntimeError("planted")
        return real(cfg, *args, **kwargs)

    monkeypatch.setattr(dryrun, "build_step", failing)
    monkeypatch.setattr(dryrun, "ARCH_IDS", ("llama3.2-3b", "qwen1.5-4b"))
    monkeypatch.setattr(dryrun, "SHAPES", {"decode_32k":
                                           SMALL_SHAPES["decode_32k"]})
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--all", "--mesh", "single", "--out", str(tmp_path)])
    assert exit_.value.code == "1 dry-run cells failed"
    bad = json.loads((tmp_path / "llama3.2-3b--decode_32k--single.json")
                     .read_text())
    assert bad["status"] == "error" and bad["error"] == \
        "RuntimeError: planted" and "planted" in bad["traceback"]
    good = json.loads((tmp_path / "qwen1.5-4b--decode_32k--single.json")
                      .read_text())
    assert good["status"] == "ok"


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_cpu_program_counts_what_the_card_program_does(arch):
    """One production train cell (16 x 16), traced twice."""
    cfg, mesh = get_config(arch), make_production_mesh()
    shape = dryrun.SHAPES["train_4k"]
    try:
        card = dryrun.trace_cell(cfg, shape, mesh)
        cpu = dryrun.trace_cell(cfg, shape, mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    same = ("flops_per_device", "attention_flops", "flops_by_op",
            "collective_bytes_by_kind", "collective_counts",
            "kernel_launches", "kernel_flops", "kernel_bytes",
            "argument_bytes")
    assert {k: cpu[k] for k in same} == {k: card[k] for k in same}
    assert (card["traced_device"], cpu["traced_device"]) == ("cuda", "cpu")
    assert card["kernel_launches"]["flash_attention_bwd"] > 0


def test_modules_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, "
            "repro_torch.launch.dispatch_analysis\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


class _NoCache(dict):
    """A cache that keeps nothing: every operation runs on its meta
    tensors."""

    def __setitem__(self, key, value):
        pass


@pytest.mark.parametrize("arch,mode", [("jamba-v0.1-52b", "train"),
                                       ("xlstm-1.3b", "train"),
                                       ("granite-moe-1b-a400m", "prefill")])
def test_output_cache_changes_nothing_counted(arch, mode, monkeypatch):
    """The trace's shape-keyed output cache against running every
    operation: the same ``Costs``, the peak among them (a warm-up trace
    first, so that tensors the model keeps from call to call, such as its
    rotary frequencies, exist in both)."""
    cfg = get_config(arch, smoke=True)
    F.port_costs(cfg, mode, 2, 64, "block")
    cached = F.port_costs(cfg, mode, 2, 64, "block")
    monkeypatch.setattr(dispatch_analysis.Tracer, "_cache", _NoCache())
    assert F.port_costs(cfg, mode, 2, 64, "block") == cached


# PERF.md's Bound ms: bytes at the H100's 3.35 TB/s, operations at 989
# TFLOP/s (bf16 tensor cores), to the table's four decimals
BF16 = H100_SXM.peak_flops


def _bound_ms(work, ops_per_s=BF16) -> float:
    flops, nbytes = work
    return max(nbytes / H100_SXM.hbm_bw, flops / ops_per_s) * 1e3


BOUNDS = {
    "K1": (K.histogram_work(4_195_989, 512), 0.0050),
    "K2": (K.scatter_work(1 << 23, 9), 0.0300),
    "K3": (K.fused_probe_work(65_470, 8192), 0.00042),
    "K3 2^20": (K.fused_probe_work(1 << 20, 1 << 14), 0.0063),
    "K4": (A.flash_attention_work(4, 1024, 24, 8, 128, 2), 0.0261),
    "K4 offset": (A.flash_attention_work(4, 512, 24, 8, 128, 2, True, 1024,
                                         512), 0.0195),
    "K4b": (A.flash_attention_bwd_work(4, 1024, 24, 8, 128, 2), 0.0651),
    "K4b offset": (A.flash_attention_bwd_work(4, 512, 24, 8, 128, 2, True,
                                              1024, 512), 0.0489),
    "K5": (A.decode_attention_work(4, 24, 8, 128, 2,
                                   476 + 380 + 324 + 216), 0.0017),
    "K5 lse": (A.decode_attention_work(4, 24, 8, 128, 2,
                                       64 + 200 + 320 + 512), 0.0014),
}


@pytest.mark.parametrize("row", list(BOUNDS))
def test_kernel_work_gives_perf_bounds(row):
    work, want = BOUNDS[row]
    digits = len(str(want).split(".")[1])
    assert round(_bound_ms(work), digits) == want


def test_k4_work_is_25_77_gflop_at_its_table_shape():
    flops, nbytes = A.flash_attention_work(4, 1024, 24, 8, 128, 2)
    assert flops == 2 * 4 * 24 * 1024 ** 2 * 128 == 25_769_803_776
    assert nbytes == (2 * 4 * 1024 * 24 + 2 * 4 * 1024 * 8) * 128 * 2


@pytest.mark.parametrize("mode,remat", [("prefill", "none"),
                                        ("train", "none")])
def test_xlstm_flops_match_reference_but_the_named_terms(mode, remat):
    jcfg, tcfg = F.configs("xlstm-1.3b", 8)
    ref = F.reference_flops(jcfg, mode, 2, 256, remat)
    got = F.port_costs(tcfg, mode, 2, 256, remat)
    named = F.terms(tcfg, mode, 2, 256, remat)
    assert ref - int(got.flops) == sum(named.values()), (named, ref,
                                                         got.flops)
    assert got.flops_by_op["aten.convolution"] == -named["conv"] // (
        1 if mode == "prefill" else 3)
