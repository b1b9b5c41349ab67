"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on meta
tensors over a fake process group (the twin of ``repro/launch/dryrun.py``).

For each cell this:
  1. runs the control-plane decision workflow (``plan_cell``,
     ``make_rules``, priced by ``device.H100_SXM``) and checks the rules
     executable (``require_executable``),
  2. starts a ``"fake"`` process group whose world is the mesh's (256 or
     512 ranks in this one process: ``Mesh.live`` holds and ``Mesh.group``
     builds the real sub-groups; no collective moves a byte),
  3. builds rank 0's shards of the parameters, the optimizer state and the
     decode state on meta tensors (``convert.shard_params``) and the
     global batch, and runs one step as the card would run it: the train
     step (the pipeline's under ``pod_axis_role == "pipeline"``), the
     prefill ``forward`` or ``decode_step``,
  4. counts what the step does at the dispatcher (``dispatch_analysis``):
     matmul and convolution FLOPs, the kernels' work by their formulas,
     collective calls and result bytes by kind, and the bytes live at
     once; and writes one JSON record a cell.

Nothing is allocated and no kernel runs, so no card is needed: the trace
follows the card's program (the kernels' CUDA routes, ``traced_device:
"cuda"``) by default, and the CPU's (their plain routes) with ``--device
cpu``; both count the same FLOPs, collectives and kernel calls.
``device.resolve_device`` is not consulted: the tensors are meta tensors.

The record keeps the reference's fields where they mean the same thing.
The reference's XLA fields have no twin: ``xla_cost_flops_once`` and
``xla_bytes_accessed_once`` are XLA's once-a-loop-body estimates (the
trace counts every iteration), ``temp_size_in_bytes`` and
``alias_size_in_bytes`` describe XLA's buffer assignment, which eager
PyTorch does not have; in their place the record has ``argument_bytes``
and ``output_bytes`` (the step's inputs and outputs on this rank),
``peak_bytes`` (the most bytes live at once during the step), ``trace_s``
(for ``lower_s`` / ``compile_s``) and ``traced_device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.common import applicable_shapes, input_specs
from repro_torch.core.config import (SHAPES, ModelConfig, OptimizerConfig,
                                     ParallelConfig, ShapeConfig)
from repro_torch.device import H100_SXM, Hardware
from repro_torch.launch.dispatch_analysis import Tracer
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.models.convert import shard_params
from repro_torch.models.lm import LM, decode_step, forward, init_decode_state
from repro_torch.parallel.sharding import require_executable, use_rules
from repro_torch.parallel.strategies import (exact_param_bytes_per_chip,
                                             make_rules, plan_cell)
from repro_torch.training.train_step import init_train_state, make_train_step

DEFAULT_OUT = Path("experiments/dryrun_torch")
META = torch.device("meta")
SKIP_REASON = ("long_500k requires sub-quadratic attention "
               "(see DESIGN.md §Arch-applicability)")
PC_FIELDS = ("attn_strategy", "moe_strategy", "layout", "microbatches",
             "remat", "fsdp", "mlp_mode", "causal_skip", "kv_compress",
             "pod_axis_role")


def fake_world(size: int) -> None:
    """A ``"fake"`` process group of ``size`` ranks in this process, this
    one rank 0 (one already running of that size is kept; a fake one of
    another size is replaced; a real one is refused)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running: the dry-run "
                               "needs a fake one of its own")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def plan(cfg: ModelConfig, shape: ShapeConfig, mesh, pc_overrides=None,
         profile: str = "optimized", hw: Hardware = H100_SXM):
    """The decision workflow's ``(pc, rules, pipeline)`` for one cell
    (overrides take part in planning, as in the reference); under the
    pipeline's pod role a train cell's rules are ``pp_rules``'."""
    overrides = ParallelConfig(**pc_overrides) if pc_overrides else None
    pc = plan_cell(cfg, shape, mesh, overrides, profile=profile, hw=hw)
    rules = make_rules(mesh, cfg, shape, pc, hw)
    pipeline = shape.mode == "train" and pc.pod_axis_role == "pipeline"
    if pipeline:
        from repro_torch.parallel.pipeline import pp_applicable, pp_rules
        assert pp_applicable(cfg, shape, mesh, pc), \
            "pipeline schedule inapplicable to this cell"
        rules = pp_rules(rules)
    return pc, rules, pipeline


def packing_plan(arch: str, cfg: ModelConfig, mesh, microbatches: int,
                 pc_overrides=None, profile: str = "optimized",
                 hw: Hardware = H100_SXM):
    """``(pc, rules)`` of ``arch``'s packing cell laid on a smaller mesh:
    ``train_4k`` planned on the 2 x 16 x 16 production mesh with
    ``pod_axis_role="pipeline"``, ``microbatches`` microbatches and
    ``pc_overrides``, its rules made by ``make_rules`` on ``mesh`` (of the
    same axes) for ``cfg`` (the arch, possibly cut in depth or width) at
    the cell's shape, as ``pp_rules``."""
    from repro_torch.parallel.pipeline import pp_rules
    shape = SHAPES["train_4k"]
    pc = plan_cell(get_config(arch), shape,
                   make_production_mesh(multi_pod=True), ParallelConfig(
                       pod_axis_role="pipeline", microbatches=microbatches,
                       **(pc_overrides or {})), profile=profile, hw=hw)
    return pc, pp_rules(make_rules(mesh, cfg, shape, pc, hw))


def planned_fields(cfg: ModelConfig, shape: ShapeConfig, mesh, pc,
                   rules) -> dict:
    """The record's planning fields (the reference's, computed without
    tracing anything)."""
    return {"parallel_config": {k: getattr(pc, k) for k in PC_FIELDS},
            "devices": mesh_devices(mesh),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens_per_step": shape.tokens_per_step,
            "param_bytes_per_device": exact_param_bytes_per_chip(cfg, rules)}


def _inputs(cfg: ModelConfig, shape: ShapeConfig, ranks: int = 1) -> dict:
    """The cell's inputs as meta tensors: the global batch's rows over
    ``ranks`` (the train step takes every rank's rows from the global
    batch itself; ``forward`` and ``decode_step`` are given the rank's)."""
    out = {}
    for k, (dims, dtype) in input_specs(cfg, shape).items():
        if dims[0] % ranks:
            raise ValueError(f"{dims[0]} rows of {k} do not split over "
                             f"{ranks} batch ranks")
        out[k] = torch.empty((dims[0] // ranks,) + tuple(dims[1:]),
                             dtype=dtype, device=META)
    return out


def build_step(cfg: ModelConfig, shape: ShapeConfig, pc: ParallelConfig,
               rules, pipeline: bool = False, ssm_chunk: int = 128):
    """``(fn, args)``: the step of ``shape``'s mode under ``rules`` and
    rank 0's meta-tensor arguments: its shards of the parameters
    (``convert.shard_params`` of a model built on the meta device), the
    optimizer or decode state, and the inputs. The rules' mesh must be live
    (``fake_world``) where they split anything."""
    require_executable(rules, pipeline=pipeline, cfg=cfg)
    model = shard_params(LM(cfg, None, META), rules)
    rows = 1 if shape.mode == "train" else rules.axis_size("batch")
    inputs = _inputs(cfg, shape, rows)

    if shape.mode == "train":
        if pipeline:
            from repro_torch.parallel.pipeline import (init_pp_train_state,
                                                       make_pp_train_step)
            state = init_pp_train_state(cfg, model, rules.mesh)
            fn = make_pp_train_step(cfg, shape, OptimizerConfig(), pc, rules,
                                    ssm_chunk=ssm_chunk)
        else:
            state = init_train_state(cfg, model)
            fn = make_train_step(cfg, shape, OptimizerConfig(), pc,
                                 ssm_chunk=ssm_chunk, rules=rules)
        return fn, (state, inputs)

    if shape.mode == "prefill":
        def prefill(model, inputs):
            with torch.no_grad(), use_rules(rules):
                return forward(model, inputs, ssm_chunk)
        return prefill, (model, inputs)

    with use_rules(rules):
        state = init_decode_state(cfg, shape.global_batch // rows,
                                  shape.seq_len, META)

    def decode(model, state, tokens):
        with torch.no_grad(), use_rules(rules):
            return decode_step(model, state, tokens)
    return decode, (model, state, inputs["tokens"])


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               pc_overrides=None, profile: str = "optimized",
               hw: Hardware = H100_SXM):
    """``(fn, args, rules, pc)``: the cell's step and rank 0's meta-tensor
    arguments, under the decision workflow's rules (``plan``,
    ``build_step``)."""
    pc, rules, pipeline = plan(cfg, shape, mesh, pc_overrides, profile, hw)
    fn, args = build_step(cfg, shape, pc, rules, pipeline)
    return fn, args, rules, pc


def traced_fields(fn, args, device: str = "cuda") -> dict:
    """``fn(*args)`` traced on ``device``'s program: the record's traced
    fields (per device: rank 0's step)."""
    t0 = time.perf_counter()
    tracer = Tracer(device)
    tracer.run(fn, *args)
    c = tracer.costs
    return {"flops_per_device": c.flops,
            "attention_flops": c.attention_flops,
            "flops_by_op": dict(c.flops_by_op),
            "collective_bytes_by_kind": dict(c.collective_bytes),
            "collective_counts": dict(c.collective_counts),
            "collective_bytes": c.total_collective_bytes,
            "kernel_launches": dict(c.kernel_launches),
            "kernel_flops": dict(c.kernel_flops),
            "kernel_bytes": dict(c.kernel_bytes),
            "argument_bytes": c.argument_bytes,
            "output_bytes": c.output_bytes,
            "peak_bytes": c.peak_bytes,
            "trace_s": round(time.perf_counter() - t0, 2),
            "traced_device": device}


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               pc_overrides=None, profile: str = "optimized",
               hw: Hardware = H100_SXM, device: str = "cuda") -> dict:
    """One cell traced on ``device``'s program over a fake process group of
    the mesh's size: the record's planning and traced fields."""
    fake_world(mesh_devices(mesh))
    t0 = time.perf_counter()
    fn, args, rules, pc = build_cell(cfg, shape, mesh, pc_overrides,
                                     profile, hw)
    rec = planned_fields(cfg, shape, mesh, pc, rules)
    rec["build_s"] = round(time.perf_counter() - t0, 2)
    rec.update(traced_fields(fn, args, device))
    return rec


def _write(record: dict, out_dir: Path, tag: str) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"-{tag}" if tag else ""
    path = out_dir / (f"{record['arch']}--{record['shape']}--"
                      f"{record['mesh']}{suffix}.json")
    path.write_text(json.dumps(record, indent=2, default=str))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = DEFAULT_OUT, pc_overrides=None,
             tag: str = "", profile: str = "optimized",
             device: str = "cuda") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "status": "ok"}
    if shape_name not in applicable_shapes(cfg):
        record["status"] = "skipped"
        record["reason"] = SKIP_REASON
        _write(record, out_dir, tag)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIPPED")
        return record

    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        record.update(trace_cell(cfg, shape, mesh, pc_overrides, profile,
                                 device=device))
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"(trace {record['trace_s']:.1f}s, "
              f"flops/dev={record['flops_per_device']:.3e}, "
              f"coll={record['collective_bytes']:.3e}B, "
              f"peak={record['peak_bytes']:.3e}B)")
    except Exception as e:  # noqa: BLE001 - record and continue
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"FAILED {record['error']}")
    _write(record, out_dir, tag)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--tag", default="")
    ap.add_argument("--profile", default="optimized",
                    choices=["optimized", "baseline"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="whose program to trace: the card's kernel routes "
                    "or the CPU's plain ones (nothing runs on either)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    try:
        for arch in archs:
            for shape_name in shapes:
                for multi in meshes:
                    rec = run_cell(arch, shape_name, multi, Path(args.out),
                                   tag=args.tag, profile=args.profile,
                                   device=args.device)
                    failures += rec["status"] == "error"
    finally:
        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
