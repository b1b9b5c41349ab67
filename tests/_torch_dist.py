"""Shared by the port's multi-rank tests (``test_torch_collectives.py``,
``test_torch_data_parallel.py``, ``test_torch_pp.py``): spawn ``gloo``
ranks on the CPU and collect what each returns.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes with
``torch.multiprocessing.spawn``; each sets ``torch.set_num_threads(1)``,
joins the process group through a ``file://`` rendezvous under
``tmp_path`` (so parallel test workers never share a port), calls
``fn(rank, world, *args)`` and pickles its result next to the rendezvous.
A rank that raises fails the spawn. ``fn`` must live in a module the
children can import without JAX: the rank bodies are here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEQ, BATCH = 32, 4
Q_CHUNK, SSM_CHUNK = 16, 8


def _child(rank, world, root, device, fn, args):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    init_distributed(rank, world, f"file://{root}/rendezvous", device)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, tmp_path, *args, device: str = "cpu") -> list:
    return ranks_of(start_ranks(fn, world, tmp_path, *args, device=device))


def start_ranks(fn, world: int, tmp_path, *args, device: str = "cpu"):
    """``run_ranks`` without waiting for the ranks: what ``ranks_of``
    takes (the caller works meanwhile)."""
    root = tmp_path / f"ranks{world}_{fn.__name__}"
    root.mkdir()
    return mp.spawn(_child, args=(world, str(root), device, fn, args),
                    nprocs=world, join=False), root, world


def ranks_of(started) -> list:
    """The results of ``start_ranks``'s ranks, once all have ended."""
    context, root, world = started
    while not context.join():
        pass
    out = []
    for r in range(world):
        with open(root / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the model, its batch and the single-rank step -----------------------------


def smoke(arch: str, capacity_factor: float | None = None,
          num_experts: int | None = None):
    """The port's smoke config of ``arch`` in fp32 (an MoE model's capacity
    factor and expert count replaced by ``capacity_factor`` and
    ``num_experts`` where given)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    moe = {k: v for k, v in (("capacity_factor", capacity_factor),
                             ("num_experts", num_experts)) if v is not None}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def model_of(cfg, device: str = "cpu", seed: int = 0):
    """The port's model with weights from ``seed`` (a generator on
    ``device``), gradients on."""
    from repro_torch.models import init_lm
    from repro_torch.training import init_train_state
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_train_state(cfg, init_lm(cfg, gen, device))


def batch_of(cfg, mask_rows: int = 0, rows: int = BATCH,
             seed: int = 3) -> dict:
    """Batch 0 of ``SyntheticSource(seed=seed)`` at ``rows`` x ``SEQ``;
    with ``mask_rows``, the first that many rows keep a quarter of their
    labels (so ranks' token counts differ)."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.data import SyntheticSource
    shape = ShapeConfig("t", SEQ, rows, "train")
    batch = SyntheticSource(cfg, shape, seed=seed).batch(0)
    labels = batch["labels"]
    labels[:mask_rows, labels.shape[1] // 4:] = -1
    return batch


def params_np(model) -> dict:
    return {k: p.detach().cpu().numpy().copy()
            for k, p in model.named_parameters()}


def step_result(step, state, batch) -> dict:
    """One step's loss, metrics, gradients (before the update) and the
    updated parameters, as numpy."""
    loss, metrics, grads = step.grad_step(state["params"], batch)
    state, out = step(state, batch)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in out.items()},
            "aux": float(metrics["aux"]), "ce": float(metrics["ce"]),
            "tokens": float(metrics["tokens"]),
            "grads": {k: g.cpu().numpy().copy() for k, g in grads.items()},
            "params": params_np(state["params"])}


def single_rank(arch: str, microbatches: int = 1, mask_rows: int = 0,
                device: str = "cpu", seed: int = 0,
                rows: int = BATCH) -> dict:
    """The port's step on the whole batch, no mesh: weights from ``seed``,
    ``batch_of(cfg, mask_rows, rows, seed=3 + seed)``."""
    from repro_torch.core.config import OptimizerConfig, ParallelConfig
    from repro_torch.core.config import ShapeConfig
    from repro_torch.training import make_train_step
    cfg = smoke(arch)
    shape = ShapeConfig("t", SEQ, rows, "train")
    step = make_train_step(cfg, shape, OptimizerConfig(), ParallelConfig(
        remat="block", microbatches=microbatches), q_chunk=Q_CHUNK,
        ssm_chunk=SSM_CHUNK)
    return step_result(step, model_of(cfg, device, seed),
                       batch_of(cfg, mask_rows, rows, 3 + seed))


# -- rank bodies ---------------------------------------------------------------


def dp_rank(rank, world, cases, device="cpu"):
    """Each ``(arch, microbatches, mask_rows)`` case's data-parallel step
    over a ``data=world, model=1`` mesh under the planner's rules, with the
    model on ``device``."""
    from repro_torch.core.config import (OptimizerConfig, ParallelConfig,
                                         ShapeConfig)
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.convert import param_axes
    from repro_torch.parallel.sharding import make_param_sharding
    from repro_torch.parallel.strategies import make_rules, plan_cell
    from repro_torch.training import make_train_step
    mesh = make_smoke_mesh(model=1)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    out = {}
    for arch, microbatches, mask_rows in cases:
        cfg = smoke(arch)
        pc = plan_cell(cfg, shape, mesh, ParallelConfig(
            remat="block", microbatches=microbatches, fsdp="off"))
        rules = make_rules(mesh, cfg, shape, pc)
        step = make_train_step(cfg, shape, OptimizerConfig(), pc,
                               q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK,
                               rules=rules)
        res = step_result(step, model_of(cfg, device),
                          batch_of(cfg, mask_rows))
        res["batch_rule"] = rules.rules["batch"]
        res["index"] = mesh.axes_index(rules.rules["batch"])
        res["placements"] = str(rules.sharding("batch", None, "vocab"))
        res["param_placements"] = str(make_param_sharding(
            rules, param_axes(cfg))["embed"]["table"])
        out[(arch, microbatches, mask_rows)] = res
    return out


def compressed_rank(rank, world, shapes, seed, device="cpu"):
    """``compressed_allreduce`` and the exact sum of per-rank fp32 arrays
    drawn from ``seed + rank`` (on ``device``), and the codes of the first
    quantization."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import collectives as C
    mesh = Mesh({"data": world})
    group = mesh.group("data")
    out = []
    for shape in shapes:
        x = np.random.default_rng(seed + rank).standard_normal(shape) \
            .astype(np.float32) * (1.0 + rank)
        t = torch.from_numpy(x).to(device)
        got = C.compressed_allreduce(t, group).cpu()
        exact = C.all_reduce_(t.clone(), group).cpu()
        flat = np.pad(x.reshape(-1), (0, (-x.size) % world)).reshape(world, -1)
        q, scale = C._quantize(torch.from_numpy(flat))
        out.append({"x": x, "got": got.numpy(), "exact": exact.numpy(),
                    "q": q.numpy(), "scale": float(scale)})
    return out


def grad_mean_rank(rank, world, seed):
    """``make_compressed_grad_allreduce`` over ``data`` of a mapping of
    per-rank gradients, and the exact mean."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import collectives as C
    mesh = Mesh({"data": world, "model": 1})
    rng = np.random.default_rng(seed + rank)
    grads = {"w": torch.from_numpy(rng.standard_normal((8, 5)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(7).astype(
            np.float32))}
    got = C.make_compressed_grad_allreduce(mesh, "data")(grads)
    exact = {k: C.all_reduce_(g.clone(), mesh.group("data")) / world
             for k, g in grads.items()}
    return {k: (got[k].numpy(), exact[k].numpy()) for k in grads}


def pp_rank(rank, world, arch, microbatches, data):
    """The GPipe step over ``pod = world // data`` stages (and ``data``
    ranks): loss, each owned leaf's gradient, the updated parameters."""
    from repro_torch.core.config import (OptimizerConfig, ParallelConfig,
                                         ShapeConfig)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.pipeline import (init_pp_train_state,
                                               make_pp_train_step, pp_rules)
    from repro_torch.parallel.sharding import ShardingRules
    cfg = smoke(arch)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    mesh = Mesh({"pod": world // data, "data": data, "model": 1})
    rules = pp_rules(ShardingRules(mesh, {"batch": ("pod", "data")}))
    pc = ParallelConfig(remat="block", microbatches=microbatches)
    step = make_pp_train_step(cfg, shape, OptimizerConfig(), pc, rules,
                              q_chunk=Q_CHUNK)
    state = init_pp_train_state(cfg, model_of(cfg)["params"], mesh)
    names = list(state["opt"]["master"])
    _, grads, _ = step.grad_step(state["params"], batch_of(cfg))
    state, metrics = step(state, batch_of(cfg))
    named = dict(state["params"].named_parameters())
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "names": names, "stage": mesh.coordinate()["pod"],
            "grads": {k: g.numpy().copy() for k, g in grads.items()},
            "params": {k: named[k].detach().numpy().copy() for k in names}}


PP_MICROBATCHES, PP_ROWS = 4, 8
# the pipeline cases' AdamW (test_torch_pp_tp.py): no warmup, so that the
# first step moves a weight by about the 3e-4 rate, and an eps above the
# rounding of the smallest gradients, which the first step's g / (|g| +
# eps) would otherwise turn into moves of up to the rate
PP_OPT = {"warmup_steps": 0, "eps": 1e-5}


def packing_rules(case: dict, cfg):
    """``(pc, rules)`` of a pipeline case: ``dryrun.packing_plan`` of
    ``case["arch"]``'s packing cell under ``case["profile"]`` with
    ``PP_MICROBATCHES`` microbatches and ``case["override"]``, laid on the
    case's mesh for ``cfg``."""
    from repro_torch.launch.dryrun import packing_plan
    from repro_torch.launch.mesh import Mesh
    return packing_plan(case["arch"], cfg, Mesh(case["mesh"]),
                        PP_MICROBATCHES, case.get("override"),
                        case.get("profile", "optimized"))


def pp_tp_rank(rank, world, cases, seed):
    """Each pipeline case's step (``packing_rules``, AdamW under ``PP_OPT``)
    on the rank's shards of its stage, from ``seed``'s weights on
    ``batch_of(cfg, rows=PP_ROWS, seed=3 + seed)``: loss, grad norm, the
    gradients (after the sums within the pod) and updated values of the
    shards the rank updates with each one's cuts (``convert._cuts``: how
    the whole leaf is sliced to the shard), and the bits of those it holds
    whole."""
    from repro_torch.core.config import OptimizerConfig, ShapeConfig
    from repro_torch.models.convert import _cuts, _meta_leaves, shard_params
    from repro_torch.parallel.pipeline import (init_pp_train_state,
                                               make_pp_train_step)
    out = {}
    for case in cases:
        cfg = smoke(case["arch"])
        pc, rules = packing_rules(case, cfg)
        shape = ShapeConfig("t", SEQ, PP_ROWS, "train")
        local = shard_params(model_of(cfg, seed=seed)["params"], rules)
        state = init_pp_train_state(cfg, local, rules.mesh)
        step = make_pp_train_step(cfg, shape, OptimizerConfig(**PP_OPT), pc,
                                  rules, q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK)
        batch = batch_of(cfg, rows=PP_ROWS, seed=3 + seed)
        _, grads, _ = step.grad_step(state["params"], batch)
        state, metrics = step(state, batch)
        named = dict(state["params"].named_parameters())
        leaves = _meta_leaves(cfg)
        cuts = {k: _cuts(rules, leaves[k][1], tuple(leaves[k][0].shape))
                for k in named}
        out[case["id"]] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "stage": rules.mesh.coordinate()["pod"],
            "grads": {k: g.numpy().copy() for k, g in grads.items()},
            "params": {k: p.detach().numpy().copy()
                       for k, p in named.items()},
            "cuts": cuts,
            "whole": {k: _bits(p) for k, p in named.items() if not cuts[k]},
            "rules": {k: v for k, v in rules.rules.items() if v is not None}}
    return out


def layout_case_rules(case: dict, cfg):
    """``(pc, rules)`` of a layout case: ``sharding.layout_rules`` of its
    ``layout`` (a ``LAYOUTS`` name or a rules dict) on its mesh under
    ``remat="block"`` and its ``pc`` fields, or the planner's
    ``make_rules`` under its ``pc`` fields at the train shape."""
    from repro_torch.core.config import ParallelConfig, ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import layout_rules
    from repro_torch.parallel.strategies import make_rules
    mesh = Mesh(case["mesh"])
    if "layout" in case:
        pc = ParallelConfig(**{"remat": "block", **case.get("pc", {})})
        return pc, layout_rules(mesh, case["layout"])
    pc = ParallelConfig(**case["pc"])
    return pc, make_rules(mesh, cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                          pc)


@contextlib.contextmanager
def counted_dispatch():
    """Within the block, the MoE dispatches' dropped assignments and all of
    their assignments, summed: ``{"dropped", "assignments"}``."""
    from repro_torch.models import moe as M
    plain, seen = M.dispatch, {"dropped": 0, "assignments": 0}

    def counting(top_i, e, cap, start=None):
        bk = plain(top_i, e, cap, start)
        seen["dropped"] += int((~bk.keep).sum())
        seen["assignments"] += bk.keep.numel()
        return bk

    M.dispatch = counting
    try:
        yield seen
    finally:
        M.dispatch = plain


def forward_drops(model, batch, rules=None) -> dict:
    """``counted_dispatch`` of one no-grad ``forward_hidden`` of ``batch``
    (under ``rules``, where given)."""
    from repro_torch.models.lm import forward_hidden
    from repro_torch.parallel.sharding import use_rules
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad(), use_rules(rules), counted_dispatch() as seen:
        forward_hidden(model, batch, remat="none", ssm_chunk=SSM_CHUNK)
    return seen


def layout_rank(rank, world, cases, seed, serve_cases=()):
    """Each layout case's train step (``layout_case_rules``, AdamW under
    ``PP_OPT``, the case's ``regather``) on the rank's shards of
    ``seed``'s weights (the case's ``seed`` where it names one), on
    ``batch_of(cfg, seed=3 + seed)``:
    as ``pp_tp_rank`` gives the
    pipeline's (loss, grad norm, gradient and updated shards with their
    cuts, the bits of the leaves held whole), the rules, and, for an MoE
    model, the dispatches' drops in one forward under the rules
    (``forward_drops``); then ``tp_serve_rank``'s results of
    ``serve_cases``, by their ids."""
    from repro_torch.core.config import OptimizerConfig, ShapeConfig
    from repro_torch.models.convert import (_cuts, _halves, _meta_leaves,
                                            shard_params)
    from repro_torch.parallel.sharding import require_executable
    from repro_torch.training import init_train_state, make_train_step
    out = {}
    for case in cases:
        cfg = smoke(case["arch"], case.get("capacity_factor"),
                    case.get("num_experts"))
        pc, rules = layout_case_rules(case, cfg)
        require_executable(rules, cfg=cfg)
        s = case.get("seed", seed)
        local = shard_params(model_of(cfg, seed=s)["params"], rules)
        batch = batch_of(cfg, seed=3 + s)
        drops = forward_drops(local, batch, rules) if cfg.moe else None
        state = init_train_state(cfg, local)
        step = make_train_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                               OptimizerConfig(**PP_OPT), pc,
                               q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK,
                               rules=rules, regather=case.get("regather"))
        _, _, grads = step.grad_step(state["params"], batch)
        state, metrics = step(state, batch)
        named = dict(state["params"].named_parameters())
        leaves, halves = _meta_leaves(cfg), _halves(cfg)
        cuts = {k: _cuts(rules, leaves[k][1], tuple(leaves[k][0].shape),
                         k in halves) for k in named}
        out[case["id"]] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": {k: g.numpy().copy() for k, g in grads.items()},
            "params": {k: p.detach().numpy().copy()
                       for k, p in named.items()},
            "cuts": cuts, "drops": drops,
            "whole": {k: _bits(p) for k, p in named.items() if not cuts[k]},
            "rules": {k: v for k, v in rules.rules.items() if v is not None}}
    out.update(tp_serve_rank(rank, world, serve_cases))
    return out


# -- tensor, sequence and ZeRO-3 parallelism -------------------------------------


def case_rules(case: dict, mode: str = "train"):
    """The rules of a tensor-parallel test case: the planner's ``make_rules``
    on the case's mesh under its ``ParallelConfig`` fields (``pc``, or
    ``serve_pc`` for the decode rules), with ``override`` set on top; or,
    where the case names them, the hand-written ``layout`` (``serve_layout``
    for the decode rules, ``sharding.layout_rules``)."""
    from repro_torch.core.config import ParallelConfig, ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import layout_rules
    from repro_torch.parallel.strategies import make_rules
    cfg = smoke(case["arch"], case.get("capacity_factor"))
    mesh = Mesh(case["mesh"])
    layout = case.get("serve_layout" if mode == "decode" else "layout")
    if layout is not None:
        shape = ShapeConfig("t", MAX_SEQ if mode == "decode" else SEQ, BATCH,
                            mode)
        return cfg, shape, ParallelConfig(remat="block"), \
            layout_rules(mesh, layout)
    if mode == "decode":
        shape = ShapeConfig(case.get("shape_name", "d"), MAX_SEQ, BATCH,
                            "decode")
        pc = ParallelConfig(**case["serve_pc"])
    else:
        shape = ShapeConfig("t", SEQ, BATCH, mode)
        pc = ParallelConfig(**case["pc"])
    rules = make_rules(mesh, cfg, shape, pc)
    rules.rules.update(case.get("override" if mode != "decode"
                                else "serve_override", {}))
    return cfg, shape, pc, rules


MAX_SEQ = 48
DECODE_STEPS = 3


def serve_inputs(cfg) -> dict:
    """Seeded prompts of ``SEQ`` tokens (with the stub frontend's inputs),
    the decode tokens and the rewound positions of each decode run."""
    rng = np.random.default_rng(11)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
              .astype(np.int32)}
    if cfg.frontend == "vision":
        inputs["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.stub_patches, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio":
        inputs["frame_embeds"] = rng.standard_normal(
            (BATCH, SEQ, 128)).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
             for _ in range(DECODE_STEPS)]
    # rows at different positions, as the engine's rewind leaves them
    pos = np.array([SEQ - 1, SEQ // 2, 3, SEQ - 5][:BATCH], np.int32)
    return {"inputs": inputs, "steps": steps, "pos": pos}


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().view(-1).view(torch.uint8).numpy() \
        .tobytes()


def tp_train_rank(rank, world, cases):
    """Each case's train step on the rank's shards of seed 0's weights:
    loss, metrics, the gradients and updated parameters gathered whole,
    and the bits of every leaf the rank holds whole (replicated)."""
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.models.convert import gather_named, shard_params
    from repro_torch.parallel.tensor import TensorPlan
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.train_step import leaf_axes
    out = {}
    for case in cases:
        cfg, shape, pc, rules = case_rules(case)
        full = model_of(cfg)["params"]
        state = init_train_state(cfg, shard_params(full, rules))
        step = make_train_step(cfg, shape, OptimizerConfig(), pc,
                               q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK,
                               regather=case.get("regather"), rules=rules)
        batch = batch_of(cfg, case.get("mask_rows", 0))
        loss, metrics, grads = step.grad_step(state["params"], batch)
        state, step_metrics = step(state, batch)
        plan = TensorPlan(rules)
        axes = leaf_axes(cfg)
        named = dict(state["params"].named_parameters())
        out[case["id"]] = {
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in step_metrics.items()},
            "grads": {k: g.numpy().copy() for k, g in
                      gather_named(grads, cfg, rules).items()},
            "params": {k: p.numpy().copy() for k, p in
                       gather_named(named, cfg, rules).items()},
            "whole": {k: _bits(p) for k, p in named.items()
                      if not plan.leaf_axes(axes[k])},
            "rules": dict(rules.rules)}
    return out


def tp_serve_rank(rank, world, cases):
    """Each case's ``forward`` and its prefill (under the case's train-shape
    rules in prefill mode) into a decode state made under its decode rules,
    then ``DECODE_STEPS`` decode steps from the rewound positions: every
    logit, on the rank's shards of seed 0's weights."""
    from repro_torch.models import init_lm
    from repro_torch.models import lm as tlm
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import use_rules
    out = {}
    for case in cases:
        cfg, _, _, prefill_rules = case_rules(case, "prefill")
        _, _, _, decode_rules = case_rules(case, "decode")
        full = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        io = serve_inputs(cfg)
        inputs = {k: torch.from_numpy(v) for k, v in io["inputs"].items()}
        res = {}
        with torch.no_grad():
            with use_rules(prefill_rules):
                model = shard_params(full, prefill_rules)
                res["forward"] = tlm.forward(model, inputs)[0].numpy()
            with use_rules(decode_rules):
                state = tlm.init_decode_state(cfg, BATCH, MAX_SEQ, "cpu")
            caches = [st["k"] for st in state["layers"] if "k" in st]
            res["cache_rows"] = int(caches[0].shape[1]) if caches else 0
            res["cache_heads"] = int(caches[0].shape[2]) if caches else 0
            with use_rules(prefill_rules):
                logits, state = tlm.prefill_step(model, state, inputs)
            res["prefill"] = logits.numpy()
            state["pos"] = torch.from_numpy(io["pos"])
            res["decode"] = []
            with use_rules(decode_rules):
                model = shard_params(full, decode_rules)
                for tokens in io["steps"]:
                    logits, state = tlm.decode_step(
                        model, state, torch.from_numpy(tokens))
                    res["decode"].append(logits.numpy())
        res["rules"] = (dict(prefill_rules.rules), dict(decode_rules.rules))
        out[case["id"]] = res
    return out


def tp_rank(rank, world, train_cases, serve_cases, int8_seed):
    """``tp_train_rank``, ``tp_serve_rank`` and ``int8_gather_rank`` in one
    spawn."""
    return {"train": tp_train_rank(rank, world, train_cases),
            "serve": tp_serve_rank(rank, world, serve_cases),
            "int8": int8_gather_rank(rank, world, int8_seed)}


def int8_gather_rank(rank, world, seed):
    """``int8_gather_along`` of a per-rank block along the sequence, the
    exact gather, and the gradient of a weighted sum through it."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import collectives as C
    group = Mesh({"model": world}).group("model")
    blocks = np.random.default_rng(seed).standard_normal(
        (world, 2, 5, 3, 16)).astype(np.float32)
    # each rank weighs the gathered tensor its own way, as each rank's
    # queries read the gathered keys
    w = np.random.default_rng(seed + 1 + rank).standard_normal(
        (2, 5 * world, 3, 16)).astype(np.float32)
    x = torch.from_numpy(blocks[rank]).requires_grad_(True)
    got = C.int8_gather_along(x, 1, group)
    (got * torch.from_numpy(w)).sum().backward()
    return {"got": got.detach().numpy(), "exact": np.concatenate(
        list(blocks), axis=1), "grad": x.grad.numpy(), "w": w}


# -- expert parallelism and the inner split, layer by layer ---------------------


def _leaf_shard(rules, logical, t, halves: bool = False):
    from repro_torch.models.convert import _cuts, _shard
    return _shard(t, _cuts(rules, logical, tuple(t.shape), halves))


def _leaf_whole(rules, logical, t, halves: bool = False):
    """A leaf's (or a gradient's) shards gathered whole (``gather_named``
    for one leaf)."""
    from repro_torch.parallel.collectives import gather_dim
    full = t.detach()
    for dim, axes, _, _, two in reversed(_cuts_of(rules, logical,
                                                  full.shape, halves)):
        group = rules.mesh.group(axes)
        if two:
            full = gather_dim(full.unflatten(dim, (2, full.shape[dim] // 2))
                              .contiguous(), dim + 1, group).flatten(
                dim, dim + 1)
        else:
            full = gather_dim(full.contiguous(), dim, group)
    return full


def _cuts_of(rules, logical, local_shape, halves):
    """``convert._cuts`` of a leaf whose shard has ``local_shape``."""
    from repro_torch.models.convert import _cuts
    whole = list(local_shape)
    for dim, part in enumerate(rules.spec(*logical)):
        axes = part if isinstance(part, tuple) else (part,)
        whole[dim] *= math.prod(int(rules.mesh.shape[a]) for a in axes
                                if a is not None)
    return _cuts(rules, logical, tuple(whole), halves)


def _sync(plan, logical, g, partial: bool = False):
    """A leaf's gradient summed over ``plan.grad_sync_axes`` (as the train
    step sums it)."""
    from repro_torch.parallel.collectives import all_reduce_
    axes = plan.grad_sync_axes(logical, partial)
    return all_reduce_(g.clone(), plan.mesh.group(axes)) if axes else g


def _activation_block(plan, t, seq: bool = True):
    """This rank's rows (batch split) and positions (sequence split) of a
    whole ``(B, S, ...)`` array."""
    lo, n = plan.batch.block(t.shape[0]) if plan.batch else (0, t.shape[0])
    t = t[lo:lo + n]
    if seq and plan.seq:
        lo, n = plan.seq.block(t.shape[1])
        t = t[:, lo:lo + n]
    return t


def _activation_whole(plan, t, seq: bool = True):
    from repro_torch.parallel.collectives import gather_dim
    if seq and plan.seq:
        t = gather_dim(t.contiguous(), 1, plan.seq.group)
    if plan.batch:
        t = gather_dim(t.contiguous(), 0, plan.batch.group)
    return t


def ep_rank(rank, world, cases, arrays):
    """Each case's MoE layer (``models.moe.moe_parts`` under the case's
    rules, in chunks of the case's ``s_chunk`` where given) on the rank's
    shards of the seeded leaves in ``arrays`` and its block of ``x`` (the
    arrays under the case's ``inputs`` prefix, else its arch's; their first
    ``positions`` where given): the output and ``x``'s gradient gathered whole, the
    aux, every leaf's gradient (summed over ``grad_sync_axes`` as the train
    step sums it) gathered whole, and the assignments the rank's
    dispatches dropped. The loss is ``sum(y * g) + aux``."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe as M
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.parallel.tensor import TensorPlan
    data = np.load(arrays)
    out = {}
    for case in cases:
        cfg = smoke(case["arch"], case["capacity_factor"])
        mesh = Mesh(case["mesh"])
        rules = ShardingRules(mesh, case["rules"])
        plan = TensorPlan(rules)
        prefix = case["arch"]
        layer = M.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
        leaves = {}
        for leaf in ("router", "gate", "up", "down"):
            whole = torch.from_numpy(data[f"{prefix}/{leaf}"])
            leaves[leaf] = torch.nn.Parameter(
                _leaf_shard(rules, M.MoE.AXES[leaf], whole))
            setattr(layer, leaf, leaves[leaf])
        inputs, n = case.get("inputs", prefix), case.get("positions")
        x = _activation_block(plan, torch.from_numpy(
            data[f"{inputs}/x"][:, :n])).requires_grad_(True)
        g = _activation_block(plan, torch.from_numpy(
            data[f"{inputs}/g"][:, :n]))
        dropped = []
        plain = M.dispatch

        def counting(top_i, e, cap, start=None):
            bk = plain(top_i, e, cap, start)
            dropped.append(int((~bk.keep).sum()))
            return bk

        M.dispatch = counting
        try:
            y, stats = M.moe_parts(layer, x, cfg,
                                   s_chunk=case.get("s_chunk", 1024),
                                   plan=plan)
        finally:
            M.dispatch = plain
        aux = M.aux_loss(stats, cfg, plan.stats.group)
        loss = (y * g).sum() + aux
        grads = torch.autograd.grad(loss, list(leaves.values()) + [x])
        res = {"aux": float(aux.detach()), "dropped": sum(dropped),
               "rules": dict(rules.rules),
               "y": _activation_whole(plan, y.detach()).numpy(),
               "dx": _activation_whole(plan, grads[-1]).numpy(),
               "grads": {}}
        for leaf, gr in zip(leaves, grads):
            gr = _sync(plan, M.MoE.AXES[leaf], gr)
            res["grads"][leaf] = _leaf_whole(rules, M.MoE.AXES[leaf],
                                             gr).numpy()
        out[case["id"]] = res
    return out


BLOCK_ARCH = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b",
              "slstm": "xlstm-1.3b"}


def block_module(kind: str, cfg):
    """The port's ``kind`` block of ``cfg`` from seed 0 and its forward,
    step and kind (``lm.BlockKind``)."""
    from repro_torch.core.config import BlockKind
    from repro_torch.models import ssm, xlstm
    gen = torch.Generator().manual_seed(0)
    return {"mamba": (ssm.Mamba(cfg, gen, "cpu"), ssm.mamba, ssm.mamba_step,
                      BlockKind.MAMBA),
            "mlstm": (xlstm.MLSTM(cfg, gen, "cpu"), xlstm.mlstm,
                      xlstm.mlstm_step, BlockKind.MLSTM),
            "slstm": (xlstm.SLSTM(cfg, gen, "cpu"), xlstm.slstm,
                      xlstm.slstm_step, BlockKind.SLSTM)}[kind]


def inner_rank(rank, world, cases, arrays, chunk):
    """Each case's recurrent block (``kind``) under the case's rules on the
    rank's shards of the seeded leaves in ``arrays`` and its block of
    ``x`` (its positions under a sequence split): the output, its final
    state and one ``*_step`` from it gathered whole, and the gradients of
    ``sum(out * g)`` with respect to every leaf (summed over
    ``grad_sync_axes`` as the train step sums them) and ``x``."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import _relayout
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.parallel.tensor import TensorPlan
    data = np.load(arrays)
    out = {}
    for case in cases:
        kind = case["kind"]
        cfg = smoke(BLOCK_ARCH[kind])
        mesh = Mesh(case["mesh"])
        rules = ShardingRules(mesh, case["rules"])
        plan = TensorPlan(rules)
        block, fwd, step, bkind = block_module(kind, cfg)
        axes = type(block).AXES
        halves = getattr(type(block), "SPLIT_HALVES", ())
        partial = getattr(type(block), "INNER_PARTIAL", ())
        leaves = {}
        for leaf in axes:
            whole = torch.from_numpy(data[f"{kind}/{leaf}"])
            leaves[leaf] = torch.nn.Parameter(_leaf_shard(
                rules, axes[leaf], whole, leaf in halves))
            setattr(block, leaf, leaves[leaf])
        x = _activation_block(plan, torch.from_numpy(
            data[f"{kind}/x"])).requires_grad_(True)
        g = _activation_block(plan, torch.from_numpy(data[f"{kind}/g"]))
        kw = {"chunk": chunk} if kind != "slstm" else {}
        y, state = fwd(block, x, cfg, return_state=True, plan=plan, **kw)
        grads = torch.autograd.grad((y * g).sum(), list(leaves.values())
                                    + [x])
        res = {"y": _activation_whole(plan, y.detach()).numpy(),
               "dx": _activation_whole(plan, grads[-1]).numpy(),
               "grads": {}, "rules": dict(rules.rules)}
        for leaf, gr in zip(leaves, grads):
            gr = _sync(plan, axes[leaf], gr, leaf in partial)
            res["grads"][leaf] = _leaf_whole(
                rules, axes[leaf], gr, leaf in halves).numpy()
        inner = plan.inner if plan.inner else None
        state = {k: v.detach() for k, v in state.items()}
        res["state"] = {k: _activation_whole(plan, v, seq=False).numpy()
                        for k, v in _relayout(bkind, state, cfg, inner,
                                              None).items()}
        if not plan.seq:
            with torch.no_grad():
                x1 = torch.from_numpy(data[f"{kind}/x1"])
                y1, state1 = step(block, state, x1, cfg, plan)
            res["step"] = y1.numpy()
            res["step_state"] = {k: v.numpy() for k, v in _relayout(
                bkind, state1, cfg, inner, None).items()}
        out[case["id"]] = res
    return out


# -- checkpoints under ranks --------------------------------------------------


def ckpt_leaves(state, cfg, rules=None) -> dict:
    """Every leaf of a train state (parameters, ``opt.step``, ``master``,
    ``m`` and ``v``), gathered whole under ``rules``, as numpy."""
    from repro_torch.models.convert import gather_named

    def whole(named):
        named = dict(named)
        if rules is not None:
            named = gather_named(named, cfg, rules)
        return {k: v.detach().numpy().copy() for k, v in named.items()}

    out = {f"params.{k}": v for k, v in
           whole(state["params"].named_parameters()).items()}
    out["opt.step"] = state["opt"]["step"].numpy().copy()
    for key in ("master", "m", "v"):
        out.update({f"opt.{key}.{k}": v
                    for k, v in whole(state["opt"][key]).items()})
    return out


def ckpt_save_rank(rank, world, case, ckpt_dir, steps, fault_at, every):
    """The case's train step on the rank's shards of seed 0's weights,
    over batches ``0..steps-1`` of ``SyntheticSource(seed=3)``: once
    uninterrupted, and once from seed 0 again under a ``Supervisor`` that
    checkpoints into ``ckpt_dir`` every ``every`` steps, with a fault
    raised on this rank (on every rank alike) at step ``fault_at``. Both
    final states gathered whole, the restarts and the final step."""
    from repro_torch.ckpt import Supervisor
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.data import SyntheticSource
    from repro_torch.models.convert import shard_params
    from repro_torch.training import init_train_state, make_train_step
    cfg, shape, pc, rules = case_rules(case)
    source = SyntheticSource(cfg, shape, seed=3)
    step = make_train_step(cfg, shape, OptimizerConfig(), pc,
                           q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK, rules=rules)

    def fresh():
        return init_train_state(cfg, shard_params(model_of(cfg)["params"],
                                                  rules))

    state = fresh()
    for i in range(steps):
        state, _ = step(state, source.batch(i))
    uninterrupted = ckpt_leaves(state, cfg, rules)
    armed = {"on": True}

    def fault(i):
        if i == fault_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node failure")

    sup = Supervisor(step, source.batch, ckpt_dir, ckpt_every=every,
                     rules=rules)
    state, final = sup.run(fresh(), steps, fault_hook=fault)
    return {"uninterrupted": uninterrupted,
            "supervised": ckpt_leaves(state, cfg, rules),
            "restarts": sup.restarts, "final": final}


def ckpt_restore_rank(rank, world, case, ckpt_dir):
    """The newest checkpoint in ``ckpt_dir`` restored under the case's
    rules into the rank's shards of seed 1's weights, then one step of
    the case's train step on the next batch: the restored and the stepped
    state gathered whole, the loss and the checkpoint's ``extra``."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.data import SyntheticSource
    from repro_torch.models import init_lm
    from repro_torch.models.convert import shard_params
    from repro_torch.training import init_train_state, make_train_step
    cfg, shape, pc, rules = case_rules(case)
    full = init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    state = init_train_state(cfg, shard_params(full, rules))
    state, extra = load_checkpoint(ckpt_dir, like=state, rules=rules)
    restored = ckpt_leaves(state, cfg, rules)
    step = make_train_step(cfg, shape, OptimizerConfig(), pc,
                           q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK, rules=rules)
    state, metrics = step(state, SyntheticSource(cfg, shape, seed=3)
                          .batch(extra["step"]))
    return {"restored": restored, "stepped": ckpt_leaves(state, cfg, rules),
            "loss": float(metrics["loss"]), "extra": extra}


# -- the padded prefill with each row's length --------------------------------

PREFILL_LENGTHS = (SEQ, 13, 1, 20)


def lengths_inputs(cfg, lengths=PREFILL_LENGTHS):
    """Prompts of ``lengths`` tokens from seed 5 padded to ``SEQ`` with
    token 0, and each row's last real token ``(B, 1)``."""
    rng = np.random.default_rng(5)
    tokens = np.zeros((len(lengths), SEQ), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
    last = np.array([[tokens[i, n - 1]] for i, n in enumerate(lengths)],
                    np.int32)
    return tokens, last


def recurrent_states(state, cfg, plan=None) -> dict:
    """``{"layer.key": array}`` of every recurrent layer's state, whole
    (gathered over the inner split the state was made under: a
    collective under a plan)."""
    from repro_torch.core.config import BlockKind
    from repro_torch.models import lm as tlm
    inner = tlm._inner_split(state, plan)
    out = {}
    for i, st in enumerate(state["layers"]):
        kind = cfg.block_kind(i)
        if kind == BlockKind.ATTENTION:
            continue
        for key, v in tlm._relayout(kind, st, cfg, inner, None).items():
            out[f"{i}.{key}"] = v.detach().numpy().copy()
    return out


def prefill_lengths_rank(rank, world, cases):
    """Each case's prefill of ``lengths_inputs``'s padded prompts with
    their lengths, under the case's prefill rules into a decode state made
    under its decode rules, then one decode step of each row's last real
    token under the decode rules: the positions, every recurrent state
    gathered whole and the decode logits, on the rank's shards of seed 0's
    weights."""
    from repro_torch.models import init_lm
    from repro_torch.models import lm as tlm
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import use_rules
    out = {}
    for case in cases:
        cfg, _, _, prefill_rules = case_rules(case, "prefill")
        _, _, _, decode_rules = case_rules(case, "decode")
        full = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens, last = lengths_inputs(cfg)
        with torch.no_grad():
            with use_rules(decode_rules):
                state = tlm.init_decode_state(cfg, BATCH, MAX_SEQ, "cpu")
            with use_rules(prefill_rules):
                model = shard_params(full, prefill_rules)
                _, state = tlm.prefill_step(
                    model, state, {"tokens": torch.from_numpy(tokens)},
                    ssm_chunk=SSM_CHUNK,
                    lengths=torch.tensor(PREFILL_LENGTHS))
            with use_rules(decode_rules):
                plan = tlm.plan_for(cfg)
                states = recurrent_states(state, cfg, plan)
                model = shard_params(full, decode_rules)
                logits, _ = tlm.decode_step(model, state,
                                            torch.from_numpy(last))
        out[case["id"]] = {"pos": state["pos"].numpy().copy(),
                           "states": states, "decode": logits.numpy()}
    return out
