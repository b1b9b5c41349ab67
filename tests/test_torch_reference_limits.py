"""The layouts the port keeps refusing because the JAX reference cannot
run them as the unsharded model either (it raises, or computes another
function), pinned on both sides, and the reference's all-to-all beside a
sequence split over other axes than its experts, which it runs and the
port follows.

The reference runs in one subprocess with forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_shardmap_paths.py`` runs it), on meshes of ``Auto`` axes (on
``jax.make_mesh``'s default ``Explicit`` axes the installed jax asserts):

- its pipeline (``make_pp_train_step`` on ``pod=2 x data=2 x model=2``)
  on granite's smoke config raises ``ValueError: Einstein sum subscript
  'df' ...``: the stage body calls ``_apply_block`` with ``is_moe=False``
  (``repro/parallel/pipeline.py:80``), so ``repro/models/lm.py:169-174``
  hands the experts' 3-D weights to the dense ``mlp``;
- its ``moe_shard_map`` (``moe_impl="shard_map_a2a"``) with the experts
  unsplit on ``model=4`` raises ``ValueError: Size of label 'e' ...``:
  ``repro/models/moe.py:138`` cuts ``E // model`` local experts whatever
  the weights' split;
- its ``moe_shard_map`` with the experts over ``data`` beside the batch
  (``data=2 x model=2``, one train step, ``_jax_gspmd.gspmd_step``) runs
  and computes another function than the unsharded step: granite's loss
  6.743961 against 6.826857 (its local experts are ``E // model`` of
  weights split over ``data``);
- its ``moe_shard_map`` with the sequence over ``data`` and the experts
  over ``model`` (``data=2 x model=2``) runs: every expert rank of a data
  block sends the same block at that block's capacity. At the drop-free
  factor 2.0 its output is the unsharded layer's; at granite's 1.25 it is
  the port's layer run on each block at the block's capacity (the
  function ``moe_parts`` computes under ``sharding.LAYOUTS
  ["a2a_beside_seq"]``), within ``TOL`` of its largest magnitude, and
  so is the port's layout on four ``gloo`` ranks, whose drops are the
  per-block layer's.

The port refuses the first three in ``require_executable`` and
``TensorPlan``, each message naming what the reference does.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist as D

TOL = 1e-5
ARCH = "granite-moe-1b-a400m"
B, S = 4, 32

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.configs import get_config
from repro.core.config import OptimizerConfig, ParallelConfig, ShapeConfig
from repro.data import SyntheticSource
from repro.models import init_lm
from repro.models.moe import init_moe, moe
from repro.parallel.pipeline import make_pp_train_step, pp_rules
from repro.parallel.sharding import ShardingRules, use_rules
from repro.training.optimizer import init_opt_state

auto = jax.sharding.AxisType.Auto
errors = {}


def failure(fn):
    try:
        fn()
    except ValueError as e:
        return {"type": "ValueError", "message": str(e)}
    return None


def pipeline():
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    shape = ShapeConfig("pp", 32, 8, "train")
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(auto,) * 3)
    pc = ParallelConfig(microbatches=4, remat="none",
                        attn_strategy="replicated")
    rules = pp_rules(ShardingRules(mesh, {"batch": ("data",),
                                          "layers": None}))
    params, _ = init_lm(cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticSource(cfg, shape, seed=0).batch(0).items()}
    with set_mesh(mesh), use_rules(rules):
        step = jax.jit(make_pp_train_step(
            cfg, shape, OptimizerConfig(warmup_steps=0), pc, rules,
            q_chunk=32))
        step({"params": params, "opt": init_opt_state(params)}, batch)


def a2a_without_experts():
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", smoke=True),
                              dtype="float32")
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto,) * 2)
    p, _ = init_moe(cfg, jax.random.PRNGKey(0))
    rules = {"seq": None, "embed": None, "w_embed": None, "batch": None,
             "expert": None, "moe_impl": "shard_map_a2a"}
    with set_mesh(mesh), use_rules(ShardingRules(mesh, rules)):
        jax.jit(lambda p, x: moe(p, x, cfg))(
            p, jnp.ones((4, 32, cfg.d_model), jnp.float32))


errors["pipeline"] = failure(pipeline)
errors["a2a_without_experts"] = failure(a2a_without_experts)
from _jax_gspmd import gspmd_step
steps = {"whole": gspmd_step("granite-moe-1b-a400m", None),
         "a2a_over_batch": gspmd_step("granite-moe-1b-a400m", {
             "batch": "data", "expert": "data",
             "moe_impl": "shard_map_a2a"})}

data = np.load(sys.argv[1])
out = {}
params = {k: jnp.asarray(data[k]) for k in ("router", "gate", "up", "down")}
x = jnp.asarray(data["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
rules = {"seq": "data", "embed": None, "w_embed": None, "batch": None,
         "vocab": None, "expert": "model", "moe_impl": "shard_map_a2a"}
for cf in (2.0, 1.25):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                         smoke=True), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    out[f"moe/{cf}"] = np.asarray(jax.jit(lambda p, x: moe(p, x, cfg)[0])(
        params, x))
    with set_mesh(mesh), use_rules(ShardingRules(mesh, rules)):
        out[f"a2a_beside_seq/{cf}"] = np.asarray(jax.jit(
            lambda p, x: moe(p, x, cfg)[0])(params, x))
for run, metrics in steps.items():
    for k, v in metrics.items():
        out[f"step/{run}/{k}"] = np.float64(v)
np.savez(sys.argv[2], **out)
print(json.dumps(errors))
"""


def _layer(cf: float):
    from repro_torch.models.moe import MoE
    cfg = D.smoke(ARCH, cf)
    return cfg, MoE(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("limits")
    cfg, layer = _layer(1.25)
    rng = np.random.default_rng(7)
    # a direction every token shares skews the routing, so that the
    # capacity at 1.25 drops assignments
    shared = 2.0 * rng.standard_normal(cfg.d_model)
    arrays = {leaf: getattr(layer, leaf).detach().numpy()
              for leaf in ("router", "gate", "up", "down")}
    arrays["x"] = (rng.standard_normal((B, S, cfg.d_model))
                   + shared).astype(np.float32)
    np.savez(root / "arrays.npz", **arrays)
    env = {"PYTHONPATH": f"src{os.pathsep}{Path(__file__).resolve().parent}",
           "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    if "JAX_PLATFORMS" in os.environ:
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    done = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(root / "arrays.npz"), str(root / "ref.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    errors = json.loads(done.stdout.strip().splitlines()[-1])
    return errors, dict(np.load(root / "ref.npz")), arrays


def test_reference_pipeline_raises_on_an_moe_model(reference):
    err = reference[0]["pipeline"]
    assert err is not None, "the reference's pipeline ran an MoE model"
    assert err["type"] == "ValueError"
    assert "Einstein sum subscript 'df'" in err["message"]


def test_reference_all_to_all_raises_without_the_experts_over_model(
        reference):
    err = reference[0]["a2a_without_experts"]
    assert err is not None, "the reference's moe_shard_map ran unsplit"
    assert err["type"] == "ValueError"
    assert "Size of label 'e'" in err["message"]


@pytest.mark.parametrize("case", ["pipeline", "a2a_without_experts"])
def test_port_refuses_what_the_reference_cannot_run(case):
    from repro_torch.configs import get_config
    from repro_torch.core.config import SHAPES
    from repro_torch.launch.dryrun import plan
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.parallel.sharding import (ShardingRules,
                                               require_executable)
    from repro_torch.parallel.tensor import TensorPlan
    if case == "pipeline":
        cfg = get_config(ARCH)
        _, rules, pipeline = plan(cfg, SHAPES["train_4k"],
                                  make_production_mesh(multi_pod=True),
                                  {"pod_axis_role": "pipeline",
                                   "microbatches": 4})
        assert pipeline and rules.rules["expert"] == "model"
        with pytest.raises(NotImplementedError,
                           match="repro/parallel/pipeline.py:80"):
            require_executable(rules, pipeline, cfg=cfg)
        require_executable(rules, cfg=cfg)
        return
    rules = ShardingRules(Mesh({"data": 2, "model": 4}),
                          {"batch": "data", "moe_impl": "shard_map_a2a"})
    for refuse in (lambda: require_executable(rules),
                   lambda: TensorPlan(rules)):
        with pytest.raises(NotImplementedError,
                           match="repro/models/moe.py:138"):
            refuse()


def test_reference_all_to_all_over_the_batch_axis_computes_another_function(
        reference):
    """The reference's ``moe_shard_map`` with the experts over ``data``
    beside the batch (granite's fp32 smoke config, ``data=2 x model=2``,
    ``_jax_gspmd.gspmd_step``) runs, and its step's loss is not the
    unsharded step's: 6.743961 against 6.826857 (it cuts ``E // model``
    local experts from weights split over ``data``). The port refuses the
    rules, naming that it computes another function."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import (ShardingRules,
                                               require_executable)
    from repro_torch.parallel.tensor import TensorPlan
    out = reference[1]
    whole, got = out["step/whole/loss"], out["step/a2a_over_batch/loss"]
    assert float(whole) == pytest.approx(6.826857, abs=1e-5)
    assert float(got) == pytest.approx(6.743961, abs=1e-5)
    rules = ShardingRules(Mesh({"data": 2, "model": 2}), {
        "batch": "data", "expert": "data", "moe_impl": "shard_map_a2a"})
    for refuse in (lambda: require_executable(rules),
                   lambda: TensorPlan(rules)):
        with pytest.raises(NotImplementedError,
                           match="computes another function"):
            refuse()


def test_reference_all_to_all_beside_a_sequence_split(reference):
    """The reference's ``moe_shard_map`` with the sequence over ``data``
    and the experts over ``model``: the unsharded layer at 2.0, and at
    1.25 the port's layer on each data block at the block's capacity,
    which drops assignments the unsharded layer keeps."""
    from repro_torch.models.moe import moe_parts
    out, arrays = reference[1], reference[2]
    want = out["moe/2.0"]
    np.testing.assert_allclose(out["a2a_beside_seq/2.0"], want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    cfg, layer = _layer(1.25)
    x = torch.from_numpy(arrays["x"])
    with torch.no_grad():
        blocks = [moe_parts(layer, x[:, lo:lo + S // 2], cfg,
                            s_chunk=S // 2)[0] for lo in (0, S // 2)]
    port = torch.cat(blocks, dim=1).numpy()
    got = out["a2a_beside_seq/1.25"]
    np.testing.assert_allclose(got, port, rtol=0,
                               atol=TOL * max(1.0, np.abs(port).max()))
    assert np.abs(got - out["moe/1.25"]).max() > 1e-3


def test_port_all_to_all_beside_a_sequence_split_on_ranks(reference,
                                                          tmp_path):
    """The port's ``sharding.LAYOUTS["a2a_beside_seq"]`` on four ``gloo``
    ranks (``data=2 x model=2``, ``_torch_dist.ep_rank``) at granite's
    1.25: the output gathered whole is the reference's ``moe_shard_map``
    under the same rules within ``TOL``, and the ranks' drops are those of
    the port's layer run on each data block at the block's capacity, once
    for each of the block's two expert ranks, some assignments dropped.
    The unsharded layer's chunk capacity drops other assignments and gives
    another output (``test_reference_all_to_all_beside_a_sequence_split``
    holds the reference's output apart from it)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import moe_parts
    from repro_torch.parallel.sharding import layout_rules
    out, arrays = reference[1], reference[2]
    rng = np.random.default_rng(8)
    named = {f"{ARCH}/{k}": v for k, v in arrays.items()}
    named[f"{ARCH}/g"] = rng.standard_normal(arrays["x"].shape).astype(
        np.float32)
    np.savez(tmp_path / "arrays.npz", **named)
    mesh = {"data": 2, "model": 2}
    case = {"id": "a2a_beside_seq", "arch": ARCH, "capacity_factor": 1.25,
            "mesh": mesh,
            "rules": dict(layout_rules(Mesh(mesh), "a2a_beside_seq").rules)}
    ranks = D.run_ranks(D.ep_rank, 4, tmp_path, [case],
                        str(tmp_path / "arrays.npz"))
    want = out["a2a_beside_seq/1.25"]
    for o in ranks:
        np.testing.assert_allclose(o["a2a_beside_seq"]["y"], want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))
    cfg, layer = _layer(1.25)
    x = torch.from_numpy(arrays["x"])
    with torch.no_grad(), D.counted_dispatch() as blocks:
        for lo in (0, S // 2):
            moe_parts(layer, x[:, lo:lo + S // 2], cfg, s_chunk=S // 2)
    assert blocks["dropped"] > 0
    assert sum(o["a2a_beside_seq"]["dropped"] for o in ranks) == \
        2 * blocks["dropped"]
