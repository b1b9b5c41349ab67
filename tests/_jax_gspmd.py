"""The JAX reference's train step under hand-written rules, placed by
GSPMD on a ``data=2 x model=2`` mesh of ``Auto`` axes over forced host
devices, beside the same step with no mesh: what pins that the reference
runs a layout and what it computes there.

Run as a script in its own process (``start`` starts it, ``results``
reads its answer): ``python tests/_jax_gspmd.py runs.json out.json``,
``runs.json`` mapping a key to ``[arch, rules]`` (``rules`` a dict of
logical axes to mesh axes, lists for tuples). Each run is the fp32 smoke
config of ``arch``, weights from ``init_lm(PRNGKey(0))`` put on the mesh
by ``make_param_sharding``, batch 0 of ``SyntheticSource(seed=0)`` at
4 x 32, one jitted ``make_train_step`` (``remat="none"``) under
``use_rules``; ``out.json`` maps each key to its ``loss`` and
``grad_norm`` and ``whole/<arch>`` to the unsharded step's. Importing
this module imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROWS, SEQ = 4, 32
Q_CHUNK, SSM_CHUNK = 16, 8


def gspmd_step(arch: str, rules: dict | None) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.core.config import (OptimizerConfig, ParallelConfig,
                                   ShapeConfig)
    from repro.data import SyntheticSource
    from repro.models import init_lm
    from repro.parallel.sharding import (ShardingRules, make_param_sharding,
                                         use_rules)
    from repro.training import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    shape = ShapeConfig("t", SEQ, ROWS, "train")
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticSource(cfg, shape, seed=0).batch(0).items()}
    params, axes = init_lm(cfg, jax.random.PRNGKey(0))
    step = make_train_step(cfg, shape, OptimizerConfig(),
                           ParallelConfig(remat="none"), q_chunk=Q_CHUNK,
                           ssm_chunk=SSM_CHUNK)
    if rules is None:
        _, metrics = jax.jit(step)(init_train_state(cfg, params), batch)
    else:
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = ShardingRules(mesh, {k: tuple(v) if isinstance(v, list)
                                     else v for k, v in rules.items()})
        with set_mesh(mesh), use_rules(rules):
            params = jax.device_put(params, make_param_sharding(rules, axes))
            _, metrics = jax.jit(step)(init_train_state(cfg, params), batch)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"])}


def main(runs_path: str, out_path: str) -> None:
    runs = json.loads(Path(runs_path).read_text())
    out = {f"whole/{arch}": gspmd_step(arch, None)
           for arch in sorted({arch for arch, _ in runs.values()})}
    for key, (arch, rules) in runs.items():
        out[key] = gspmd_step(arch, rules)
    Path(out_path).write_text(json.dumps(out))


def start(runs: dict, root: Path) -> subprocess.Popen:
    """This script on ``runs`` in a process of its own, with 8 forced host
    devices; its output goes under ``root``."""
    (root / "gspmd_runs.json").write_text(json.dumps(runs))
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    if "JAX_PLATFORMS" in os.environ:
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    return subprocess.Popen(
        [sys.executable, __file__, str(root / "gspmd_runs.json"),
         str(root / "gspmd_out.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def results(proc: subprocess.Popen, root: Path) -> dict:
    """What ``start``'s process wrote, once it has ended."""
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads((root / "gspmd_out.json").read_text())


if __name__ == "__main__":
    main(*sys.argv[1:3])
