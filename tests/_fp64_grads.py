"""Both packages' unsharded gradients of one train step in float64, from
the same weights and batches as their fp32 steps: the witness that tells
rounding from a fault where the fp32 steps differ.

Both packages cast to fp32 by name inside their blocks (the mLSTM's and
sLSTM's gates and scans, the norms), so this process turns on JAX's x64
mode and rebinds ``jax.numpy.float32``, ``torch.float32`` and
``torch.Tensor.float`` to their float64 counterparts before it imports
either package. It must run in a process of its own.

Run as a script: ``python tests/_fp64_grads.py in.npz out.npz``.
``in.npz`` holds ``<key>/arch`` (the architecture's name as a byte
string), ``<key>/w/<port parameter name>`` and ``<key>/b/<batch field>``
for each key; ``out.npz`` holds ``<key>/ref/<name>`` and
``<key>/port/<name>``: the reference's gradient of its ``_loss_fn``
(``remat="none"``) and the port's ``grad_step`` (``remat="block"``),
both in float64 and keyed by the port's parameter names. Importing this
module imports neither package.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

Q_CHUNK, SSM_CHUNK = 16, 8


def _rebind_fp32() -> None:
    import jax
    import jax.numpy as jnp
    import torch
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)


def grads64(arch: str, weights: dict, batch: dict) -> tuple[dict, dict]:
    """The reference's and the port's gradients of ``arch``'s smoke
    config in float64 at ``weights`` (port names) on ``batch``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jconfig
    from repro.core.config import ParallelConfig as JParallelConfig
    from repro.training.train_step import _loss_fn as jloss_fn
    from repro_torch.configs import get_config as tconfig
    from repro_torch.core.config import (OptimizerConfig, ParallelConfig,
                                         ShapeConfig)
    from repro_torch.models import init_lm
    from repro_torch.models.convert import (params_from_numpy,
                                            params_to_numpy)
    from repro_torch.training import init_train_state, make_train_step

    jcfg, tcfg = (dataclasses.replace(get(arch, smoke=True), dtype="float64")
                  for get in (jconfig, tconfig))
    model = init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(weights[k]))
    model = init_train_state(tcfg, model)["params"]
    rows, seq = batch["labels"].shape
    step = make_train_step(tcfg, ShapeConfig("t", seq, rows, "train"),
                           OptimizerConfig(), ParallelConfig(remat="block"),
                           q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK)
    port = {k: g.detach().numpy() for k, g in
            step.grad_step(model, batch)[2].items()}
    params = jax.tree.map(jnp.asarray, params_to_numpy(model, tcfg))
    grads = jax.jit(jax.grad(lambda p, b: jloss_fn(
        p, b, jcfg, JParallelConfig(remat="none"), Q_CHUNK, SSM_CHUNK)[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: p.detach().numpy() for k, p in params_from_numpy(
        jax.tree.map(np.asarray, grads), tcfg, "cpu").named_parameters()}
    return ref, port


def main(in_path: str, out_path: str) -> None:
    _rebind_fp32()
    import numpy as np
    data = np.load(in_path)
    out = {}
    for key in sorted({f.split("/")[0] for f in data.files}):
        def part(kind):
            pre = f"{key}/{kind}/"
            return {f[len(pre):]: data[f] for f in data.files
                    if f.startswith(pre)}
        ref, port = grads64(data[f"{key}/arch"].tobytes().decode(),
                            part("w"), part("b"))
        out.update({f"{key}/ref/{k}": v for k, v in ref.items()})
        out.update({f"{key}/port/{k}": v for k, v in port.items()})
    np.savez(out_path, **out)


def start(runs: dict, root: Path) -> subprocess.Popen:
    """This script in a process of its own on ``runs``, mapping a key to
    ``(arch, weights, batch)`` (numpy arrays, the weights by port name);
    its output goes under ``root``."""
    import numpy as np
    arrays = {}
    for key, (arch, weights, batch) in runs.items():
        arrays[f"{key}/arch"] = np.frombuffer(arch.encode(), np.uint8)
        arrays.update({f"{key}/w/{k}": v for k, v in weights.items()})
        arrays.update({f"{key}/b/{k}": v for k, v in batch.items()})
    np.savez(root / "fp64_in.npz", **arrays)
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp")}
    if "JAX_PLATFORMS" in os.environ:
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    return subprocess.Popen(
        [sys.executable, __file__, str(root / "fp64_in.npz"),
         str(root / "fp64_out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def results(proc: subprocess.Popen, root: Path) -> dict:
    """``{key: {"ref": grads, "port": grads}}`` from ``start``'s process,
    once it has ended."""
    import numpy as np
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    data = np.load(root / "fp64_out.npz")
    out: dict = {}
    for f in data.files:
        key, side, name = f.split("/", 2)
        out.setdefault(key, {}).setdefault(side, {})[name] = data[f]
    return out


if __name__ == "__main__":
    main(*sys.argv[1:3])
