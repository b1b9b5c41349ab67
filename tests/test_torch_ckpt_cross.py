"""Checkpoints across the two packages: the PyTorch port's
(``repro_torch.ckpt``) and the JAX reference's (``repro.ckpt``) read each
other's.

The reference's state after one ``make_train_step`` step of a smoke
config (llama, jamba, xlstm; bfloat16 weights, as every config defaults
to) is carried to the port (``params_from_numpy``,
``opt_state_from_numpy``). Each package's checkpoint of it must equal the
other's file for file, byte for byte (the same leaves in the same order,
the same shapes and dtype names), and each package must read the other's:
the reference's leaves' bytes, the port's state bit for bit. The
reference's own reload of a bfloat16 leaf is a 2-byte void array, which
its jitted functions refuse; the port reads it as bfloat16.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as jckpt
import repro.models.lm as jlm
import repro_torch.ckpt as tckpt
from repro.configs import get_config as jconfig
from repro.core.config import OptimizerConfig as JOptimizerConfig
from repro.core.config import ParallelConfig as JParallelConfig
from repro.core.config import ShapeConfig as JShapeConfig
from repro.training import init_opt_state as jinit_opt_state
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tconfig
from repro_torch.data import SyntheticSource
from repro_torch.models.convert import opt_state_from_numpy, \
    params_from_numpy
from test_torch_ckpt import SHAPE, assert_bit_equal, port_state


def _reference_trained(arch: str):
    """The reference's ``{"params", "opt"}`` after one train step of
    ``arch``'s smoke config (bfloat16 weights) on batch 0 of
    ``SyntheticSource(seed=1)``, and the port's state carried across."""
    jcfg, tcfg = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    params, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    state = {"params": params, "opt": jinit_opt_state(params)}
    step = jax.jit(jmake_train_step(
        jcfg, JShapeConfig("t", 32, 2, "train"),
        JOptimizerConfig(warmup_steps=0), JParallelConfig(remat="none"),
        q_chunk=16, ssm_chunk=8))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticSource(tcfg, SHAPE, seed=1).batch(0).items()}
    state, _ = step(state, batch)
    host = jax.tree.map(np.asarray, state)
    port = {"params": params_from_numpy(host["params"], tcfg, "cpu"),
            "opt": opt_state_from_numpy(host["opt"], tcfg, "cpu")}
    return state, port


def _files(path):
    manifest = json.loads((path / "manifest.json").read_text())
    return manifest, [(path / f"leaf_{i:05d}.npy").read_bytes()
                      for i in range(manifest["num_leaves"])]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_each_package_reads_the_others_checkpoint(tmp_path, arch):
    ref_state, port = _reference_trained(arch)
    tckpt.save_checkpoint(tmp_path / "port", 1, port, extra={"step": 1})
    jckpt.save_checkpoint(tmp_path / "ref", 1, ref_state, extra={"step": 1})
    got, want = (_files(tmp_path / d / "step_000000001")
                 for d in ("port", "ref"))
    # the same leaves in the same order: shapes, dtype names, file bytes
    assert got[0]["leaves"] == want[0]["leaves"]
    assert "bfloat16" in {leaf["dtype"] for leaf in got[0]["leaves"]}
    assert got[0]["extra"] == want[0]["extra"]
    differ = [got[0]["treedef"][i] for i, (a, b) in
              enumerate(zip(got[1], want[1])) if a != b]
    assert not differ, differ

    # the reference reads the port's: every leaf's bytes
    restored, extra = jckpt.load_checkpoint(tmp_path / "port",
                                            like=ref_state)
    assert extra == {"step": 1}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref_state)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # the port reads the reference's into a state from another seed
    _, other = port_state(arch, seed=1)
    tckpt.load_checkpoint(tmp_path / "ref", like=other)
    assert_bit_equal(other, port)


def test_reference_reloads_a_bf16_leaf_as_void(tmp_path):
    """The reference's fault the port repairs: its reload of a bfloat16
    leaf is a 2-byte void array, which a jitted function refuses."""
    state = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    jckpt.save_checkpoint(tmp_path, 1, state)
    (leaf,), _ = jckpt.load_checkpoint(tmp_path)
    assert leaf.dtype.str == "|V2"
    with pytest.raises(TypeError, match="abstract array"):
        jax.jit(lambda x: x)(leaf)
    # the port reads the same file as bfloat16
    got = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
    tckpt.load_checkpoint(tmp_path, like=got)
    assert torch.equal(got["w"], torch.ones((2, 3), dtype=torch.bfloat16))
