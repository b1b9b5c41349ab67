"""Checkpointing and the supervisor of the PyTorch port (``repro_torch.ckpt``)
against the JAX reference's (``repro.ckpt``).

- The seven contracts of ``tests/test_ckpt.py`` (roundtrip, keep-K, no
  ``.tmp`` left, async, restore after a fault, straggler detection,
  restore onto another sharding), on port states.
- The supervisor's restart point: a fault before the first periodic
  checkpoint restarts the port from the state the run began with; the
  reference's ``Supervisor`` restarts from the state the failed step left
  (pinned below, as ``test_torch_serving.py`` pins the reference's padded
  prefill).
- Across packages: in ``test_torch_ckpt_cross.py`` (the reference's jit
  compiles take most of a minute).
- Resume: 4 steps, a save, a fresh model from another seed loaded, 4 more
  steps equal 8 uninterrupted steps bit for bit (every parameter and
  optimizer leaf); so does a ``Supervisor`` run with a fault at step 5.
"""

import time

import jax.numpy as jnp
import pytest
import torch

import repro.ckpt as jckpt
import repro_torch.ckpt as tckpt
from repro_torch.configs import get_config as tconfig
from repro_torch.core.config import OptimizerConfig, ParallelConfig, \
    ShapeConfig
from repro_torch.data import SyntheticSource
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import init_lm
from repro_torch.parallel.strategies import make_rules, plan_cell
from repro_torch.training import init_train_state, make_train_step

SHAPE = ShapeConfig("t", 32, 2, "train")


def make_state(x=1.0):
    return {"params": {"w": torch.full((4, 4), x)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "m": torch.ones((4, 4))}}


def port_state(arch: str = "llama3.2-3b", seed: int = 0):
    """The port's train state of ``arch``'s smoke config (bfloat16
    weights) from ``seed``, on the CPU."""
    cfg = tconfig(arch, smoke=True)
    model = init_lm(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, init_train_state(cfg, model)


def leaves_of(state) -> dict:
    """``{name: tensor}`` of every parameter and optimizer leaf."""
    out = {f"params.{k}": p.detach()
           for k, p in state["params"].named_parameters()}
    out["opt.step"] = state["opt"]["step"]
    for key in ("master", "m", "v"):
        out.update({f"opt.{key}.{k}": t
                    for k, t in state["opt"][key].items()})
    return out


def bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().view(-1).view(torch.uint8).numpy() \
        .tobytes()


def assert_bit_equal(a, b):
    la, lb = leaves_of(a), leaves_of(b)
    assert list(la) == list(lb)
    differ = [k for k in la if la[k].dtype != lb[k].dtype
              or bits(la[k]) != bits(lb[k])]
    assert not differ, differ


# -- the seven contracts of tests/test_ckpt.py --------------------------------


def test_checkpoint_roundtrip(tmp_path):
    """A port train state (bfloat16 parameters, fp32 optimizer state)
    saved and loaded into a state from another seed, bit for bit."""
    _, state = port_state()
    tckpt.save_checkpoint(tmp_path, 7, state, extra={"step": 7})
    _, other = port_state(seed=1)
    restored, extra = tckpt.load_checkpoint(tmp_path, like=other)
    assert extra["step"] == 7
    assert restored is other
    assert_bit_equal(restored, state)
    # the small state of the reference's test too
    tckpt.save_checkpoint(tmp_path / "small", 7, make_state(2.5))
    small, _ = tckpt.load_checkpoint(tmp_path / "small",
                                     like=make_state(0.0))
    assert torch.equal(small["params"]["w"], torch.full((4, 4), 2.5))
    assert int(small["opt"]["step"]) == 3


def test_checkpoint_keep_k(tmp_path):
    state = make_state()
    for step in range(6):
        tckpt.save_checkpoint(tmp_path, step, state, keep=2)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 2
    assert tckpt.latest_step(tmp_path) == 5


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    (tmp_path / "step_000000009.tmp").mkdir()      # a crashed writer's
    tckpt.save_checkpoint(tmp_path, 1, make_state())
    assert not list(tmp_path.glob("*.tmp"))


def test_async_checkpointer(tmp_path):
    """Each save copies the state on the caller's thread: the values
    written are those at the call, whatever the caller then writes in
    place."""
    ckpt = tckpt.AsyncCheckpointer(tmp_path, keep=3)
    state = make_state()
    for step in (1, 2, 3):
        state["params"]["w"].fill_(float(step))
        ckpt.save(step, state)
    state["params"]["w"].fill_(-1.0)
    ckpt.wait()
    ckpt.close()
    for step in (1, 2, 3):
        restored, _ = tckpt.load_checkpoint(tmp_path, step=step,
                                            like=make_state(0.0))
        assert float(restored["params"]["w"][0, 0]) == float(step)
    assert [r["step"] for r in ckpt.stats] == [1, 2, 3]
    assert all(r["bytes"] == 4 * 16 * 2 + 4 and "write_s" in r
               for r in ckpt.stats)


def _counting_step(state, batch):
    return {"x": state["x"] + 1}, {"loss": 0.0}


def test_supervisor_restores_after_fault(tmp_path):
    """Inject a failure mid-run: the supervisor must restore the newest
    checkpoint and converge to the requested step count."""
    faults = {"armed": True}

    def fault_hook(step):
        if step == 7 and faults["armed"]:
            faults["armed"] = False
            raise RuntimeError("simulated node failure")

    sup = tckpt.Supervisor(_counting_step, lambda step: None, str(tmp_path),
                           ckpt_every=2)
    state, final = sup.run({"x": torch.tensor(0)}, 10,
                           fault_hook=fault_hook)
    assert final == 10
    assert sup.restarts == 1
    # a clean 10-step run's (restart resumed from step 6)
    assert int(state["x"]) == 10


def test_supervisor_straggler_detection(tmp_path):
    times = iter([0.01] * 10 + [0.5] + [0.01] * 5)

    def step_fn(state, batch):
        time.sleep(next(times, 0.0))
        return state, {}

    sup = tckpt.Supervisor(step_fn, lambda s: None, str(tmp_path),
                           ckpt_every=100, straggler_factor=3.0)
    sup.run({"x": 0}, 16)
    assert len(sup.stragglers) >= 1
    assert sup.stragglers[0].step == 10


def test_elastic_restore_different_sharding(tmp_path):
    """Checkpoints hold whole leaves: a restore under the planner's rules
    of a one-rank mesh (each rank's shard of a one-rank split is the whole
    leaf) preserves every value. The split over two ranks is in
    ``test_torch_ckpt_ranks.py``."""
    cfg, state = port_state()
    tckpt.save_checkpoint(tmp_path, 1, state)
    mesh = make_smoke_mesh()
    rules = make_rules(mesh, cfg, SHAPE, plan_cell(cfg, SHAPE, mesh))
    _, other = port_state(seed=1)
    restored, _ = tckpt.load_checkpoint(tmp_path, like=other, rules=rules)
    assert_bit_equal(restored, state)


# -- the restart point before the first checkpoint ----------------------------


def _fault_at(step_at: int):
    armed = {"on": True}

    def hook(step):
        if step == step_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node failure")
    return hook


def _in_place_step(failing_at: int):
    """A step that advances the state in place, as the port's train step
    does, and fails once after its update at step ``failing_at``."""
    armed = {"on": True}

    def step(state, batch):
        at = int(state["x"])
        state["x"].add_(1)
        if at == failing_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node failure mid-update")
        return state, {}
    return step


@pytest.mark.parametrize("ckpt_every", [5, 4])
def test_fault_before_first_checkpoint_restarts_from_initial_state(
        tmp_path, ckpt_every):
    """``x <- x + 1`` a step, a fault at step 3 before the first periodic
    checkpoint, 10 steps: the port ends at 10, with a functional step and
    with one that fails halfway through its in-place update; the
    reference's supervisor at 13 (it keeps the state the steps before the
    fault left)."""
    sup = tckpt.Supervisor(_counting_step, lambda s: None,
                           str(tmp_path / "port"), ckpt_every=ckpt_every)
    state, final = sup.run({"x": torch.tensor(0)}, 10,
                           fault_hook=_fault_at(3))
    assert (final, int(state["x"]), sup.restarts) == (10, 10, 1)
    sup = tckpt.Supervisor(_in_place_step(3), lambda s: None,
                           str(tmp_path / "in_place"), ckpt_every=ckpt_every)
    state, final = sup.run({"x": torch.tensor(0)}, 10)
    assert (final, int(state["x"]), sup.restarts) == (10, 10, 1)

    def jstep(state, batch):
        return {"x": state["x"] + 1}, {"loss": 0.0}

    ref = jckpt.Supervisor(jstep, lambda s: None, str(tmp_path / "ref"),
                           ckpt_every=ckpt_every)
    state, final = ref.run({"x": jnp.asarray(0)}, 10,
                           fault_hook=_fault_at(3))
    assert (final, int(state["x"]), ref.restarts) == (10, 13, 1)


# -- resume bit-equal ---------------------------------------------------------


def _runner(arch: str):
    cfg = tconfig(arch, smoke=True)
    step = make_train_step(cfg, SHAPE, OptimizerConfig(warmup_steps=2),
                           ParallelConfig(remat="block"), total_steps=8,
                           q_chunk=16, ssm_chunk=8)
    source = SyntheticSource(cfg, SHAPE, seed=1)
    return step, source


def _steps(step, source, state, lo: int, hi: int):
    for i in range(lo, hi):
        state, _ = step(state, source.batch(i))
    return state


@pytest.mark.parametrize("arch", ["llama3.2-3b", "xlstm-1.3b"])
def test_resume_is_bit_equal(tmp_path, arch):
    step, source = _runner(arch)
    _, whole = port_state(arch)
    whole = _steps(step, source, whole, 0, 8)

    _, state = port_state(arch)
    state = _steps(step, source, state, 0, 4)
    tckpt.save_checkpoint(tmp_path / "save", 4, state, extra={"step": 4})
    _, resumed = port_state(arch, seed=1)
    resumed, extra = tckpt.load_checkpoint(tmp_path / "save", like=resumed)
    resumed = _steps(step, source, resumed, extra["step"], 8)
    assert_bit_equal(resumed, whole)

    _, state = port_state(arch)
    sup = tckpt.Supervisor(step, source.batch, str(tmp_path / "sup"),
                           ckpt_every=2)
    state, final = sup.run(state, 8, fault_hook=_fault_at(5))
    assert (final, sup.restarts) == (8, 1)
    assert_bit_equal(state, whole)
