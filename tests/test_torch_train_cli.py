"""The training CLI of the PyTorch port (``repro_torch.launch.train``) and
the three LM example twins, on the CPU.

The reference's own CLI test (``tests/test_launch.py::
test_train_cli_end_to_end``) fails on the installed jax (its
``with_sharding_constraint`` under ``set_mesh`` is an assertion when every
mesh axis is ``Explicit``), so the port's CLI is held to that test's
contract: 12 steps of a batch of 2 x 32 tokens, a loss logged every 4 and
a checkpoint every 6, at least two losses. And to the contract of a
resume: ``--steps 6`` then ``--resume --steps 12`` logs the losses of
steps 8 and 12 bit-equal to the uninterrupted run's, and leaves the same
checkpoint of step 12, file for file.
"""

import importlib.util
import math
from pathlib import Path

import pytest

from repro_torch.launch.train import main

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--batch", "2", "--seq", "32", "--log-every",
         "4", "--ckpt-every", "6"]


def _run(ckpt, *args):
    return main(SMALL + ["--ckpt", str(ckpt), *args])


def _files(step_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}


def test_train_cli_end_to_end(tmp_path):
    losses = _run(tmp_path, "--arch", "llama3.2-3b", "--steps", "12")
    assert len(losses) >= 2
    assert all(math.isfinite(x) for x in losses)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_000000000", "step_000000006", "step_000000012"]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-v0.1-52b"])
def test_train_cli_resume_is_bit_equal(tmp_path, arch):
    whole = _run(tmp_path / "whole", "--arch", arch, "--steps", "12")
    first = _run(tmp_path / "split", "--arch", arch, "--steps", "6")
    rest = _run(tmp_path / "split", "--arch", arch, "--steps", "12",
                "--resume")
    assert len(whole) == 3 and len(first) == 1 and len(rest) == 2
    assert first == whole[:1]
    assert rest == whole[1:]              # the losses of steps 8 and 12
    assert _files(tmp_path / "whole" / "step_000000012") \
        == _files(tmp_path / "split" / "step_000000012")


def test_train_cli_microbatches(tmp_path, capsys):
    one = _run(tmp_path / "one", "--steps", "8")
    two = _run(tmp_path / "two", "--steps", "8", "--microbatches", "2")
    assert "scale=2" in capsys.readouterr().out
    assert len(two) == 2 and all(math.isfinite(x) for x in two)
    # bf16 sums in another order: the same losses within 1e-2
    assert two == pytest.approx(one, rel=1e-2)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_train_lm(tmp_path):
    """The ~100M llama example's narrow twin: the supervisor restores
    after the failure injected at half the steps (before the first
    periodic checkpoint at 25: from the starting state's), and the loss
    falls."""
    losses, sup = _example("torch_train_lm").main([
        "--device", "cpu", "--smoke", "--steps", "40", "--batch", "4",
        "--seq", "32", "--ckpt", str(tmp_path)])
    assert sup.restarts == 1
    assert len(losses) == 40 + 20        # steps 0-19 again after the fault
    assert losses[-1] < losses[0]


def test_example_serve_lm():
    done = _example("torch_serve_lm").main(["--device", "cpu"])
    assert len(done) == 12 and all(len(r.output) == 6 for r in done)


def test_example_quickstart():
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert len(out["losses"]) == 5
    assert all(math.isfinite(x) for x in out["losses"])
    assert len(out["served"]) == 3
    assert all(len(r.output) == 4 for r in out["served"])
    assert out["join"].scale > 0
