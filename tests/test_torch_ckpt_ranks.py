"""Checkpoints of the PyTorch port under ranks (``repro_torch.ckpt`` with
sharding rules), on spawned ``gloo`` ranks on the CPU (``tests/
_torch_dist.py`` ``run_ranks``).

llama's smoke config in fp32 trains 3 steps on two ranks under
``head_tp`` on ``model=2`` (each rank holding its shards): once
uninterrupted and once under a ``Supervisor`` that checkpoints every 2
steps, with a fault raised on every rank at step 1 (a fault on one rank
alone would leave the others waiting in their collectives; the reference
has no ranks to compare with). Held:

- the supervised run restarts once and ends bit-equal to the
  uninterrupted one, on both ranks;
- the checkpoint of step 3 restored on one rank, whole, into a model from
  another seed: every leaf bit-equal to the ranks' state gathered whole;
  restored under ``pure_dp`` on ``data=2`` (ZeRO-3: each rank its shard):
  every leaf, gathered, bit-equal too (the elastic-rescale path: another
  mesh, other shards);
- one step after each restore: the ``pure_dp`` ranks' loss within 1e-5
  relative and every leaf within 1e-5 absolute of the one-rank step's
  (``TOL``: fp32 sums in another order; the one-rank step is the
  unsharded one).
"""

import numpy as np
import pytest
import torch

import _torch_dist as D
from repro_torch.ckpt import load_checkpoint
from repro_torch.core.config import OptimizerConfig, ParallelConfig
from repro_torch.data import SyntheticSource
from repro_torch.models import init_lm
from repro_torch.training import init_train_state, make_train_step

TOL = 1e-5
ARCH = "llama3.2-3b"
TP = {"arch": ARCH, "mesh": {"data": 1, "model": 2},
      "pc": dict(attn_strategy="head_tp", fsdp="off", remat="block")}
PURE_DP = {"arch": ARCH, "mesh": {"data": 2, "model": 1},
           "pc": dict(attn_strategy="replicated", layout="pure_dp",
                      fsdp="off", remat="dots")}
STEPS, FAULT_AT, EVERY = 3, 1, 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_ranks")
    ckpt = str(root / "ckpt")
    saved = D.run_ranks(D.ckpt_save_rank, 2, root, TP, ckpt, STEPS,
                        FAULT_AT, EVERY)
    restored = D.run_ranks(D.ckpt_restore_rank, 2, root, PURE_DP, ckpt)
    return {"ckpt": ckpt, "saved": saved, "restored": restored}


def _bit_equal(got: dict, want: dict):
    assert list(got) == list(want)
    differ = [k for k in got if got[k].dtype != want[k].dtype
              or got[k].tobytes() != want[k].tobytes()]
    assert not differ, differ


def test_supervised_ranks_restart_bit_equal(runs):
    for rank in runs["saved"]:
        assert (rank["restarts"], rank["final"]) == (1, STEPS)
        _bit_equal(rank["supervised"], rank["uninterrupted"])
    _bit_equal(runs["saved"][1]["supervised"],
               runs["saved"][0]["supervised"])


def _one_rank():
    """The checkpoint's state on one rank (seed 1's model restored), and
    one unsharded step from it."""
    cfg = D.smoke(ARCH)
    state = init_train_state(cfg, init_lm(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    return cfg, state


def test_restore_whole_on_one_rank(runs):
    cfg, state = _one_rank()
    state, extra = load_checkpoint(runs["ckpt"], like=state)
    assert extra == {"step": STEPS}
    _bit_equal(D.ckpt_leaves(state, cfg), runs["saved"][0]["supervised"])


def test_restore_under_pure_dp_and_step(runs):
    cfg, state = _one_rank()
    state, extra = load_checkpoint(runs["ckpt"], like=state)
    shape = D.case_rules(PURE_DP)[1]
    step = make_train_step(cfg, shape, OptimizerConfig(), ParallelConfig(
        remat="block"), q_chunk=D.Q_CHUNK, ssm_chunk=D.SSM_CHUNK)
    state, metrics = step(state, SyntheticSource(cfg, shape, seed=3)
                          .batch(extra["step"]))
    want = D.ckpt_leaves(state, cfg)
    for rank in runs["restored"]:
        assert rank["extra"] == {"step": STEPS}
        _bit_equal(rank["restored"], runs["saved"][0]["supervised"])
        assert rank["loss"] == pytest.approx(float(metrics["loss"]),
                                             rel=TOL)
        for k, v in rank["stepped"].items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=TOL,
                                       err_msg=k)
