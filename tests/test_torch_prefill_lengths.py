"""The padded prefill of the PyTorch port with each row's real length
(``models.lm.prefill_step(..., lengths=)``; the Mamba, mLSTM and sLSTM
blocks' ``stop``), on the CPU in fp32.

The serving engine prefills a wave of prompts padded to ``max_seq`` with
token 0. With the lengths, each recurrent block leaves row ``b``'s state
unchanged from position ``lengths[b] - 1`` on, and the row is left at that
position, so the decode step that feeds the row's last real token gives
the logits of the prompt alone. Held (``TOL``, fp32 sums over other
chunkings):

- each block's state with ``stop`` equals the same block fed only the
  row's first ``stop`` positions, over rows of unequal lengths (0, a
  length that is no multiple of the chunk, the whole sequence); a
  ``stop`` at the whole sequence changes nothing, bit for bit;
- the model's (xlstm, jamba drop-free, llama): every recurrent state
  equals ``prefill_step`` over the row's tokens before its last one, and
  the decode step's logits equal ``forward`` over the row's tokens;
- under ranks (``model=2``): xlstm with ``inner`` over ``model``, jamba
  under ``seq_tp`` with ``inner`` and the all-to-all, each rank masking
  its own block of the features (the recurrent blocks see the whole
  sequence), against the unsharded port within ``RANK_TOL``.

The engine's tokens against the greedy continuation of the reference's
``forward`` are held in ``test_torch_serving.py``.
"""

import numpy as np
import pytest
import torch

import _torch_dist as D
from repro_torch.core.config import BlockKind
from repro_torch.models import lm as tlm
from repro_torch.models import init_lm, ssm, xlstm

TOL = 1e-5
RANK_TOL = 1e-4
KINDS = ("mamba", "mlstm", "slstm")
INIT = {"mamba": ssm.init_mamba_state, "mlstm": xlstm.init_mlstm_state,
        "slstm": xlstm.init_slstm_state}
FREE = {"jamba-v0.1-52b": 2.0}       # E / top_k: no expert's slots fill


def _close(got: dict, want: dict, tol: float = TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_block_state_stops_at_each_rows_length(kind, seed):
    cfg = D.smoke(D.BLOCK_ARCH[kind])
    block, fwd, _, _ = D.block_module(kind, cfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4, 24, cfg.d_model))
                         .astype(np.float32))
    stop = [24, 13, 0, 5]
    with torch.no_grad():
        _, state = fwd(block, x, cfg, chunk=8, return_state=True,
                       stop=torch.tensor(stop))
        for b, n in enumerate(stop):
            if n:
                _, want = fwd(block, x[b:b + 1, :n], cfg, chunk=n,
                              return_state=True)
            else:
                want = INIT[kind](cfg, 1, "cpu")
            _close({k: v[b:b + 1] for k, v in state.items()}, want)


@pytest.mark.parametrize("kind", KINDS)
def test_block_stop_at_the_end_changes_nothing(kind):
    cfg = D.smoke(D.BLOCK_ARCH[kind])
    block, fwd, _, _ = D.block_module(kind, cfg)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, state = fwd(block, x, cfg, chunk=8, return_state=True)
        y_s, state_s = fwd(block, x, cfg, chunk=8, return_state=True,
                           stop=torch.tensor([16, 16]))
    assert torch.equal(y, y_s)
    assert all(torch.equal(state[k], state_s[k]) for k in state)


def _model(arch: str):
    cfg = D.smoke(arch, FREE.get(arch))
    return cfg, init_lm(cfg, torch.Generator().manual_seed(0), "cpu")


def _padded_prefill(cfg, model):
    tokens, last = D.lengths_inputs(cfg)
    with torch.no_grad():
        state = tlm.init_decode_state(cfg, len(D.PREFILL_LENGTHS),
                                      D.MAX_SEQ, "cpu")
        _, state = tlm.prefill_step(
            model, state, {"tokens": torch.from_numpy(tokens)},
            ssm_chunk=D.SSM_CHUNK, lengths=torch.tensor(D.PREFILL_LENGTHS))
        states = D.recurrent_states(state, cfg)
        logits, _ = tlm.decode_step(model, state, torch.from_numpy(last))
    return {"pos": state["pos"].numpy(), "states": states,
            "decode": logits.numpy()}


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b",
                                  "llama3.2-3b"])
def test_model_prefill_with_lengths_is_the_prompts_alone(arch):
    cfg, model = _model(arch)
    got = _padded_prefill(cfg, model)
    tokens, _ = D.lengths_inputs(cfg)
    lengths = np.array(D.PREFILL_LENGTHS)
    assert got["pos"].tolist() == np.maximum(lengths - 1, 0).tolist()
    with torch.no_grad():
        for b, n in enumerate(D.PREFILL_LENGTHS):
            if n > 1:
                alone = tlm.init_decode_state(cfg, 1, D.MAX_SEQ, "cpu")
                _, alone = tlm.prefill_step(
                    model, alone, {"tokens": torch.from_numpy(
                        tokens[b:b + 1, :n - 1])}, ssm_chunk=n - 1)
            else:
                alone = tlm.init_decode_state(cfg, 1, D.MAX_SEQ, "cpu")
            _close({k: v[b:b + 1] for k, v in got["states"].items()},
                   D.recurrent_states(alone, cfg))
            fw, _ = tlm.forward(model, {"tokens": torch.from_numpy(
                tokens[b:b + 1, :n])}, ssm_chunk=n)
            np.testing.assert_allclose(got["decode"][b, 0],
                                       fw[0, -1].numpy(), rtol=0, atol=TOL)


M2 = {"data": 1, "model": 2}
SEQ_A2A = dict(attn_strategy="seq_tp", moe_strategy="shard_map_a2a",
               mlp_mode="seq", fsdp="off", remat="block")
INNER = dict(fsdp="off", remat="block")
DECODE = dict(attn_strategy="decode_kv_shard", moe_strategy="gather",
              fsdp="off")
RANK_CASES = [
    dict(id="seq_tp-inner-jamba", arch="jamba-v0.1-52b", mesh=M2,
         pc=SEQ_A2A, serve_pc=DECODE, capacity_factor=FREE["jamba-v0.1-52b"]),
    dict(id="inner-xlstm", arch="xlstm-1.3b", mesh=M2, pc=INNER,
         serve_pc=DECODE)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return D.run_ranks(D.prefill_lengths_rank, 2,
                       tmp_path_factory.mktemp("lengths"), RANK_CASES)


@pytest.mark.parametrize("case", RANK_CASES, ids=[c["id"] for c in
                                                  RANK_CASES])
def test_prefill_with_lengths_under_ranks(ranks, case):
    cfg, model = _model(case["arch"])
    want = _padded_prefill(cfg, model)
    inner = {i for i in range(cfg.num_layers)
             if cfg.block_kind(i) != BlockKind.ATTENTION}
    assert inner
    for rank in ranks:
        got = rank[case["id"]]
        assert got["pos"].tolist() == want["pos"].tolist()
        _close(got["states"], want["states"], RANK_TOL)
        np.testing.assert_allclose(got["decode"], want["decode"], rtol=0,
                                   atol=RANK_TOL)
