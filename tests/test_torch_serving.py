"""The serving engine of the PyTorch port against the JAX reference.

Both engines serve the same requests with the same weights (the
reference's ``init_lm``, carried across by ``params_from_numpy``) and the
same ``max_batch``; they must produce the same tokens, the same step and
prefill counts and the same batching decisions. The token-for-token runs
use fp32 weights, so a greedy argmax never turns on bf16 rounding, and an
SLO so loose that the batching decision never depends on the measured
step time (the reference's first step includes its jit compile).
"""

import dataclasses
from functools import cache

import jax
import numpy as np
import pytest
import torch

import repro.core.controllers as jctl
import repro.core.decisions as jdec
import repro.models.lm as jlm
import repro.serving.engine as jeng
import repro_torch.core.controllers as tctl
import repro_torch.core.decisions as tdec
import repro_torch.models.lm as tlm
import repro_torch.serving.engine as teng
from repro.configs import get_config as jconfig
from repro_torch.configs import get_config as tconfig
from repro_torch.models.convert import params_from_numpy

LOOSE_SLO_MS = 1e9


@pytest.fixture(scope="module")
def weights():
    """{dtype: (reference cfg, params, port cfg, port model)}."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(jconfig("llama3.2-3b", smoke=True),
                                   dtype=dtype)
        tcfg = dataclasses.replace(tconfig("llama3.2-3b", smoke=True),
                                   dtype=dtype)
        params = jax.jit(lambda key, c=jcfg: jlm.init_lm(c, key)[0])(
            jax.random.PRNGKey(0))
        out[dtype] = (jcfg, params, tcfg, params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return out


def _decision(d):
    return (d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes),
            tuple(d.extras))


@pytest.mark.parametrize("queue,slo_ms,decode_ms,max_batch", [
    (3, 200.0, 5.0, 8), (20, 200.0, 5.0, 8), (20, 100.0, 60.0, 8),
    (0, 200.0, 5.0, 4), (7, 50.0, 1e-6, 2)])
def test_batching_decision_matches_reference(queue, slo_ms, decode_ms,
                                             max_batch):
    got = []
    for ctl, dec, eng in ((jctl, jdec, jeng), (tctl, tdec, teng)):
        gc = ctl.GlobalController({0: max_batch})
        ctx = dec.DecisionContext(node_status=gc.node_status(),
                                  app={"queue_depth": queue,
                                       "slo_ms": slo_ms,
                                       "max_batch": max_batch})
        ctx.profile = {"decode_ms_per_step": decode_ms}
        got.append(_decision(eng.batching_decision(ctx)))
    assert got[0] == got[1]


def _serve(eng, cfg, params, prompts, max_new, **kw):
    """Serve ``prompts`` with engine module ``eng`` -> (outputs by request,
    counters, the batching decisions in order)."""
    engine = eng.ServingEngine(cfg, params, slo_ms=LOOSE_SLO_MS, **kw)
    for i, prompt in enumerate(prompts):
        engine.submit(eng.Request(i, list(prompt), max_new_tokens=max_new))
    done = engine.run(max_steps=256)
    decisions = [(d.func, d.scale, d.schedule.policy, tuple(d.schedule.nodes))
                 for _, d in engine.node.history]
    return ({r.req_id: r.output for r in done},
            {k: engine.metrics[k] for k in ("steps", "prefills", "generated",
                                            "batch_occupancy")},
            decisions)


@pytest.mark.parametrize("max_batch,lengths,max_new,max_seq", [
    (2, (11, 5, 17, 3, 6), 3, 48),   # three waves, the last half full
    (3, (4, 3, 21, 17), 5, 24),      # one request stops at max_seq
    (1, (13, 7), 4, 32)])
def test_engine_matches_reference(weights, max_batch, lengths, max_new,
                                  max_seq):
    jcfg, params, tcfg, model = weights["float32"]
    rng = np.random.default_rng(max_batch)
    prompts = [rng.integers(0, 100, n).tolist() for n in lengths]
    want = _serve(jeng, jcfg, params, prompts, max_new,
                  max_batch=max_batch, max_seq=max_seq)
    got = _serve(teng, tcfg, model, prompts, max_new,
                 max_batch=max_batch, max_seq=max_seq, device="cpu")
    assert len(got[0]) == len(lengths)
    assert all(len(got[0][i]) == min(max_new, max_seq - n)
               for i, n in enumerate(lengths))
    assert got == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_matches_offline_greedy(weights, dtype):
    """Engine greedy decode (the decode path, K5's contract) == step-by-step
    full-forward greedy decode (K4's contract), the twin of
    ``tests/test_serving.py::test_engine_matches_offline_greedy``."""
    _, _, cfg, model = weights[dtype]
    prompt = [3, 1, 4, 1, 5, 9]
    engine = teng.ServingEngine(cfg, model, max_batch=1, max_seq=32,
                                device="cpu")
    engine.submit(teng.Request(0, list(prompt), max_new_tokens=3))
    got = engine.run(max_steps=64)[0].output

    seq = list(prompt)
    for _ in range(3):
        lg, _ = tlm.forward(model, {"tokens": torch.tensor([seq])})
        seq.append(int(lg[0, -1].argmax()))
    assert got == seq[len(prompt):]


def test_engine_releases_slots(weights):
    _, _, cfg, model = weights["bfloat16"]
    engine = teng.ServingEngine(cfg, model, max_batch=2, max_seq=32,
                                device="cpu")
    for i in range(3):
        engine.submit(teng.Request(i, [1, 2, 3], max_new_tokens=2))
    engine.run(max_steps=128)
    assert sum(engine.gc.used.values()) == 0
    assert len(engine.metrics["decode_ms"]) == engine.metrics["steps"]
    assert len(engine.metrics["prefill_ms"]) == engine.metrics["prefills"]


def test_engine_refuses_a_model_on_another_device(weights):
    _, _, cfg, model = weights["bfloat16"]
    with pytest.raises(ValueError, match="lives on"):
        teng.ServingEngine(cfg, model, device="meta")


# -- recurrent models and stub frontends ----------------------------------------

# the recurrent families: xlstm (mLSTM + sLSTM) and jamba (Mamba, attention
# and MoE FFNs)
RECURRENT = ("xlstm-1.3b", "jamba-v0.1-52b")


@cache
def _fp32(arch: str, drop_free: bool = False):
    """(reference cfg, params, port cfg, port model) of ``arch``'s smoke
    config in fp32; ``drop_free`` raises a MoE's capacity factor to 8 so
    that no assignment is dropped."""
    jcfg = dataclasses.replace(jconfig(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfig(arch, smoke=True), dtype="float32")
    if drop_free and jcfg.moe is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0)) for c in (jcfg, tcfg))
    params = jax.jit(lambda key: jlm.init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    return jcfg, params, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _reference_greedy(jcfg, params, prompts, outputs) -> list[list[int]]:
    """The reference ``forward``'s argmax at each position where
    ``outputs[i]`` generated a token after ``prompts[i]``, teacher-forced:
    one forward over every prompt followed by its output but the last,
    right-padded (causal, and MoE drop-free: a pad reaches no earlier
    position). It equals ``outputs`` exactly where every output is the
    greedy continuation of its prompt."""
    import jax.numpy as jnp
    seqs = [list(p) + list(o[:-1]) for p, o in zip(prompts, outputs)]
    n = max(map(len, seqs))
    toks = np.zeros((len(seqs), n), np.int32)
    for i, seq in enumerate(seqs):
        toks[i, :len(seq)] = seq
    lg, _ = jlm.forward(params, {"tokens": jnp.asarray(toks)}, jcfg,
                        remat="none", ssm_chunk=n)
    top = np.asarray(jnp.argmax(lg[..., :jcfg.vocab_size], axis=-1))
    return [top[i, len(p) - 1:len(p) - 1 + len(o)].tolist()
            for i, (p, o) in enumerate(zip(prompts, outputs))]


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_matches_reference_on_recurrent_models(arch):
    """With the recurrent states in the decode state (three waves, one
    half full; every wave re-prefilled padded to ``max_seq`` with each
    row's length), the port's engine gives every request the greedy
    continuation of its prompt by the reference's ``forward``, and the
    reference engine's counters and batching decisions (the reference's
    engine feeds its recurrent states the pads, so its tokens are not
    held: ``test_padded_prefill_fault_recurrent_engine_is_not_greedy``).
    jamba's MoE drop-free, so that only the padding is under test."""
    jcfg, params, tcfg, model = _fp32(arch, drop_free=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 100, n).tolist() for n in (11, 5, 17, 3, 6)]
    want = _serve(jeng, jcfg, params, prompts, 3, max_batch=2, max_seq=32)
    got = _serve(teng, tcfg, model, prompts, 3, max_batch=2, max_seq=32,
                 device="cpu")
    assert len(got[0]) == len(prompts)
    assert got[1:] == want[1:]
    outputs = [got[0][i] for i in range(len(prompts))]
    assert _reference_greedy(jcfg, params, prompts, outputs) == outputs


def _greedy(model, prompt: list[int], new: int) -> list[int]:
    seq = list(prompt)
    for _ in range(new):
        lg, _ = tlm.forward(model, {"tokens": torch.tensor([seq])},
                            ssm_chunk=len(seq))
        seq.append(int(lg[0, -1].argmax()))
    return seq[len(prompt):]


@pytest.mark.parametrize("arch,greedy", [("llama3.2-3b", True),
                                         ("xlstm-1.3b", False),
                                         ("jamba-v0.1-52b", False)])
def test_padded_prefill_fault_recurrent_engine_is_not_greedy(arch, greedy):
    """Both engines prefill at ``max_seq`` with the prompt padded by token
    0. The port's passes each row's length, so its recurrent states take
    in no pad and it decodes the greedy continuation on all three models
    (its own ``forward``'s and the reference's). The reference's rewinds
    the positions alone: an attention cache masks the pads, so llama's
    tokens are greedy (``greedy``), but a recurrent state has taken in
    every pad and then the last token twice, so xlstm's and jamba's are
    not (the reference's fault, which the JAX package keeps; jamba's MoE
    drop-free, so that only the padding differs)."""
    jcfg, params, cfg, model = _fp32(arch, drop_free=True)
    prompt = np.random.default_rng(3).integers(0, 100, 10).tolist()
    engine = teng.ServingEngine(cfg, model, max_batch=1, max_seq=32,
                                device="cpu")
    engine.submit(teng.Request(0, list(prompt), max_new_tokens=4))
    got = engine.run(max_steps=64)[0].output
    assert got == _greedy(model, prompt, 4)
    assert _reference_greedy(jcfg, params, [prompt], [got]) == [got]
    ref = jeng.ServingEngine(jcfg, params, max_batch=1, max_seq=32,
                             slo_ms=LOOSE_SLO_MS)
    ref.submit(jeng.Request(0, list(prompt), max_new_tokens=4))
    out = ref.run(max_steps=64)[0].output
    assert (_reference_greedy(jcfg, params, [prompt], [out]) == [out]) \
        == greedy


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_engine_refuses_a_stub_frontend_model(arch):
    """The port's engine refuses a stub-frontend model when it is built;
    the reference's takes it and fails at its first prefill, which lacks
    the frontend's embeddings."""
    jcfg, params, tcfg, model = _fp32(arch)
    with pytest.raises(ValueError, match="stub frontend"):
        teng.ServingEngine(tcfg, model, device="cpu")
    engine = jeng.ServingEngine(jcfg, params, max_batch=1, max_seq=32,
                                slo_ms=LOOSE_SLO_MS)
    engine.submit(jeng.Request(0, [1, 2, 3], max_new_tokens=2))
    with pytest.raises(KeyError):
        engine.run(max_steps=8)
