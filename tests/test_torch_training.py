"""Training of the PyTorch port (``repro_torch.training``,
``repro_torch.data``, ``models.lm.forward_hidden``,
``kernels.ref.flash_attention_bwd_ref``) against
the JAX reference on the CPU: the optimizer, the chunked cross-entropy, one
train step of the dense models, the step's equivalences (microbatches,
remat), the synthetic batches, K4b's plain version, and serving after
training. Inputs are seeded numpy arrays; models run in fp32. The other
families' train steps are in ``test_torch_train_families.py``."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.config as jcore
import repro.data as jdata
import repro.training as jtrain
from _torch_train_parity import (
    SHAPE,
    check_train_step,
    configs,
    port_model,
    reference_params,
)
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro.training.optimizer import global_norm as jglobal_norm
from repro_torch import data as tdata
from repro_torch.core import config as tcore
from repro_torch.core.config import OptimizerConfig, ParallelConfig, \
    ShapeConfig
from repro_torch.kernels import ref as tref
from repro_torch.models import forward, init_lm
from repro_torch.models.convert import params_to_numpy
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import (
    apply_updates,
    chunked_cross_entropy,
    init_opt_state,
    init_train_state,
    lr_schedule,
    make_eval_step,
    make_train_step,
)
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_step import make_grad_fn


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# -- configs and data -------------------------------------------------------------


def test_run_configs_are_the_references():
    """The run-level configs are field-for-field copies: equal as dicts and
    fingerprints, and ``override`` reaches nested fields alike."""
    for name in ("OptimizerConfig", "ParallelConfig", "CheckpointConfig"):
        got, want = getattr(tcore, name)(), getattr(jcore, name)()
        assert tcore.asdict(got) == jcore.asdict(want)
        assert tcore.fingerprint(got) == jcore.fingerprint(want)
    jmodel, tmodel = configs("llama3.2-3b")
    tcfg = tcore.RunConfig(tmodel, SHAPE)
    jcfg = jcore.RunConfig(jmodel, jcore.ShapeConfig("t", 32, 2, "train"))
    dotted = {"optimizer.lr": 1e-4, "parallel.microbatches": 4, "steps": 7}
    got, want = tcore.override(tcfg, dotted), jcore.override(jcfg, dotted)
    assert tcore.asdict(got) == jcore.asdict(want)
    assert tcore.fingerprint(got) == jcore.fingerprint(want)
    assert tcore.replace(got, seed=3).seed == 3


@pytest.mark.parametrize("arch", ["llama3.2-3b", "musicgen-medium",
                                  "internvl2-1b"])
def test_synthetic_source_gives_the_references_batches(arch):
    """Bit-equal batches for every step and shard, with the stub
    frontends' patch or frame embeddings."""
    jcfg, tcfg = configs(arch)
    shape = ShapeConfig("t", 32, 4, "train")
    jshape = jcore.ShapeConfig("t", 32, 4, "train")
    for step, shard in ((0, 0), (3, 1), (10, 1)):
        got = tdata.SyntheticSource(tcfg, shape, seed=5, shard=shard,
                                    num_shards=2).batch(step)
        want = jdata.SyntheticSource(jcfg, jshape, seed=5, shard=shard,
                                     num_shards=2).batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_memmap_source_and_prefetcher_give_the_references_batches(tmp_path):
    jcfg, tcfg = configs("llama3.2-3b")
    path = tdata.write_token_file(tmp_path / "tokens.bin", 4096,
                                  tcfg.vocab_size, seed=2)
    jdata.write_token_file(tmp_path / "ref.bin", 4096, jcfg.vocab_size,
                           seed=2)
    assert path.read_bytes() == (tmp_path / "ref.bin").read_bytes()
    shape = ShapeConfig("t", 16, 4, "train")
    jshape = jcore.ShapeConfig("t", 16, 4, "train")
    src = tdata.MemmapSource(str(path), tcfg, shape, shard=1, num_shards=2)
    ref = jdata.MemmapSource(str(path), jcfg, jshape, shard=1, num_shards=2)
    pre = tdata.Prefetcher(src, start_step=2, depth=2)
    try:
        for step in range(2, 6):
            got_step, got = pre.next()
            assert got_step == step
            want = ref.batch(step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        pre.close()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-v0.1-52b"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The reference's bf16 tree (ml_dtypes leaves, the fp32 ones kept)
    comes back bit for bit from the port's model, and the optimizer's fp32
    master restacks to the tree cast to fp32."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in configs(arch))
    params = reference_params(jcfg)
    model = port_model(params, tcfg)
    back = params_to_numpy(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    master = params_to_numpy(init_opt_state(dict(model.named_parameters()))
                             ["master"], tcfg)
    for got, want in zip(jax.tree.leaves(master), jax.tree.leaves(params)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


# -- optimizer --------------------------------------------------------------------


def _opt_inputs(seed: int, grad_scale: float):
    """A 2-D, a 1-D and a bf16 2-D leaf, and three steps of grads."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "h": (4, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("grad_scale", [0.05, 100.0], ids=["unclipped",
                                                           "clipped"])
def test_apply_updates_matches_reference(grad_scale):
    """Three AdamW steps fed the same grads: master, m, v, the parameters
    (fp32 and bf16), grad_norm (pre-clip) and lr within 1e-6 relative."""
    params, grads = _opt_inputs(7, grad_scale)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2)
    jcfg = jcore.OptimizerConfig(lr=1e-2, warmup_steps=2)
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
               for k, v in params.items()}
    jstate = jtrain.init_opt_state(jparams)
    tparams = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "h"
                                         else torch.float32)
               for k, v in params.items()}
    tstate = init_opt_state(tparams)
    for g in grads:
        jparams, jstate, jm = jtrain.apply_updates(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            jcfg, total_steps=50)
        tparams, tstate, tm = apply_updates(
            tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            cfg, total_steps=50)
        for k in ("grad_norm", "lr"):
            _close(float(tm[k]), float(jm[k]), 1e-6)
        assert int(tstate["step"]) == int(jstate["step"])
        for part in ("master", "m", "v"):
            for k in params:
                _close(tstate[part][k].numpy(), jstate[part][k], 1e-6, 1e-12)
        for k in params:
            _close(tparams[k].float().numpy(),
                   np.asarray(jparams[k], np.float32), 1e-6, 1e-12)
    if grad_scale > 1:
        assert float(tm["grad_norm"]) > cfg.grad_clip


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(params, grads, state, cfg,
                                         total_steps=10 ** 6)
    assert float(params["w"].abs().max()) < 0.1


def test_lr_schedule_and_global_norm_match_reference():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)
    jcfg = jcore.OptimizerConfig(lr=1e-3, warmup_steps=10)
    for s in (0, 5, 10, 11, 50, 99, 100, 150):
        _close(float(lr_schedule(cfg, torch.tensor(s), total_steps=100)),
               float(jtrain.lr_schedule(jcfg, jnp.asarray(s),
                                        total_steps=100)), 1e-6)
    assert float(lr_schedule(cfg, 0, total_steps=100)) == 0.0
    rng = np.random.default_rng(1)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("a", (3, 4)), ("b", (7,)))}
    _close(float(global_norm({k: torch.from_numpy(v)
                              for k, v in tree.items()})),
           float(jglobal_norm(tree)), 1e-6)
    assert float(global_norm({"a": torch.tensor([3.0]),
                              "b": torch.tensor([4.0])})) == 5.0


# -- loss -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-4b"],
                         ids=["tied", "untied"])
@pytest.mark.parametrize("s,chunk", [(24, 8), (30, 8), (24, 512)])
def test_chunked_ce_matches_reference(arch, s, chunk):
    """Loss, token count and the gradients to ``h`` and the unembedding at
    1e-5, with masked labels, a sequence the chunk does not divide and one
    chunk; tied (llama) and untied (qwen) embeddings."""
    jcfg, tcfg = configs(arch)
    params = reference_params(jcfg)
    model = port_model(params, tcfg)
    rng = np.random.default_rng(s + chunk)
    h = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, s)).astype(np.int32)
    labels[0, :4] = -1

    def jloss(emb, hh):
        return jtrain.chunked_cross_entropy(emb, hh, jnp.asarray(labels),
                                            jcfg, chunk=chunk)

    (want, count), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        params["embed"], jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    table = model.embed.table if model.embed.unembed is None \
        else model.embed.unembed
    table.requires_grad_(True)
    got, tcount = chunked_cross_entropy(model.embed, th,
                                        torch.from_numpy(labels), tcfg,
                                        chunk=chunk)
    got.backward()
    assert float(tcount) == float(count) == int((labels >= 0).sum())
    _close(got.item(), float(want), 1e-5)
    _close(th.grad.numpy(), jgrads[1], 1e-5, 1e-7)
    key = "table" if model.embed.unembed is None else "unembed"
    _close(table.grad.numpy(), jgrads[0][key], 1e-5, 1e-7)


# -- train step -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-4b"])
def test_train_step_matches_reference(arch):
    """Loss, ce, aux, grad_norm, every gradient leaf and every updated
    parameter against the reference (``_torch_train_parity``)."""
    check_train_step(arch)


def _port_state(arch="llama3.2-3b"):
    _, tcfg = configs(arch)
    model = init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    return tcfg, init_train_state(tcfg, model)


def test_microbatches_agree():
    """One batch and two microbatches: the same loss and grad norm, and
    updated parameters within the reference's 5e-3 (its own test)."""
    tcfg, _ = _port_state()
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=3).batch(0)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0)
    results = []
    for mb in (1, 2):
        _, state = _port_state()
        step = make_train_step(tcfg, SHAPE, opt, ParallelConfig(
            microbatches=mb, remat="none"), q_chunk=16, ssm_chunk=8)
        state, metrics = step(state, batch)
        results.append((state["params"], metrics))
    (p1, m1), (p2, m2) = results
    _close(float(m2["loss"]), float(m1["loss"]), 1e-5)
    _close(float(m2["grad_norm"]), float(m1["grad_norm"]), 1e-5)
    for (name, a), b in zip(p1.named_parameters(), p2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-3, err_msg=name)


@pytest.mark.parametrize("b, mb", [(3, 2), (5, 4)])
def test_microbatches_that_do_not_divide_the_batch_are_refused(b, mb):
    """A batch of ``b`` rows in ``mb`` microbatches: the port raises
    ValueError naming both numbers where it would have dropped the last
    ``b % mb`` rows; the reference refuses it too (a TypeError from its
    reshape). No update is made."""
    jcfg, tcfg = configs("llama3.2-3b")
    shape = ShapeConfig("t", 32, b, "train")
    batch = tdata.SyntheticSource(tcfg, shape, seed=4).batch(0)
    assert batch["tokens"].shape[0] == b
    _, state = _port_state()
    before = [p.detach().clone() for p in state["params"].parameters()]
    step = make_train_step(tcfg, shape, OptimizerConfig(), ParallelConfig(
        microbatches=mb, remat="none"), q_chunk=16, ssm_chunk=8)
    with pytest.raises(ValueError, match=rf"\b{mb}\b.*\b{b}\b"):
        step(state, batch)
    for a, p in zip(before, state["params"].parameters()):
        assert torch.equal(a, p)
    jstep = jtrain.make_train_step(
        jcfg, jcore.ShapeConfig("t", 32, b, "train"), jcore.OptimizerConfig(),
        jcore.ParallelConfig(microbatches=mb, remat="none"), q_chunk=16,
        ssm_chunk=8)
    jstate = jtrain.init_train_state(jcfg, reference_params(jcfg))
    with pytest.raises((TypeError, ValueError)):
        jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})


def test_microbatches_that_divide_the_batch_still_agree():
    """A batch of 4 rows in 2 microbatches still trains on all four: its
    loss and grad norm are one batch's, as in
    ``test_microbatches_agree``."""
    tcfg, _ = _port_state()
    shape = ShapeConfig("t", 32, 4, "train")
    batch = tdata.SyntheticSource(tcfg, shape, seed=6).batch(0)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0)
    metrics = []
    for mb in (1, 2):
        _, state = _port_state()
        step = make_train_step(tcfg, shape, opt, ParallelConfig(
            microbatches=mb, remat="none"), q_chunk=16, ssm_chunk=8)
        metrics.append(step(state, batch)[1])
    for k in ("loss", "grad_norm"):
        _close(float(metrics[1][k]), float(metrics[0][k]), 1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m",
                                  "jamba-v0.1-52b", "xlstm-1.3b"])
def test_remat_policies_give_equal_gradients(arch):
    """``remat`` none, block (each layer recomputed) and dots (its matrix
    products kept) give the same gradients."""
    tcfg, _ = _port_state(arch)
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=4).batch(0)
    grads = {}
    for remat in ("none", "block", "dots"):
        _, state = _port_state(arch)
        _, _, grads[remat] = make_grad_fn(tcfg, ParallelConfig(remat=remat),
                                          ssm_chunk=8)(state["params"], batch)
    for remat in ("block", "dots"):
        for k, g in grads["none"].items():
            torch.testing.assert_close(grads[remat][k], g, rtol=1e-6,
                                       atol=1e-7, msg=f"{remat} {k}")


def test_train_step_reduces_loss_on_fixed_batch():
    """Memorization: repeated steps on one batch descend, as in the
    reference's own test."""
    tcfg, state = _port_state("qwen1.5-4b")
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=1).batch(0)
    step = make_train_step(tcfg, SHAPE, OptimizerConfig(lr=3e-3,
                                                        warmup_steps=0),
                           ParallelConfig(remat="none"), q_chunk=16,
                           ssm_chunk=8)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_eval_step_and_regather():
    """``make_eval_step`` gives the train step's metrics without touching
    the gradients; ``regather`` under ``zero2`` with no mesh (no ZeRO
    shard to gather) leaves the step's gradients as they are."""
    tcfg, state = _port_state()
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=2).batch(0)
    pc = ParallelConfig(remat="block")
    metrics = make_eval_step(tcfg, pc)(state["params"], batch)
    _, want, want_grads = make_grad_fn(tcfg, pc)(state["params"], batch)
    for k in ("ce", "aux", "tokens"):
        assert not metrics[k].requires_grad
        _close(float(metrics[k]), float(want[k]), 1e-6)
    step = make_train_step(tcfg, SHAPE, OptimizerConfig(),
                           ParallelConfig(remat="block", zero2=True),
                           regather=True)
    _, _, grads = step.grad_step(state["params"], batch)
    for k, g in want_grads.items():
        assert torch.equal(grads[k], g), k


def test_slstm_no_grad_path_follows_an_update():
    """After a train step writes ``r_gates`` in place, the sLSTM's no-grad
    path (the ``r_step`` buffer, laid out again) gives the logits of its
    gradient path (laid out inside the graph)."""
    tcfg, state = _port_state("xlstm-1.3b")
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=0).batch(0)
    step = make_train_step(tcfg, SHAPE, OptimizerConfig(lr=1e-2,
                                                        warmup_steps=0),
                           ParallelConfig(remat="none"), ssm_chunk=8)
    model = state["params"]
    tokens = {"tokens": torch.from_numpy(batch["tokens"])}
    with torch.no_grad():
        before, _ = forward(model, tokens, ssm_chunk=8)
    step(state, batch)
    with torch.no_grad():
        frozen, _ = forward(model, tokens, ssm_chunk=8)
    graph, _ = forward(model, tokens, ssm_chunk=8)
    assert graph.requires_grad
    assert not torch.equal(frozen, before)
    torch.testing.assert_close(frozen, graph.detach(), rtol=0, atol=0)


# -- K4b's plain version ----------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 3])
def test_flash_attention_bwd_ref_is_the_gradient(g, causal):
    """The explicit formula equals ``jax.grad`` of the reference's
    ``flash_attention_ref`` (K and V repeated to H heads first, as its
    attention does, so dk and dv sum over each group) and torch autograd
    of the port's plain forward, at 1e-5."""
    b, s, kh, hd = 2, 37, 2, 16
    h = kh * g
    rng = np.random.default_rng(10 * g + causal)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kh, hd)).astype(np.float32)
            for _ in range(2))
    d_out = rng.standard_normal((b, s, h, hd)).astype(np.float32)

    def jattn(q_, k_, v_):
        return jflash_ref(q_, jnp.repeat(k_, g, axis=2),
                          jnp.repeat(v_, g, axis=2), causal=causal)

    out, vjp = jax.vjp(jattn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(d_out))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    tout = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    auto = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(d_out))
    got = tref.flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), tout.detach(),
        torch.from_numpy(d_out), causal=causal)
    _close(tout.detach().numpy(), out, 1e-5, 1e-6)
    for name, x, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert x.shape == a.shape == w.shape, name
        _close(x.numpy(), w, 1e-5, 1e-6)
        _close(x.numpy(), a.numpy(), 1e-5, 1e-6)


# -- serving after training -------------------------------------------------------


def _serve(model, cfg):
    engine = ServingEngine(cfg, model, max_batch=2, max_seq=40, slo_ms=1e9,
                           device="cpu")
    seen = []
    decode = engine._decode

    def recording(model_, state, tokens):
        logits, state = decode(model_, state, tokens)
        seen.append(logits)
        seen.extend(t for st in state["layers"] for t in st.values())
        return logits, state

    engine._decode = recording
    rng = np.random.default_rng(0)
    for i in range(3):
        engine.submit(Request(i, rng.integers(0, cfg.vocab_size,
                                              5 + 4 * i).tolist(),
                              max_new_tokens=4))
    done = engine.run(max_steps=64)
    return {r.req_id: r.output for r in done}, seen


def test_engine_serves_after_a_train_step_without_a_graph():
    """A model whose parameters ask for gradients (after a train step)
    serves the tokens of the same weights frozen, and no logit or state
    tensor of its decode steps records a graph."""
    tcfg, state = _port_state()
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=0).batch(0)
    step = make_train_step(tcfg, SHAPE, OptimizerConfig(lr=1e-2,
                                                        warmup_steps=0),
                           ParallelConfig(remat="block"))
    state, _ = step(state, batch)
    model = state["params"]
    assert all(p.requires_grad for p in model.parameters())
    frozen = copy.deepcopy(model).requires_grad_(False)
    got, seen = _serve(model, tcfg)
    want, _ = _serve(frozen, tcfg)
    assert got == want and len(got) == 3
    assert seen and all(t.grad_fn is None and not t.requires_grad
                        for t in seen)


def test_serving_before_training_leaves_the_step_exact():
    """Serving first (caches made in inference mode) and then training
    gives the same step as training alone."""
    tcfg, state = _port_state()
    _serve(state["params"], tcfg)
    batch = tdata.SyntheticSource(tcfg, SHAPE, seed=0).batch(0)
    step = make_train_step(tcfg, SHAPE, OptimizerConfig(), ParallelConfig())
    _, metrics = step(state, batch)
    _, fresh = _port_state()
    _, want = step(fresh, batch)
    for k in ("loss", "grad_norm"):
        assert float(metrics[k]) == float(want[k])
