"""Attention kernels of the PyTorch port against the JAX reference.

The same seeded numpy inputs go through the reference's Pallas kernels
(``repro.kernels.flash_attention`` / ``decode_attention`` in interpret
mode) and the port's dispatch point (``repro_torch.kernels.ops``), which
for CPU tensors runs the kernels' plain versions (``kernels/ref.py``). KV
heads are expanded on each side with its own repeat (``jnp.repeat`` /
``repeat_interleave``), so the GQA head order is held too. Tolerances are
the reference's own (``tests/test_kernels.py``): the Pallas kernels keep
the probabilities in fp32, the plain versions cast them to the value dtype.
The CUDA kernels are held against the plain versions in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(rng, shape, dtype):
    """One standard-normal array as a JAX array and a torch tensor of
    ``dtype`` (both round the same float32 values to bf16)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_flash_attention_plain_matches_pallas(dtype, causal, g):
    rng = np.random.default_rng(10 * g + causal)
    b, s, kh, hd = 2, 32, 2, 16
    jq, tq = _pair(rng, (b, s, kh * g, hd), dtype)
    jk, tk = _pair(rng, (b, s, kh, hd), dtype)
    jv, tv = _pair(rng, (b, s, kh, hd), dtype)
    want = pallas_flash(jq, jnp.repeat(jk, g, axis=2),
                        jnp.repeat(jv, g, axis=2), causal=causal,
                        block_q=16, block_k=16, interpret=True)
    got = tops.flash_attention(tq, tk.repeat_interleave(g, dim=2),
                               tv.repeat_interleave(g, dim=2), causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_decode_attention_plain_matches_pallas(dtype, g):
    rng = np.random.default_rng(20 + g)
    b, s, kh, hd = 3, 64, 2, 16
    jq, tq = _pair(rng, (b, kh * g, hd), dtype)
    jk, tk = _pair(rng, (b, s, kh, hd), dtype)
    jv, tv = _pair(rng, (b, s, kh, hd), dtype)
    length = np.array([1, s, 37], np.int32)           # one key, all, ragged
    want = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=16,
                         interpret=True)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


def test_cpu_tensors_never_count_as_launches():
    tattn.reset_launches()
    q = torch.zeros((1, 5, 2, 8))
    tops.flash_attention(q, q, q)
    tattn.flash_attention_bwd(q, q, q, q, q)
    tops.decode_attention(q[:, 0], q, q, torch.ones((1,), dtype=torch.int32))
    assert tattn.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                              "decode_attention": 0}


@pytest.mark.parametrize("case", ["dtype", "shape", "head_dim", "groups",
                                  "length_dtype", "last_dim_stride"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    q = torch.zeros((1, 4, 2, 8))
    c = torch.zeros((1, 4, 2, 8))
    length = torch.ones((1,), dtype=torch.int32)
    bad = {
        "dtype": lambda: tattn.flash_attention(q.half(), q.half(), q.half()),
        "shape": lambda: tattn.flash_attention(q, q[:, :3], q),
        "head_dim": lambda: tattn.flash_attention(*(3 * [torch.zeros(
            (1, 4, 2, 12))])),
        "groups": lambda: tattn.decode_attention(
            torch.zeros((1, 3, 8)), c, c, length),
        "length_dtype": lambda: tattn.decode_attention(
            q[:, 0], c, c, length.long()),
        "last_dim_stride": lambda: tattn.flash_attention(
            q, q, torch.zeros((1, 4, 8, 2)).transpose(2, 3)),
    }[case]
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_flash_attention_reads_unexpanded_kv(dtype, causal, g):
    """K4 takes the K kv heads as they are and groups them itself; the
    reference gets them expanded by ``jnp.repeat``."""
    rng = np.random.default_rng(30 + 10 * g + causal)
    b, s, kh, hd = 2, 48, 2, 16
    jq, tq = _pair(rng, (b, s, kh * g, hd), dtype)
    jk, tk = _pair(rng, (b, s, kh, hd), dtype)
    jv, tv = _pair(rng, (b, s, kh, hd), dtype)
    want = pallas_flash(jq, jnp.repeat(jk, g, axis=2),
                        jnp.repeat(jv, g, axis=2), causal=causal,
                        block_q=16, block_k=16, interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("s", [32, 37])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 3])
def test_flash_attention_lse_ref_is_the_rows_log_sum_exp(g, causal, s):
    """What K4 writes for K4b: each row's log-sum-exp of the reference's
    scaled, masked scores (``repro.kernels.ref.flash_attention_ref``'s,
    with KV repeated by ``jnp.repeat``), taken in numpy in float64, at
    1e-6; at a tile-sized and a ragged S. The CPU wrapper gives the same
    with the plain forward's output."""
    rng = np.random.default_rng(40 + 10 * g + causal + s)
    b, kh, hd = 2, 2, 16
    jq, tq = _pair(rng, (b, s, kh * g, hd), "float32")
    jk, tk = _pair(rng, (b, s, kh, hd), "float32")
    _, tv = _pair(rng, (b, s, kh, hd), "float32")
    scores = jnp.einsum("bqhk,bshk->bhqs", jq, jnp.repeat(jk, g, axis=2),
                        preferred_element_type=jnp.float32) * (hd ** -0.5)
    x = np.asarray(scores, np.float64)
    if causal:
        x = np.where(np.tril(np.ones((s, s), bool)), x, -np.inf)
    m = x.max(axis=-1, keepdims=True)
    want = (m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True)))[..., 0]
    got = tref.flash_attention_lse_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, kh * g, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    out, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert torch.equal(lse, got)
    assert torch.equal(out, tref.flash_attention_ref(tq, tk, tv, causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_on_the_cpu_ignores_lse(dtype, causal):
    """On CPU tensors K4b's wrapper runs its plain version whether or not
    it is given K4's ``lse``: the same gradients, bit for bit."""
    rng = np.random.default_rng(60 + causal)
    b, s, kh, g, hd = 2, 37, 2, 3, 16
    _, q = _pair(rng, (b, s, kh * g, hd), dtype)
    _, k = _pair(rng, (b, s, kh, hd), dtype)
    _, v = _pair(rng, (b, s, kh, hd), dtype)
    _, d_out = _pair(rng, (b, s, kh * g, hd), dtype)
    out = tref.flash_attention_ref(q, k, v, causal=causal)
    lse = tref.flash_attention_lse_ref(q, k, v, causal=causal)
    without = tattn.flash_attention_bwd(q, k, v, out, d_out, causal)
    with_lse = tattn.flash_attention_bwd(q, k, v, out, d_out, causal, lse)
    for a, w in zip(with_lse, without):
        assert torch.equal(a, w)


@pytest.mark.parametrize("case", ["shape", "dtype", "strides"])
def test_flash_attention_bwd_refuses_a_bad_lse(case):
    """An ``lse`` that is not a contiguous fp32 (B, H, S) tensor raises."""
    q = torch.zeros((1, 6, 4, 8))
    kv = torch.zeros((1, 6, 2, 8))
    lse = {"shape": torch.zeros((1, 6, 4)),
           "dtype": torch.zeros((1, 4, 6), dtype=torch.float64),
           "strides": torch.zeros((1, 6, 4)).transpose(1, 2)}[case]
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_attention_bwd(q, kv, kv, q, q, True, lse)


@pytest.mark.parametrize("kh", [2, 3])
def test_flash_attention_refuses_heads_that_do_not_group(kh):
    q = torch.zeros((1, 4, 5, 8))
    kv = torch.zeros((1, 4, kh, 8))
    with pytest.raises(ValueError, match="do not group"):
        tattn.flash_attention(q, kv, kv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_length_zero_gives_zeros_like_pallas(dtype):
    rng = np.random.default_rng(40)
    b, s, kh, g, hd = 3, 32, 2, 3, 16
    jq, tq = _pair(rng, (b, kh * g, hd), dtype)
    jk, tk = _pair(rng, (b, s, kh, hd), dtype)
    jv, tv = _pair(rng, (b, s, kh, hd), dtype)
    length = np.array([0, 17, 0], np.int32)
    want = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=16,
                         interpret=True)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    assert not bool(got[[0, 2]].any())
    _close(got, want, dtype)


@pytest.mark.parametrize("path", ["forward", "prefill"])
def test_models_hand_k4_the_unexpanded_kv(monkeypatch, path):
    """The model's full and prefill attention pass K and V to K4 with
    their K kv heads (no copy expanded to the query heads)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as mattn
    from repro_torch.models import (
        forward, init_decode_state, init_lm, prefill_step)

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              dtype="float32")
    assert cfg.num_heads > cfg.num_kv_heads
    seen = []
    real = mattn.ops.flash_attention

    def recording(q, k, v, causal=True):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(mattn.ops, "flash_attention", recording)
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)))
    if path == "forward":
        forward(model, {"tokens": tokens})
    else:
        prefill_step(model, init_decode_state(cfg, 2, 16, "cpu"),
                     {"tokens": tokens})
    assert seen == [(cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)] \
        * cfg.num_layers
