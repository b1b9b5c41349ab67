"""The plain versions of K4 at a query offset, K4b at the same offset and K5
with its log-sum-exp (``repro_torch.kernels.ref``, what the wrappers run
on CPU tensors): the contracts the sequence-parallel attention and the
sequence-split decode cache stand on, held against the JAX reference's
kernel oracles (``repro.kernels.ref``) on the whole sequence, sliced.

- K4's query block ``[lo, lo + S_q)`` at ``q_offset = lo`` against all
  ``S_k`` keys equals rows ``lo .. lo + S_q`` of the whole sequence's
  attention (the reference's ``flash_attention_ref``, kv heads expanded
  with ``jnp.repeat``), and its log-sum-exp the whole sequence's rows;
- K4b at an offset equals autograd's gradient of the plain forward at the
  offset, and the blocks' gradients summed over the blocks equal the whole
  sequence's;
- K5's log-sum-exp equals ``torch.logsumexp`` of the scaled valid scores
  (``-inf`` at length 0), and the outputs of a cache split in blocks,
  combined by their log-sum-exp, equal the reference's
  ``decode_attention_ref`` on the whole cache.

Tolerances in fp32: 2e-5 (the reference's own for its kernels), 1e-5 on
gradients relative to their largest magnitude, 1e-5 on the log-sum-exp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ref as tref

TOL, GRAD_TOL, LSE_TOL = 2e-5, 1e-5, 1e-5


def _randn(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("g", [1, 3])
def test_k4_query_blocks_match_the_whole_sequence(g, blocks, causal):
    rng = np.random.default_rng(g * 10 + blocks)
    b, s, kh, hd = 2, 48, 2, 16
    q, k, v = _randn(rng, (b, s, kh * g, hd)), _randn(rng, (b, s, kh, hd)), \
        _randn(rng, (b, s, kh, hd))
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q.numpy()), jnp.repeat(jnp.asarray(k.numpy()), g, 2),
        jnp.repeat(jnp.asarray(v.numpy()), g, 2), causal=causal))
    whole_lse = tref.flash_attention_lse_ref(q, k, v, causal)
    n = s // blocks
    for lo in range(0, s, n):
        got, lse = tattn.flash_attention_with_lse(q[:, lo:lo + n], k, v,
                                                  causal, lo)
        np.testing.assert_allclose(got.numpy(), want[:, lo:lo + n],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(lse.numpy(),
                                   whole_lse[:, :, lo:lo + n].numpy(),
                                   atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("offset", [0, 5, 16, 40])
def test_k4b_at_an_offset_is_the_gradient_of_k4(offset):
    """K4b's plain version at ``q_offset`` against autograd of the plain
    forward at the same offset (queries of 8 rows against 48 keys)."""
    rng = np.random.default_rng(offset)
    b, sq, sk, kh, g, hd = 2, 8, 48, 2, 2, 16
    q = _randn(rng, (b, sq, kh * g, hd)).requires_grad_(True)
    k = _randn(rng, (b, sk, kh, hd)).requires_grad_(True)
    v = _randn(rng, (b, sk, kh, hd)).requires_grad_(True)
    d_out = _randn(rng, (b, sq, kh * g, hd))
    out = tref.flash_attention_ref(q, k, v, True, offset)
    want = torch.autograd.grad(out, (q, k, v), d_out)
    got = tattn.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                    out.detach(), d_out, True,
                                    q_offset=offset)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        err = float((a - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), (name, err)


def test_k4_blocks_gradients_sum_to_the_whole_sequence():
    """Two query blocks at their offsets through autograd on the CPU (the
    plain versions): their summed K and V gradients and their joined Q
    gradient are the whole sequence's."""
    rng = np.random.default_rng(3)
    b, s, kh, g, hd = 1, 32, 2, 3, 8
    q, k, v = (t.requires_grad_(True) for t in (
        _randn(rng, (b, s, kh * g, hd)), _randn(rng, (b, s, kh, hd)),
        _randn(rng, (b, s, kh, hd))))
    w = _randn(rng, (b, s, kh * g, hd))
    want = torch.autograd.grad((tattn.flash_attention(q, k, v) * w).sum(),
                               (q, k, v))
    parts = torch.cat([tattn.flash_attention(q[:, lo:lo + 16], k, v,
                                             q_offset=lo)
                       for lo in (0, 16)], dim=1)
    got = torch.autograd.grad((parts * w).sum(), (q, k, v))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_k4_refuses_a_negative_offset_and_no_keys():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="q_offset"):
        tattn.flash_attention(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="do not fit"):
        tattn.flash_attention(q, q[:, :0], q[:, :0])


@pytest.mark.parametrize("g", [1, 4])
def test_k5_lse_matches_logsumexp(g):
    rng = np.random.default_rng(g)
    b, s, kh, hd = 4, 40, 2, 16
    q = _randn(rng, (b, kh * g, hd))
    kc, vc = _randn(rng, (b, s, kh, hd)), _randn(rng, (b, s, kh, hd))
    length = torch.tensor([0, 1, 17, 40], dtype=torch.int32)
    out, lse = tattn.decode_attention(q, kc, vc, length, return_lse=True)
    assert torch.equal(out, tattn.decode_attention(q, kc, vc, length))
    assert bool(torch.isneginf(lse[0]).all())
    scores = torch.einsum("bhd,bshd->bhs", q,
                          kc.repeat_interleave(g, dim=2)) * hd ** -0.5
    for row in range(1, b):
        n = int(length[row])
        np.testing.assert_allclose(
            lse[row].numpy(), torch.logsumexp(scores[row, :, :n], -1).numpy(),
            atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("blocks", [2, 4])
def test_k5_blocks_combined_by_lse_match_the_whole_cache(blocks):
    """A cache split in ``blocks`` sequence blocks, each attended with its
    own lengths (``clamp(length - lo, 0, n)``), the outputs combined by
    their log-sum-exp as the sequence-split decode does
    (``models.attention._combine_by_lse`` over ranks): the reference's
    oracle on the whole cache."""
    rng = np.random.default_rng(blocks)
    b, s, kh, g, hd = 4, 48, 2, 3, 16
    q = _randn(rng, (b, kh * g, hd))
    kc, vc = _randn(rng, (b, s, kh, hd)), _randn(rng, (b, s, kh, hd))
    length = torch.tensor([1, 12, 30, 48], dtype=torch.int32)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
        jnp.asarray(vc.numpy()), jnp.asarray(length.numpy())))
    n = s // blocks
    parts, lses = [], []
    for lo in range(0, s, n):
        part, lse = tattn.decode_attention(
            q, kc[:, lo:lo + n], vc[:, lo:lo + n],
            (length - lo).clamp(0, n).to(torch.int32), return_lse=True)
        parts.append(part)
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.max(dim=0).values)
    got = (torch.stack(parts) * w[..., None]).sum(0) / w.sum(0)[..., None]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
