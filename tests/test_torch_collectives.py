"""The port's int8-wire all-reduce (``repro_torch.parallel.collectives``)
over spawned ``gloo`` ranks on the CPU (``_torch_dist.run_ranks``, a
``file://`` rendezvous under the test's ``tmp_path``).

The result is held against the exact sum with the reference's own bound
(``tests/test_collectives.py``: the largest error under 0.02 of the
largest magnitude, every rank agreeing to 1e-6), and against a numpy model
of the algorithm (quantize every rank's padded chunks with one scale,
sum each chunk's dequantized codes, requantize, dequantize): the codes of
the first quantization exactly, the result to 1e-6. The reference's own
test cannot run here, so the port is held against the arithmetic.
"""

import numpy as np
import pytest

from _torch_dist import compressed_rank, grad_mean_rank, run_ranks

SHAPES = [(8, 4096), (1001,), (3, 5, 7)]
REL_BOUND, AGREE, MODEL_TOL = 0.02, 1e-6, 1e-6


def _quantize(x: np.ndarray):
    """Round half to even, as jnp.round and torch.round do."""
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12)) / 127.0)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _model(xs: list[np.ndarray]) -> np.ndarray:
    """The two-phase int8 all-reduce of the per-rank arrays ``xs``."""
    n = len(xs)
    size = xs[0].size
    chunks, scales = [], []
    for x in xs:
        flat = np.pad(x.reshape(-1), (0, (-size) % n)).reshape(n, -1)
        q, s = _quantize(flat)
        chunks.append(q)
        scales.append(s)
    partial = [sum(chunks[r][i].astype(np.float32) * scales[r]
                   for r in range(n)) for i in range(n)]
    requant = [_quantize(p) for p in partial]
    total = np.concatenate([q.astype(np.float32) * s for q, s in requant])
    return total[:size].reshape(xs[0].shape)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(compressed_rank, 4, tmp_path_factory.mktemp("c4"),
                     SHAPES, 11)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_compressed_allreduce_four_ranks_close_to_exact_sum(four_ranks, i):
    outs = [r[i] for r in four_ranks]
    exact = sum(o["x"].astype(np.float64) for o in outs)
    for o in outs:
        np.testing.assert_allclose(o["exact"], exact, rtol=1e-5, atol=1e-5)
        rel = np.abs(o["got"] - exact).max() / np.abs(exact).max()
        assert rel < REL_BOUND, rel
        assert np.abs(o["got"] - outs[0]["got"]).max() < AGREE


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_compressed_allreduce_four_ranks_equals_numpy_model(four_ranks, i):
    outs = [r[i] for r in four_ranks]
    xs = [o["x"] for o in outs]
    want = _model(xs)
    for o in outs:
        flat = np.pad(o["x"].reshape(-1), (0, (-o["x"].size) % 4)).reshape(
            4, -1)
        q, s = _quantize(flat)
        np.testing.assert_array_equal(o["q"], q)
        assert o["scale"] == pytest.approx(float(s), rel=1e-7)
        np.testing.assert_allclose(o["got"], want, rtol=0, atol=MODEL_TOL
                                   * np.abs(want).max())


def test_compressed_allreduce_one_rank_is_two_quantizations(tmp_path):
    """On one rank nothing crosses a wire: the result is the input
    quantized, dequantized, quantized again and dequantized."""
    (out,) = run_ranks(compressed_rank, 1, tmp_path, [(257,), (4, 9)], 5)
    for o in out:
        q, s = _quantize(o["x"].reshape(1, -1))
        q2, s2 = _quantize(q.astype(np.float32) * s)
        want = (q2.astype(np.float32) * s2).reshape(o["x"].shape)
        np.testing.assert_allclose(o["got"], want, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(o["exact"], o["x"])


def test_compressed_grad_allreduce_is_the_mean(tmp_path):
    """``make_compressed_grad_allreduce`` over two ranks: each leaf within
    0.02 of its largest magnitude of the exact mean, ranks agreeing."""
    outs = run_ranks(grad_mean_rank, 2, tmp_path, 21)
    for k in ("w", "b"):
        for got, exact in (o[k] for o in outs):
            assert np.abs(got - exact).max() < REL_BOUND * np.abs(
                exact).max()
            assert np.abs(got - outs[0][k][0]).max() < AGREE
