"""Wrappers of the attention kernels K4 (``csrc/flash_attention.cu``), its
gradient K4b (``csrc/flash_attention_bwd.cu``) and K5
(``csrc/decode_attention.cu``).

Each wrapper checks its inputs and then dispatches on the device of the
tensors it was given: a CPU tensor takes the plain PyTorch version in
``ref.py``; a CUDA tensor gets its output from ``torch.empty_like`` and
launches the CUDA kernel on the current stream (and raises if the launch
fails). A CUDA tensor never falls back to the plain version.

Both kernels read their inputs with their strides (the head dimension must
be contiguous), and both read the K kv heads of grouped-query attention in
place, so neither the prefill's projections nor the decode step's
``(B, S, K, hd)`` cache is expanded or copied into another layout first.

K4 and K4b each have two routes in one library, picked by the C entry
point from dtype, head dim and alignment: the tensor cores (bf16, hd 64 or
128, rows on 16 bytes) or the CUDA cores (everything else). A K5 call is
two launches, a split along the sequence and a combine, through a scratch
buffer kept per stream, and counts once.

On CUDA tensors that ask for a gradient, ``flash_attention`` is a
``torch.autograd.Function``: its forward is K4, which then also writes each
query row's log-sum-exp, and its backward K4b, which reads it (three
launches, ``rowsum(dO * O)`` into a per-stream scratch, then dK and dV,
then dQ, counted once). K4b has K4's two routes, picked the same way. On
CPU tensors autograd differentiates the plain version. Nothing falls back:
a K4b build or launch failure raises.

K4 and K4b take ``S_q`` query rows against ``S_k`` keys, the query rows at
positions ``q_offset + i``, so that under the causal mask a rank's block of
a sequence's queries attends to the whole sequence's keys (the sequence-
parallel attention of ``repro_torch.models.attention``). K5 writes each
head's log-sum-exp on request (``return_lse``), by which the outputs of
ranks that each hold a slice of the cache are combined.

``LAUNCHES`` counts wrapper calls that launched their kernel on the card,
so a run can show that its main path went through the kernels; ``SHAPES``
keeps the distinct shapes (for K4 with its route) each was launched at.

``flash_attention_work``, ``flash_attention_bwd_work`` and
``decode_attention_work`` give the work each kernel's function does, the
FLOPs and the bytes it must move: ``chip_smoke.py`` prices each kernel's
bound with them, and a dispatch trace (``kernels.traced``, meta tensors)
counts them in place of a launch.
"""

from __future__ import annotations

import array
import ctypes
import functools
import threading

import torch

from repro_torch.kernels import ref, traced
from repro_torch.kernels.build import load
from repro_torch.kernels.streams import (StreamScratch, current_stream,
                                         on_device)

# head dimensions the kernels are instantiated for (csrc ``launch_hd``)
HEAD_DIMS = (8, 16, 32, 64, 128)
# keys a K5 split CTA takes (``kChunk`` in decode_attention.cu)
DECODE_CHUNK = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "decode_attention": 0}
# (B, S, H, K, hd, dtype, causal, route) for K4 and K4b, with (S_k,
# q_offset) after them where S_k differs from S or q_offset is not 0;
# (B, H, S, K, hd, dtype) for K5, with "lse" after them where it wrote one
SHAPES: dict[str, set] = {k: set() for k in LAUNCHES}
_COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_STRIDES = (_LL,) * 9
# per kernel: source, error-string function, {C function: argument types}
_LIBS = {
    "flash_attention": ("flash_attention.cu", "fa_error_string", {
        "fa_flash_attention": (_P,) * 5 + (_I,) * 7 + _STRIDES
        + (_I, _I, ctypes.POINTER(_I), _P)}),
    "flash_attention_bwd": ("flash_attention_bwd.cu", "fab_error_string", {
        "fab_flash_attention_bwd": (_P,) * 9 + (_I,) * 7 + _STRIDES
        + (_I, _I, _P, ctypes.POINTER(_I), _P)}),
    "decode_attention": ("decode_attention.cu", "da_error_string", {
        "da_split": (_P,), "da_combine": (_P,), "da_chunk": (),
        "da_num_args": ()}),
}
_BOUND: dict[str, dict] = {}
_BIND_LOCK = threading.Lock()


def _fn(name: str, entry: str):
    """C function ``entry`` of one kernel's library, built and bound on
    first use (``"error"`` is its error-string function)."""
    bound = _BOUND.get(name)
    if bound is not None:
        return bound[entry]
    with _BIND_LOCK:
        if name not in _BOUND:
            source, errs, entries = _LIBS[name]
            lib = load(source)
            bound = {}
            for e, args in entries.items():
                bound[e] = getattr(lib, e)
                bound[e].argtypes, bound[e].restype = list(args), _I
            bound["error"] = getattr(lib, errs)
            bound["error"].argtypes = [_I]
            bound["error"].restype = ctypes.c_char_p
            _BOUND[name] = bound
        return _BOUND[name][entry]


@functools.cache
def _decode_chunk() -> int:
    """Keys per K5 split CTA, as the library defines it."""
    n_args = _fn("decode_attention", "da_num_args")()
    if n_args != _DECODE_ARGS:
        raise RuntimeError(f"decode_attention.cu packs {n_args} arguments, "
                           f"the wrapper {_DECODE_ARGS}")
    chunk = _fn("decode_attention", "da_chunk")()
    if chunk != DECODE_CHUNK:
        raise RuntimeError(f"decode_attention.cu splits {chunk} keys a CTA, "
                           f"the wrapper {DECODE_CHUNK}")
    return chunk


# K5's packed int64 arguments (``enum Arg`` in decode_attention.cu): q, k,
# v, length, part, out, B, S, K, G, hd, n_split, q's two strides, each
# cache's three, dtype, stream, lse
_DECODE_ARGS = 23
_OUT_ARG = 5


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, shape: tuple) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        SHAPES[name].add(shape)


def _route(dev: torch.device) -> str:
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda" or (dev.type == "meta"
                              and traced.TRACER is not None):
        return "cuda"
    raise ValueError(f"no attention kernel for device {dev}")


def _pairs(s: int, s_k: int, causal: bool, q_offset: int) -> float:
    """The (query, key) pairs a call scores: every one, or under the
    causal mask the rows' visible keys, ``s * (q_offset + s / 2)`` (half
    the square at offset 0) and at most ``s * s_k``."""
    return float(s * s_k) if not causal \
        else min(float(s * s_k), s * (q_offset + s / 2))


def flash_attention_work(b: int, s: int, h: int, kh: int, hd: int,
                         elem: int, causal: bool = True,
                         s_k: int | None = None,
                         q_offset: int = 0) -> tuple[float, float]:
    """K4's ``(FLOPs, bytes)``: its two products (``Q K^T`` and ``P V``),
    2 FLOPs a multiply-add, over the pairs it scores (``_pairs``); q and o
    with H heads, k and v with K, each moved once (``elem`` bytes an
    element)."""
    s_k = s if s_k is None else s_k
    return (4.0 * b * h * hd * _pairs(s, s_k, causal, q_offset),
            float((2 * b * s * h + 2 * b * s_k * kh) * hd * elem))


def flash_attention_bwd_work(b: int, s: int, h: int, kh: int, hd: int,
                             elem: int, causal: bool = True,
                             s_k: int | None = None,
                             q_offset: int = 0) -> tuple[float, float]:
    """K4b's ``(FLOPs, bytes)``: its five products (``Q K^T`` recomputed,
    ``dO V^T``, ``P^T dO``, ``dS K``, ``dS^T Q``) over K4's pairs; q, o and
    dO read and dq written with H heads, k and v read and dk, dv written
    with K."""
    s_k = s if s_k is None else s_k
    return (10.0 * b * h * hd * _pairs(s, s_k, causal, q_offset),
            float((4 * b * s * h + 4 * b * s_k * kh) * hd * elem))


def decode_attention_work(b: int, h: int, kh: int, hd: int, elem: int,
                          keys: int) -> tuple[float, float]:
    """K5's ``(FLOPs, bytes)`` for ``keys`` cached positions in all (the
    rows' lengths summed): q read and o written, the lengths, and each
    key's k and v of the K kv heads read once; two products of 2 FLOPs a
    multiply-add per key, head and head dimension."""
    return (4.0 * keys * h * hd,
            float(2 * b * h * hd * elem + 4 * b + 2 * keys * kh * hd * elem))


def _check(t, name: str, ndim: int, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    # one test for the common case; the message is worked out only on failure
    if t.dim() == ndim and t.dtype is dtype and t.device == device and (
            t.stride(-1) == 1 or t.shape[-1] <= 1):
        return
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    raise ValueError(f"{name} must be contiguous in its last dimension")


def _launch(name: str, entry: str, *args) -> None:
    err = _fn(name, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} "
                           f"({_fn(name, 'error')(err).decode()})")


# K5's fp32 scratch (per (b, kv head, chunk, head): the chunk's
# accumulator, max and sum): calls on one stream run in order, so the next
# call's split cannot overwrite it before this call's combine has read it
_SCRATCH = StreamScratch(torch.float32)
# K4b's fp32 scratch (per (b, h, row): delta = rowsum(dO * O)), written by
# its first launch and read by the two after it on the same stream
_BWD_SCRATCH = StreamScratch(torch.float32)


def _check_qkv(q, k, v, q_offset: int = 0) -> None:
    """q ``(B, S_q, H, hd)``, k and v ``(B, S_k, K, hd)`` of q's dtype
    (float32 or bfloat16) on q's device, last dimension contiguous, K
    dividing H, hd in ``HEAD_DIMS``, ``S_k`` at least 1 (where ``S_q`` is)
    and ``q_offset`` a non-negative int."""
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError("q must be a 4-D (B, S, H, hd) tensor")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, 4, q.dtype, q.device)
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if v.shape != k.shape or (k.shape[0], k.shape[3]) != (b, hd) \
            or (s and not k.shape[1]):
        raise ValueError(f"q, k, v shapes do not fit: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


def _shape_key(b, s, h, kh, hd, dtype, causal, route, s_k, q_offset):
    """K4's and K4b's ``SHAPES`` entry (the module docstring's form)."""
    key = (b, s, h, kh, hd, str(dtype), bool(causal), route)
    return key if (s_k, q_offset) == (s, 0) else key + (s_k, q_offset)


class _FlashAttention(torch.autograd.Function):
    """K4 forward, K4b backward, on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = _flash_forward(q, k, v, causal, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, d_out, ctx.causal,
                                         lse, ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """K4: softmax attention of ``(B, S_q, H, hd)`` q over
    ``(B, S_k, K, hd)`` k and v of q's dtype (float32 or bfloat16), H
    divisible by K; query head i attends through kv head i // (H // K),
    the reference's ``jnp.repeat(k, H // K, axis=2)`` order. Scaled by
    ``hd^-0.5``. Causal unless ``causal=False``: query row i sits at
    position ``q_offset + i`` and sees keys ``0 .. q_offset + i``. Any
    ``S_q`` and ``S_k >= 1``; hd in ``HEAD_DIMS``. Returns a contiguous
    ``(B, S_q, H, hd)`` tensor of q's dtype. On the card, with gradients on
    and an input that asks for one, its gradient is K4b's."""
    _check_qkv(q, k, v, q_offset)
    if _route(q.device) == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), q_offset)
    return _flash_forward(q, k, v, causal, q_offset)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             q_offset: int = 0):
    """K4's output and each query row's natural log-sum-exp of its scaled,
    masked scores, ``(B, H, S_q)`` fp32: what K4b reads. No gradient. CPU
    tensors take ``ref.flash_attention_ref`` and
    ``ref.flash_attention_lse_ref``."""
    _check_qkv(q, k, v, q_offset)
    if _route(q.device) == "plain":
        return (ref.flash_attention_ref(q, k, v, causal, q_offset),
                ref.flash_attention_lse_ref(q, k, v, causal, q_offset))
    return _flash_forward(q, k, v, causal, q_offset, with_lse=True)


def _flash_forward(q, k, v, causal, q_offset: int = 0,
                   with_lse: bool = False):
    """K4's launch on checked CUDA inputs: its output, and with
    ``with_lse`` also the rows' log-sum-exp."""
    b, s, h, hd = q.shape
    s_k, kh = k.shape[1], k.shape[2]
    dev = q.device
    if traced.tracing(q):
        def card():
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            return (out, torch.empty((b, h, s), dtype=torch.float32,
                                     device=dev)) if with_lse else out

        def plain():
            out = ref.flash_attention_ref(q, k, v, causal, q_offset)
            return (out, ref.flash_attention_lse_ref(
                q, k, v, causal, q_offset)) if with_lse else out

        return traced.kernel("flash_attention", *flash_attention_work(
            b, s, h, kh, hd, q.element_size(), causal, s_k, q_offset),
            card, plain)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    route = ctypes.c_int()
    with on_device(dev):
        _launch("flash_attention", "fa_flash_attention", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, b, s, s_k, h, kh, hd,
                q_offset, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                _DTYPE_CODES[q.dtype], int(bool(causal)),
                ctypes.byref(route), current_stream(dev))
    _count("flash_attention", _shape_key(b, s, h, kh, hd, q.dtype, causal,
                                         "tc" if route.value else "simt",
                                         s_k, q_offset))
    return (out, lse) if with_lse else out


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes (a copy where needed): K4b
    reads o and d_out 16 bytes a load."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, d_out: torch.Tensor,
                        causal: bool = True, lse: torch.Tensor | None = None,
                        q_offset: int = 0):
    """K4b: the gradient of ``flash_attention(q, k, v, causal, q_offset)``
    whose output was ``out``, against ``d_out``: ``(dq, dk, dv)``,
    contiguous, of q's dtype and q's, k's and v's shapes (dk and dv summed
    over each kv head's query heads). ``lse`` is the rows' log-sum-exp that
    K4 wrote beside ``out`` (``flash_attention_with_lse``), a contiguous
    fp32 ``(B, H, S_q)`` tensor; without it a CUDA call first gets it from
    one K4 launch. CPU tensors take ``ref.flash_attention_bwd_ref`` (which needs
    no ``lse``); CUDA tensors launch K4b or raise. ``out`` and ``d_out``
    may have any strides (autograd hands a broadcast ``d_out`` to a sum's
    input): the kernel reads contiguous copies."""
    _check_qkv(q, k, v, q_offset)
    # the kernel reads both as contiguous (B, S, H, hd) on 16 bytes
    out, d_out = _on_16_bytes(out), _on_16_bytes(d_out)
    for t, name in ((out, "out"), (d_out, "d_out")):
        _check(t, name, 4, q.dtype, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
    b, s, h, hd = q.shape
    if lse is not None:
        _check(lse, "lse", 3, torch.float32, q.device)
        if lse.shape != (b, h, s) or not lse.is_contiguous():
            raise ValueError(f"lse must be a contiguous ({b}, {h}, {s}) "
                             f"tensor, got {tuple(lse.shape)} with strides "
                             f"{lse.stride()}")
    dev = q.device
    if _route(dev) == "plain":
        return ref.flash_attention_bwd_ref(q, k, v, out, d_out, causal,
                                           q_offset)
    if lse is None:
        lse = flash_attention_with_lse(q, k, v, causal, q_offset)[1]
    s_k, kh = k.shape[1], k.shape[2]
    if traced.tracing(q):
        def card():
            traced.scratch("flash_attention_bwd", b * h * s, torch.float32)
            return tuple(torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in (q, k, v))

        return traced.kernel("flash_attention_bwd", *flash_attention_bwd_work(
            b, s, h, kh, hd, q.element_size(), causal, s_k, q_offset),
            card, lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, d_out, causal, q_offset))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return dq, dk, dv
    stream = current_stream(dev)
    route = ctypes.c_int()
    with _BWD_SCRATCH.lock:
        scratch = _BWD_SCRATCH.get(dev, stream, b * h * s)
        with on_device(dev):
            _launch("flash_attention_bwd", "fab_flash_attention_bwd",
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    d_out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b, s, s_k, h, kh, hd,
                    q_offset, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], int(bool(causal)),
                    _DTYPE_CODES[q.dtype], scratch.data_ptr(),
                    ctypes.byref(route), stream)
    _count("flash_attention_bwd", _shape_key(
        b, s, h, kh, hd, q.dtype, causal, "tc" if route.value else "simt",
        s_k, q_offset))
    return dq, dk, dv


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     return_lse: bool = False):
    """K5: one query token per sequence, ``q (B, H, hd)``, against caches
    ``(B, S, K, hd)`` of q's dtype (float32 or bfloat16), masked past the
    int32 ``length (B,)``; H = K * G and query head i attends through kv
    head i // G. ``length`` should lie in ``[0, S]`` (the kernel clamps
    it; it is not checked, which would cost a host sync per call); 0
    gives zeros. Returns a contiguous ``(B, H, hd)`` tensor of q's dtype;
    with ``return_lse`` also each head's natural log-sum-exp of its
    scaled, unmasked scores, ``(B, H)`` fp32 (``-inf`` at length 0)."""
    if not isinstance(q, torch.Tensor) or q.dim() != 3:
        raise ValueError("q must be a 3-D (B, H, hd) tensor")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    dev = q.device
    _check(q, "q", 3, q.dtype, dev)
    _check(k_cache, "k_cache", 4, q.dtype, dev)
    _check(v_cache, "v_cache", 4, q.dtype, dev)
    _check(length, "length", 1, torch.int32, dev)
    b, h, hd = q.shape
    _, s, kh, _ = k_cache.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if length.shape[0] != b:
        raise ValueError(f"length has {length.shape[0]} rows, q has {b}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if _route(dev) == "plain":
        return ref.decode_attention_ref(q, k_cache, v_cache, length,
                                        return_lse)
    if traced.tracing(q):
        # the lengths are data: the trace counts every cached position
        def card():
            n_split = max(1, -(-s // DECODE_CHUNK))
            traced.scratch("decode_attention",
                           b * kh * n_split * (h // max(kh, 1)) * (hd + 2),
                           torch.float32)
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            return (out, torch.empty((b, h), dtype=torch.float32,
                                     device=dev)) if return_lse else out

        return traced.kernel("decode_attention", *decode_attention_work(
            b, h, kh, hd, q.element_size(), b * s), card,
            lambda: ref.decode_attention_ref(q, k_cache, v_cache, length,
                                             return_lse))
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    if b * h == 0:
        out = torch.empty((b, h, hd), dtype=q.dtype, device=dev)
        return (out, lse) if return_lse else out
    g = h // kh
    n_split = max(1, -(-s // _decode_chunk()))
    stream = current_stream(dev)
    part = _SCRATCH.get(dev, stream, b * kh * n_split * g * (hd + 2))
    args = array.array("q", (
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), part.data_ptr(), 0, b, s, kh, g, hd, n_split,
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], _DTYPE_CODES[q.dtype], stream,
        lse.data_ptr() if return_lse else 0))
    with on_device(dev):
        _launch("decode_attention", "da_split", args.buffer_info()[0])
        # allocated while the split runs
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        args[_OUT_ARG] = out.data_ptr()
        _launch("decode_attention", "da_combine", args.buffer_info()[0])
    key = (b, h, s, kh, hd, str(q.dtype))
    _count("decode_attention", key + ("lse",) if return_lse else key)
    return (out, lse) if return_lse else out
