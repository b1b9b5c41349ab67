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

``LAUNCHES`` counts wrapper calls that launched their kernel on the card,
so a run can show that its main path went through the kernels; ``SHAPES``
keeps the distinct shapes (for K4 with its route) each was launched at.
"""

from __future__ import annotations

import array
import ctypes
import functools
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load
from repro_torch.kernels.streams import (StreamScratch, current_stream,
                                         on_device)

# head dimensions the kernels are instantiated for (csrc ``launch_hd``)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "decode_attention": 0}
# (B, S, H, K, hd, dtype, causal, route) for K4 and K4b; (B, H, S, K, hd,
# dtype) for K5
SHAPES: dict[str, set] = {k: set() for k in LAUNCHES}
_COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_STRIDES = (_LL,) * 9
# per kernel: source, error-string function, {C function: argument types}
_LIBS = {
    "flash_attention": ("flash_attention.cu", "fa_error_string", {
        "fa_flash_attention": (_P,) * 5 + (_I,) * 5 + _STRIDES
        + (_I, _I, ctypes.POINTER(_I), _P)}),
    "flash_attention_bwd": ("flash_attention_bwd.cu", "fab_error_string", {
        "fab_flash_attention_bwd": (_P,) * 9 + (_I,) * 5 + _STRIDES
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
    return _fn("decode_attention", "da_chunk")()


# K5's packed int64 arguments (``enum Arg`` in decode_attention.cu): q, k,
# v, length, part, out, B, S, K, G, hd, n_split, q's two strides, each
# cache's three, dtype, stream
_DECODE_ARGS = 22
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
    if dev.type == "cuda":
        return "cuda"
    raise ValueError(f"no attention kernel for device {dev}")


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


def _check_qkv(q, k, v) -> None:
    """q ``(B, S, H, hd)``, k and v ``(B, S, K, hd)`` of q's dtype (float32
    or bfloat16) on q's device, last dimension contiguous, K dividing H,
    hd in ``HEAD_DIMS``."""
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError("q must be a 4-D (B, S, H, hd) tensor")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, 4, q.dtype, q.device)
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if v.shape != k.shape or (k.shape[0], k.shape[1], k.shape[3]) \
            != (b, s, hd):
        raise ValueError(f"q, k, v shapes do not fit: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


class _FlashAttention(torch.autograd.Function):
    """K4 forward, K4b backward, on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, d_out, ctx.causal,
                                         lse)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """K4: softmax attention of ``(B, S, H, hd)`` q over ``(B, S, K, hd)``
    k and v of q's dtype (float32 or bfloat16), H divisible by K; query
    head i attends through kv head i // (H // K), the reference's
    ``jnp.repeat(k, H // K, axis=2)`` order. Scaled by ``hd^-0.5``, causal
    unless ``causal=False``. Any S; hd in ``HEAD_DIMS``. Returns a
    contiguous ``(B, S, H, hd)`` tensor of q's dtype. On the card, with
    gradients on and an input that asks for one, its gradient is K4b's."""
    _check_qkv(q, k, v)
    if _route(q.device) == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal))
    return _flash_forward(q, k, v, causal)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True):
    """K4's output and each query row's natural log-sum-exp of its scaled,
    masked scores, ``(B, H, S)`` fp32: what K4b reads. No gradient. CPU
    tensors take ``ref.flash_attention_ref`` and
    ``ref.flash_attention_lse_ref``."""
    _check_qkv(q, k, v)
    if _route(q.device) == "plain":
        return (ref.flash_attention_ref(q, k, v, causal=causal),
                ref.flash_attention_lse_ref(q, k, v, causal=causal))
    return _flash_forward(q, k, v, causal, with_lse=True)


def _flash_forward(q, k, v, causal, with_lse: bool = False):
    """K4's launch on checked CUDA inputs: its output, and with
    ``with_lse`` also the rows' log-sum-exp."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    dev = q.device
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    route = ctypes.c_int()
    with on_device(dev):
        _launch("flash_attention", "fa_flash_attention", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, b, s, h, kh, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                _DTYPE_CODES[q.dtype], int(bool(causal)),
                ctypes.byref(route), current_stream(dev))
    _count("flash_attention", (b, s, h, kh, hd, str(q.dtype), bool(causal),
                               "tc" if route.value else "simt"))
    return (out, lse) if with_lse else out


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes (a copy where needed): K4b
    reads o and d_out 16 bytes a load."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, d_out: torch.Tensor,
                        causal: bool = True, lse: torch.Tensor | None = None):
    """K4b: the gradient of ``flash_attention(q, k, v, causal)`` whose
    output was ``out``, against ``d_out``: ``(dq, dk, dv)``, contiguous,
    of q's dtype and q's, k's and v's shapes (dk and dv summed over each kv
    head's query heads). ``lse`` is the rows' log-sum-exp that K4 wrote
    beside ``out`` (``flash_attention_with_lse``), a contiguous fp32
    ``(B, H, S)`` tensor; without it a CUDA call first gets it from one K4
    launch. CPU tensors take ``ref.flash_attention_bwd_ref`` (which needs
    no ``lse``); CUDA tensors launch K4b or raise. ``out`` and ``d_out``
    may have any strides (autograd hands a broadcast ``d_out`` to a sum's
    input): the kernel reads contiguous copies."""
    _check_qkv(q, k, v)
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
        return ref.flash_attention_bwd_ref(q, k, v, out, d_out, causal)
    if lse is None:
        lse = flash_attention_with_lse(q, k, v, causal)[1]
    kh = k.shape[2]
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
                    dk.data_ptr(), dv.data_ptr(), b, s, h, kh, hd,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    int(bool(causal)), _DTYPE_CODES[q.dtype],
                    scratch.data_ptr(), ctypes.byref(route), stream)
    _count("flash_attention_bwd", (b, s, h, kh, hd, str(q.dtype),
                                   bool(causal),
                                   "tc" if route.value else "simt"))
    return dq, dk, dv


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """K5: one query token per sequence, ``q (B, H, hd)``, against caches
    ``(B, S, K, hd)`` of q's dtype (float32 or bfloat16), masked past the
    int32 ``length (B,)``; H = K * G and query head i attends through kv
    head i // G. ``length`` should lie in ``[0, S]`` (the kernel clamps
    it; it is not checked, which would cost a host sync per call); 0
    gives zeros. Returns a contiguous ``(B, H, hd)`` tensor of q's
    dtype."""
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
        return ref.decode_attention_ref(q, k_cache, v_cache, length)
    if b * h == 0:
        return torch.empty((b, h, hd), dtype=q.dtype, device=dev)
    g = h // kh
    n_split = max(1, -(-s // _decode_chunk()))
    stream = current_stream(dev)
    part = _SCRATCH.get(dev, stream, b * kh * n_split * g * (hd + 2))
    args = array.array("q", (
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), part.data_ptr(), 0, b, s, kh, g, hd, n_split,
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], _DTYPE_CODES[q.dtype], stream))
    with on_device(dev):
        _launch("decode_attention", "da_split", args.buffer_info()[0])
        # allocated while the split runs
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        args[_OUT_ARG] = out.data_ptr()
        _launch("decode_attention", "da_combine", args.buffer_info()[0])
    _count("decode_attention", (b, h, s, kh, hd, str(q.dtype)))
    return out
