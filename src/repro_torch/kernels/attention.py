"""Wrappers of the attention kernels K4 (``csrc/flash_attention.cu``) and K5
(``csrc/decode_attention.cu``).

Each wrapper checks its inputs, allocates its output with ``torch.empty``
and then dispatches on the device of the tensors it was given: a CPU tensor
takes the plain PyTorch version in ``ref.py``; a CUDA tensor launches the
CUDA kernel on the current stream (and raises if the launch fails). A CUDA
tensor never falls back to the plain version.

Both kernels read their inputs with their strides (the head dimension must
be contiguous), so neither the prefill's projections nor the decode step's
``(B, S, K, hd)`` cache is copied into another layout first.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reached
the card), so a run can show that its main path went through the kernels;
``SHAPES`` keeps the distinct shapes each was launched at.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

# head dimensions the kernels are instantiated for (csrc ``launch_hd``)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0, "decode_attention": 0}
# (B, S, H, hd, dtype, causal) for K4; (B, H, S, K, hd, dtype) for K5
SHAPES: dict[str, set] = {k: set() for k in LAUNCHES}
_COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_LIBS = {
    "flash_attention": ("flash_attention.cu", "fa_flash_attention",
                        "fa_error_string",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
                         _LL, _LL, _LL, _LL, _LL, _I, _I, _P)),
    "decode_attention": ("decode_attention.cu", "da_decode_attention",
                         "da_error_string",
                         (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL,
                          _LL, _LL, _LL, _LL, _LL, _LL, _I, _P)),
}
_BOUND: dict[str, tuple] = {}
_BIND_LOCK = threading.Lock()


def _fn(name: str):
    """``(kernel entry, error-string function)`` of one kernel's library,
    built and bound on first use."""
    with _BIND_LOCK:
        if name not in _BOUND:
            source, entry, errs, args = _LIBS[name]
            lib = load(source)
            fn, err = getattr(lib, entry), getattr(lib, errs)
            fn.argtypes, fn.restype = list(args), _I
            err.argtypes, err.restype = [_I], ctypes.c_char_p
            _BOUND[name] = (fn, err)
        return _BOUND[name]


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
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")


def _launch(name: str, *args) -> None:
    fn, err_string = _fn(name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} "
                           f"({err_string(err).decode()})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """K4: softmax attention over ``(B, S, H, hd)`` q, k, v of one dtype
    (float32 or bfloat16; KV already expanded to the H query heads), scaled
    by ``hd^-0.5``, causal unless ``causal=False``. Any S; hd in
    ``HEAD_DIMS``. Returns a contiguous ``(B, S, H, hd)`` tensor of q's
    dtype."""
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError("q must be a 4-D (B, S, H, hd) tensor")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, 4, q.dtype, q.device)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    dev = q.device
    if _route(dev) == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, s, h, hd, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], _DTYPE_CODES[q.dtype],
                int(bool(causal)), _stream(dev))
    _count("flash_attention", (b, s, h, hd, str(q.dtype), bool(causal)))
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """K5: one query token per sequence, ``q (B, H, hd)``, against caches
    ``(B, S, K, hd)`` of q's dtype (float32 or bfloat16), masked past the
    int32 ``length (B,)``; H = K * G and query head i attends through kv
    head i // G. ``length`` must lie in ``[1, S]`` (the kernel clamps it
    to ``[0, S]``; it is not checked, which would cost a host sync per
    call). Returns a contiguous ``(B, H, hd)`` tensor of q's dtype."""
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
    out = torch.empty((b, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
                v_cache.data_ptr(), length.data_ptr(), out.data_ptr(), b, s,
                kh, h // kh, hd, q.stride(0), q.stride(1),
                *k_cache.stride()[:3], *v_cache.stride()[:3],
                _DTYPE_CODES[q.dtype], _stream(dev))
    _count("decode_attention", (b, h, s, kh, hd, str(q.dtype)))
    return out
