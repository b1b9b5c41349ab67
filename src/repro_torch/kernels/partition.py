"""Wrappers of the partition kernels K1–K3 (``csrc/partition.cu``).

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``
and then dispatches on the device of the tensors it was given: a CPU tensor
takes the plain PyTorch version in ``ref.py``; a CUDA tensor launches the
CUDA kernel on the current stream (and raises if the launch fails). There is
no other route: a CUDA tensor never falls back to the plain version.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reached
the card), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

# H100: 227 KB of shared memory per block (232,448 bytes, opt-in above
# 48 KB). K3 stages the whole padded build side there at 12 bytes a row
# (key, cat, valid as int32), so the largest power-of-two build side it
# takes is 16 Ki rows; the dispatcher sends larger buckets down the
# sorted-search path.
SMEM_PER_BLOCK = 232448
FUSED_ROW_BYTES = 12
FUSED_SMEM_ROWS = 1 << ((SMEM_PER_BLOCK // FUSED_ROW_BYTES).bit_length() - 1)
# K1 keeps one tile's P counters in static-size shared memory (48 KB)
MAX_HIST_PARTITIONS = (48 * 1024) // 4
# K2 keeps a (32 warps x P) count table in shared memory
MAX_SCATTER_PARTITIONS = SMEM_PER_BLOCK // (32 * 4)
SCATTER_TILE = 1024

LAUNCHES = {"partition_histogram": 0, "partition_scatter": 0,
            "fused_probe": 0}
# distinct shapes each kernel was launched at: (rows, partitions) for K1
# and K2, (probe rows, build rows, groups) for K3
SHAPES: dict[str, set] = {k: set() for k in LAUNCHES}
_COUNT_LOCK = threading.Lock()   # invoker threads launch concurrently

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "rt_error_string": ((_I,), ctypes.c_char_p),
    "rt_fused_probe_smem_bytes": ((), _I),
    "rt_partition_histogram": ((_P, _LL, _I, _I, _P, _P), _I),
    "rt_partition_scatter": ((_P, _P, _LL, _I, _I, _P, _P, _P, _P), _I),
    "rt_fused_probe": ((_P, _P, _P, _LL, _P, _P, _P, _I, _I, _P, _P, _P),
                       _I),
}
_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = load("partition.cu")
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(args), res
        assert lib.rt_fused_probe_smem_bytes() == SMEM_PER_BLOCK
        _BOUND = lib
    return _BOUND


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, shape: tuple) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        SHAPES[name].add(shape)


def _check(t, name: str, dtype, ndim: int, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _route(dev: torch.device) -> str:
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda":
        return "cuda"
    raise ValueError(f"no partition kernel for device {dev}")


def _check_ids(part_ids: torch.Tensor, p: int) -> None:
    """Raise unless every id lies in ``[0, P)``: the kernels skip other ids
    while the plain versions raise on negative ones and order the rest, so
    neither route is given one. Costs one reduction and a host sync."""
    if part_ids.numel():
        lo, hi = torch.stack(torch.aminmax(part_ids)).tolist()
        if lo < 0 or hi >= p:
            raise ValueError(f"partition ids must lie in [0, {p}), got "
                             f"[{lo}, {hi}]")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = _lib().rt_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def partition_histogram(part_ids: torch.Tensor, num_partitions: int,
                        check_ids: bool = True) -> torch.Tensor:
    """K1: per-partition row counts, ``(N,)`` int32 ids in ``[0, P)`` ->
    ``(P,)`` int32. A caller that made the ids itself, in range by
    construction, may pass ``check_ids=False`` to skip the range check's
    reduction and host sync.

    The reference kernel returns per-block counts that its dispatcher sums;
    here the kernel adds each tile's counts into the totals itself."""
    _check(part_ids, "part_ids", torch.int32, 1)
    p = int(num_partitions)
    if not 0 < p <= MAX_HIST_PARTITIONS:
        raise ValueError(f"num_partitions must be in [1, "
                         f"{MAX_HIST_PARTITIONS}], got {p}")
    dev = part_ids.device
    route = _route(dev)
    if check_ids:
        _check_ids(part_ids, p)
    if route == "plain":
        return ref.partition_histogram_ref(part_ids, p)
    out = torch.empty((p,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(_lib().rt_partition_histogram, part_ids.data_ptr(),
                part_ids.shape[0], p, 0, out.data_ptr(), _stream(dev))
    _count("partition_histogram", (part_ids.shape[0], p))
    return out


def partition_scatter(rows: torch.Tensor, part_ids: torch.Tensor,
                      num_partitions: int, check_ids: bool = True):
    """K2: stable grouping of ``(N, D)`` rows (any dtype) by ``(N,)`` int32
    partition ids in ``[0, P)`` -> ``(grouped (N, D), offsets (P,) int32)``
    where ``offsets`` is the exclusive prefix of the partition counts.
    ``check_ids`` as for ``partition_histogram``."""
    _check(rows, "rows", None, 2)
    _check(part_ids, "part_ids", torch.int32, 1, rows.device)
    n = rows.shape[0]
    if part_ids.shape[0] != n:
        raise ValueError(f"{n} rows but {part_ids.shape[0]} ids")
    p = int(num_partitions)
    if not 0 < p <= MAX_SCATTER_PARTITIONS:
        raise ValueError(f"num_partitions must be in [1, "
                         f"{MAX_SCATTER_PARTITIONS}], got {p}")
    dev = rows.device
    route = _route(dev)
    if check_ids:
        _check_ids(part_ids, p)
    if route == "plain":
        return ref.partition_scatter_ref(rows, part_ids, p)
    out = torch.empty_like(rows)
    offsets = torch.empty((p,), dtype=torch.int32, device=dev)
    tiles = max(1, -(-n // SCATTER_TILE))
    tile_hist = torch.empty((tiles * p,), dtype=torch.int32, device=dev)
    row_bytes = rows.shape[1] * rows.element_size()
    with torch.cuda.device(dev):
        _launch(_lib().rt_partition_scatter, rows.data_ptr(),
                part_ids.data_ptr(), n, row_bytes, p, out.data_ptr(),
                offsets.data_ptr(), tile_hist.data_ptr(), _stream(dev))
    _count("partition_scatter", (n, p))
    return out, offsets


def fused_probe(probe_keys, v0, v1, build_keys, build_cat, build_valid,
                num_groups: int):
    """K3: fused equality probe of one join bucket.

    ``probe_keys`` int32, ``v0``/``v1`` float32, all ``(N,)``;
    ``build_keys``/``build_cat``/``build_valid`` int32 ``(M,)`` with unique
    valid keys and ``M <= FUSED_SMEM_ROWS``. Returns ``(group, weight)``
    aligned with probe rows: ``cat % G`` and ``v0 * v1`` of the matching
    valid build row, 0 and 0.0 where none matches."""
    _check(probe_keys, "probe_keys", torch.int32, 1)
    dev = probe_keys.device
    for t, name, dt in ((v0, "v0", torch.float32), (v1, "v1", torch.float32),
                        (build_keys, "build_keys", torch.int32),
                        (build_cat, "build_cat", torch.int32),
                        (build_valid, "build_valid", torch.int32)):
        _check(t, name, dt, 1, dev)
    n, m = probe_keys.shape[0], build_keys.shape[0]
    if v0.shape[0] != n or v1.shape[0] != n:
        raise ValueError("probe columns differ in length")
    if build_cat.shape[0] != m or build_valid.shape[0] != m:
        raise ValueError("build columns differ in length")
    g = int(num_groups)
    if g <= 0:
        raise ValueError(f"num_groups must be positive, got {g}")
    if _route(dev) == "plain":
        return ref.fused_probe_ref(probe_keys, v0, v1, build_keys, build_cat,
                                   build_valid, g)
    if not 0 < m <= FUSED_SMEM_ROWS:
        raise ValueError(f"build side of {m} rows does not fit shared "
                         f"memory ({FUSED_SMEM_ROWS} rows)")
    # the kernel takes C's %, which is the floor mod of the reference only
    # for non-negative categories
    if bool(((build_cat < 0) & (build_valid != 0)).any()):
        raise ValueError("build_cat must be non-negative")
    grp = torch.empty((n,), dtype=torch.int32, device=dev)
    wgt = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(_lib().rt_fused_probe, probe_keys.data_ptr(), v0.data_ptr(),
                v1.data_ptr(), n, build_keys.data_ptr(), build_cat.data_ptr(),
                build_valid.data_ptr(), m, g, grp.data_ptr(), wgt.data_ptr(),
                _stream(dev))
    _count("fused_probe", (n, m, g))
    return grp, wgt
