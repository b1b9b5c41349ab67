"""Wrappers of the partition kernels K1–K3 (``csrc/partition.cu``).

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``
and then dispatches on the device of the tensors it was given: a CPU tensor
takes the plain PyTorch version in ``ref.py``; a CUDA tensor launches the
CUDA kernel on the current stream (and raises if the launch fails). There is
no other route: a CUDA tensor never falls back to the plain version.

``LAUNCHES`` counts wrapper calls that reached the card (one per call, however
many kernels the call launches), so a run can show that its main path went
through the kernels.

K1 is one launch and K2 two (K1 counting per tile and scanning the counts
into each tile's bases, then a one-sweep scatter). Their C entry points
size themselves (bins, tile, unit, grid) from the shapes, the addresses and
the card. Both keep scratch per (device, stream) (``streams.StreamScratch``):
K1's accumulator and ticket, which the kernels leave at zero for the next
call, so no call clears anything, and K2's per-tile and per-chunk bases,
which each call writes in full and whose size K2's entry point asks for.
K3 is one launch and keeps no scratch: each of its CTAs builds a hash table
of the build side in its shared memory.

``histogram_work``, ``scatter_work`` and ``fused_probe_work`` give the
work each kernel's function does (no arithmetic to speak of: the bytes it
must move); ``chip_smoke.py`` prices each kernel's bound with them, and a
dispatch trace (``kernels.traced``, meta tensors) counts them in place of a
launch, skipping the range check, which reads the ids.
"""

from __future__ import annotations

import array
import ctypes
import threading

import torch

from repro_torch.kernels import ref, traced
from repro_torch.kernels.build import load
from repro_torch.kernels.streams import (StreamScratch, current_stream,
                                         on_device)

# H100: 227 KB of shared memory per block (232,448 bytes, opt-in above
# 48 KB). K3 builds a hash table of the whole build side there at 12 bytes
# a row at the least (key and cat, 8 bytes, and two 2-byte slots; more slots
# where they fit), so the largest power-of-two build side it takes is 16 Ki
# rows; the dispatcher sends larger buckets down the sorted-search path.
SMEM_PER_BLOCK = 232448
FUSED_ROW_BYTES = 12
FUSED_SMEM_ROWS = 1 << ((SMEM_PER_BLOCK // FUSED_ROW_BYTES).bit_length() - 1)
# K3's table has 2^b slots (2M <= 2^b <= 2^16) and puts a key in slot
# ``(uint32(key) * FUSED_HASH_MULT mod 2^32) >> (32 - b)`` (then linear
# probing); the card tests build keys that collide under it
FUSED_HASH_MULT = 0x9E3779B1
# the partition counts K1 and K2 take (their contracts since the first
# port: one 48 KB histogram, and a 32-warp count table in 227 KB)
MAX_HIST_PARTITIONS = (48 * 1024) // 4
MAX_SCATTER_PARTITIONS = SMEM_PER_BLOCK // (32 * 4)

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
    "rt_fused_probe_hash_mult": ((), ctypes.c_uint),
    "rt_hist_num_args": ((), _I),
    "rt_scatter_num_args": ((), _I),
    "rt_need_scratch": ((), _I),
    "rt_partition_histogram": ((_P,), _I),
    "rt_partition_scatter": ((_P,), _I),
    "rt_fused_probe": ((_P, _P, _P, _LL, _P, _P, _P, _I, _I, _P, _P, _P),
                       _I),
}
# the packed arguments of K1 and K2 (``enum HistArg`` / ``enum ScatterArg``
# in partition.cu)
_HIST_ARGS = ("ids", "n", "p", "out", "acc", "ticket", "stream")
_SCATTER_ARGS = ("rows", "ids", "n", "row_bytes", "p", "out", "offsets",
                 "acc", "ticket", "scratch", "scratch_words", "stream")
_SCRATCH_ARG = _SCATTER_ARGS.index("scratch")
_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = load("partition.cu")
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(args), res
        assert lib.rt_fused_probe_smem_bytes() == SMEM_PER_BLOCK
        assert lib.rt_fused_probe_hash_mult() == FUSED_HASH_MULT
        assert lib.rt_hist_num_args() == len(_HIST_ARGS)
        assert lib.rt_scatter_num_args() == len(_SCATTER_ARGS)
        _BOUND = lib
    return _BOUND


# K1's accumulator (``MAX_HIST_PARTITIONS`` counters) and ticket, at zero
# between calls; K2 shares them, and keeps its bases in _BASES
_COUNTERS = StreamScratch(torch.int32, zeroed=True)
_BASES = StreamScratch(torch.int32)


def _counters(dev: torch.device, stream: int) -> tuple[int, int]:
    """Addresses of ``stream``'s accumulator and ticket."""
    acc = _COUNTERS.get(dev, stream, MAX_HIST_PARTITIONS + 1).data_ptr()
    return acc, acc + 4 * MAX_HIST_PARTITIONS


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


def histogram_work(n: int, p: int) -> tuple[float, float]:
    """K1's ``(FLOPs, bytes)``: the ids read, the counts written."""
    return 0.0, float(n * 4 + p * 4)


def scatter_work(n: int, p: int, row_bytes: int = 4) -> tuple[float, float]:
    """K2's ``(FLOPs, bytes)``: the rows read and written, the ids read and
    the offsets written."""
    return 0.0, float(2 * n * row_bytes + n * 4 + p * 4)


def fused_probe_work(n: int, m: int) -> tuple[float, float]:
    """K3's ``(FLOPs, bytes)``: the probe side's keys, v0 and v1 and the
    build side's keys, cats and valid flags read once, group and weight
    written (a hash probe needs none of the N x M compares of the TPU
    kernel's one-hot probe)."""
    return 0.0, float(n * 12 + m * 12 + n * 8)


def _counters_scratch() -> None:
    """K1's and K2's accumulator and ticket, under a trace."""
    traced.scratch("partition_counters", MAX_HIST_PARTITIONS + 1, torch.int32)


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


def _error(fn, err: int) -> RuntimeError:
    msg = _lib().rt_error_string(err).decode()
    return RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise _error(fn, err)


def _launch_packed(fn, args: array.array, dev: torch.device,
                   stream: int) -> None:
    """K1 or K2 with its packed arguments, on ``stream``'s scratch."""
    err = fn(args.buffer_info()[0])
    if err != 0 and err == _lib().rt_need_scratch():
        # K2 asked for more bases than the stream keeps: grow them, again
        bases = _BASES.get(dev, stream, args[_SCRATCH_ARG + 1])
        args[_SCRATCH_ARG] = bases.data_ptr()
        err = fn(args.buffer_info()[0])
    if err != 0:
        # the kernels may have stopped half way: start that stream's
        # scratch afresh
        _COUNTERS.drop(dev, stream)
        _BASES.drop(dev, stream)
        raise _error(fn, err)


def partition_histogram(part_ids: torch.Tensor, num_partitions: int,
                        check_ids: bool = True) -> torch.Tensor:
    """K1: per-partition row counts, ``(N,)`` int32 ids in ``[0, P)`` ->
    ``(P,)`` int32. A caller that made the ids itself, in range by
    construction, may pass ``check_ids=False`` to skip the range check's
    reduction and host sync.

    The reference kernel returns per-block counts that its dispatcher sums;
    here one launch returns the totals (its CTAs add into the stream's
    accumulator, and the last one copies it out)."""
    _check(part_ids, "part_ids", torch.int32, 1)
    p = int(num_partitions)
    if not 0 < p <= MAX_HIST_PARTITIONS:
        raise ValueError(f"num_partitions must be in [1, "
                         f"{MAX_HIST_PARTITIONS}], got {p}")
    dev = part_ids.device
    if traced.tracing(part_ids):
        def card():
            _counters_scratch()
            return torch.empty((p,), dtype=torch.int32, device=dev)

        return traced.kernel("partition_histogram",
                             *histogram_work(part_ids.shape[0], p), card)
    route = _route(dev)
    if check_ids:
        _check_ids(part_ids, p)
    if route == "plain":
        return ref.partition_histogram_ref(part_ids, p)
    n = part_ids.shape[0]
    with on_device(dev):
        stream = current_stream(dev)
        out = torch.empty((p,), dtype=torch.int32, device=dev)
        acc, ticket = _counters(dev, stream)
        _launch_packed(_lib().rt_partition_histogram, array.array("q", (
            part_ids.data_ptr(), n, p, out.data_ptr(), acc, ticket, stream)),
            dev, stream)
    _count("partition_histogram", (n, p))
    return out


def partition_scatter(rows: torch.Tensor, part_ids: torch.Tensor,
                      num_partitions: int, check_ids: bool = True):
    """K2: stable grouping of ``(N, D)`` rows (any dtype) by ``(N,)`` int32
    partition ids in ``[0, P)`` -> ``(grouped (N, D), offsets (P,) int32)``
    where ``offsets`` is the exclusive prefix of the partition counts.
    ``check_ids`` as for ``partition_histogram``.

    Two launches: K1 counting the ids of every tile and scanning the
    counts into each tile's bases, then the scatter, a CTA a tile, which
    ranks its rows while the first launch runs."""
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
    if traced.tracing(rows):
        def card():
            _counters_scratch()
            return (torch.empty_like(rows),
                    torch.empty((p,), dtype=torch.int32, device=dev))

        return traced.kernel("partition_scatter", *scatter_work(
            n, p, rows.shape[1] * rows.element_size()), card)
    route = _route(dev)
    if check_ids:
        _check_ids(part_ids, p)
    if route == "plain":
        return ref.partition_scatter_ref(rows, part_ids, p)
    if n >= 1 << 31:
        raise ValueError(f"K2 takes fewer than 2^31 rows, got {n}")
    row_bytes = rows.shape[1] * rows.element_size()
    out = torch.empty_like(rows)
    offsets = torch.empty((p,), dtype=torch.int32, device=dev)
    with on_device(dev):
        stream = current_stream(dev)
        acc, ticket = _counters(dev, stream)
        # held until the launch, so that no call on another thread replaces
        # the bases in between
        with _BASES.lock:
            bases = _BASES.get(dev, stream, 0)
            _launch_packed(_lib().rt_partition_scatter, array.array("q", (
                rows.data_ptr(), part_ids.data_ptr(), n, row_bytes, p,
                out.data_ptr(), offsets.data_ptr(), acc, ticket,
                bases.data_ptr(), bases.numel(), stream)), dev, stream)
    _count("partition_scatter", (n, p))
    return out, offsets


def fused_probe(probe_keys, v0, v1, build_keys, build_cat, build_valid,
                num_groups: int):
    """K3: fused equality probe of one join bucket.

    ``probe_keys`` int32, ``v0``/``v1`` float32, all ``(N,)``;
    ``build_keys``/``build_cat``/``build_valid`` int32 ``(M,)`` with
    ``M <= FUSED_SMEM_ROWS``. Returns ``(group, weight)`` aligned with probe
    rows: the sum of the cats of the valid build rows with the probe's key
    (one row, by the join contract) as a floor mod of G, and ``v0 * v1``
    where a valid row matched; 0 and 0.0 where none did.

    One launch, and no host sync: the kernel builds a hash table of the
    build side in each CTA's shared memory and probes it."""
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
    if m > FUSED_SMEM_ROWS:
        raise ValueError(f"build side of {m} rows does not fit shared "
                         f"memory ({FUSED_SMEM_ROWS} rows)")
    g = int(num_groups)
    if g <= 0:
        raise ValueError(f"num_groups must be positive, got {g}")
    if traced.tracing(probe_keys):
        return traced.kernel(
            "fused_probe", *fused_probe_work(n, m),
            lambda: (torch.empty((n,), dtype=torch.int32, device=dev),
                     torch.empty((n,), dtype=torch.float32, device=dev)),
            lambda: ref.fused_probe_ref(probe_keys, v0, v1, build_keys,
                                        build_cat, build_valid, g))
    if _route(dev) == "plain":
        return ref.fused_probe_ref(probe_keys, v0, v1, build_keys, build_cat,
                                   build_valid, g)
    grp = torch.empty((n,), dtype=torch.int32, device=dev)
    wgt = torch.empty((n,), dtype=torch.float32, device=dev)
    with on_device(dev):
        _launch(_lib().rt_fused_probe, probe_keys.data_ptr(), v0.data_ptr(),
                v1.data_ptr(), n, build_keys.data_ptr(), build_cat.data_ptr(),
                build_valid.data_ptr(), m, g, grp.data_ptr(), wgt.data_ptr(),
                current_stream(dev))
    _count("fused_probe", (n, m, g))
    return grp, wgt
