"""Streams and per-stream scratch shared by the kernel wrappers.

A kernel whose call needs device memory beyond its inputs and outputs (K1's
and K2's counters and tile bases, K5's partial results) keeps it in a
``StreamScratch``: one buffer per (device, stream), grown on demand. Calls
on one stream run in order, so each call finds the buffer as the previous
call on that stream left it, and two streams never share one.

``StreamPool`` lends out streams made outside PyTorch's pool of 32 (by
the CUDA runtime PyTorch loaded, through ``ctypes``), for callers that
need more distinct streams at once than that pool has: the threads
invoker's workers.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch


def current_stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current stream (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building a
    Stream object on every call)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(dev: torch.device):
    """The context a launch on ``dev`` runs in: switch the current device
    only when it is another card."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


class StreamScratch:
    """A buffer of ``dtype`` per (device, stream), made with ``torch.zeros``
    if ``zeroed`` (for kernels that leave it at zero for the next call) and
    with ``torch.empty`` otherwise. A caller whose threads may share a
    stream holds ``lock`` from ``get`` to the launch that uses the buffer,
    so that no other call replaces it in between."""

    def __init__(self, dtype: torch.dtype, zeroed: bool = False):
        self.dtype = dtype
        self.zeroed = zeroed
        self.lock = threading.RLock()
        self._bufs: dict[tuple[torch.device, int], torch.Tensor] = {}

    def get(self, dev: torch.device, stream: int, numel: int) -> torch.Tensor:
        """At least ``numel`` elements for ``stream`` on ``dev``: the kept
        buffer, or a larger one that replaces it."""
        key = (dev, stream)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < numel:
            with self.lock:
                buf = self._bufs.get(key)
                if buf is None or buf.numel() < numel:
                    make = torch.zeros if self.zeroed else torch.empty
                    buf = self._bufs[key] = make((numel,), dtype=self.dtype,
                                                 device=dev)
        return buf

    def drop(self, dev: torch.device, stream: int) -> None:
        """Forget ``stream``'s buffer (after a call that may have stopped
        half way), so the next call starts afresh."""
        with self.lock:
            self._bufs.pop((dev, stream), None)

    def keys(self) -> list[tuple[torch.device, int]]:
        with self.lock:
            return list(self._bufs)


# cudaStreamNonBlocking: the stream never waits on the legacy default
# stream (PyTorch's pooled streams do not either)
_NON_BLOCKING = 1
_CUDART = None


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime library PyTorch has loaded, found in the process's
    memory map, so that the streams are made by the runtime PyTorch itself
    calls (a PyTorch that links the runtime statically has none to find)."""
    global _CUDART
    if _CUDART is None:
        torch.cuda.init()
        with open("/proc/self/maps") as maps:
            paths = sorted({line.split()[-1] for line in maps
                            if "/libcudart.so" in line})
        if not paths:
            raise RuntimeError("no shared CUDA runtime (libcudart.so) is "
                               "loaded in this process")
        lib = ctypes.CDLL(paths[0])
        lib.cudaGetErrorString.restype = ctypes.c_char_p
        _CUDART = lib
    return _CUDART


def create_stream(index: int) -> int:
    """A new non-blocking stream on device ``index``
    (``cudaStreamCreateWithFlags``); returns its raw handle."""
    lib = _cudart()
    stream = ctypes.c_void_p()
    with torch.cuda.device(index):
        err = lib.cudaStreamCreateWithFlags(ctypes.byref(stream),
                                            _NON_BLOCKING)
    if err != 0:
        raise RuntimeError(f"cudaStreamCreateWithFlags failed: CUDA error "
                           f"{err} ({lib.cudaGetErrorString(err).decode()})")
    return stream.value


class StreamPool:
    """Streams made outside PyTorch's pool (``create_stream``), each lent
    to one borrower at a time: ``take`` hands out a free stream of the
    device, or makes a new one when none is free, and ``give`` returns it.
    So as many callers as run at once hold as many distinct streams,
    however many that is (PyTorch's pool has 32 a priority and hands them
    out round robin).

    The streams are never destroyed: the caching allocator keys every block
    allocated on a stream to it, and records events on the streams a tensor
    was used on when the tensor is freed, which may be long after the
    borrower is gone. So one pool serves the whole process, as PyTorch's
    does."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[int, list] = {}

    def take(self, dev: torch.device) -> torch.cuda.ExternalStream:
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        with self._lock:
            free = self._free.setdefault(index, [])
            if free:
                return free.pop()
        return torch.cuda.ExternalStream(create_stream(index),
                                         device=torch.device("cuda", index))

    def give(self, stream: torch.cuda.ExternalStream) -> None:
        with self._lock:
            self._free.setdefault(stream.device.index, []).append(stream)


# the threads invoker's workers borrow their streams here
WORKER_STREAMS = StreamPool()
