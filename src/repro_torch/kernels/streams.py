"""Streams and per-stream scratch shared by the kernel wrappers.

A kernel whose call needs device memory beyond its inputs and outputs (K1's
and K2's counters and tile bases, K5's partial results) keeps it in a
``StreamScratch``: one buffer per (device, stream), grown on demand. Calls
on one stream run in order, so each call finds the buffer as the previous
call on that stream left it, and two streams never share one.
"""

from __future__ import annotations

import contextlib
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
