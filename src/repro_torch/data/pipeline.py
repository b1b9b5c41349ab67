"""Shard-aware token data pipeline (the port of ``repro/data/pipeline.py``).

Sources: deterministic synthetic streams (seeded per (step, shard) so every
data-parallel shard sees a disjoint slice and a restart reproduces the exact
batch sequence) and memmapped token files. A background prefetch thread
keeps ``depth`` batches ready so host-side data work overlaps device
compute. Batches are numpy arrays, drawn with numpy's ``default_rng`` as
the reference draws them, so both packages see bit-equal batches; the
train step moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from repro_torch.core.config import Frontend, ModelConfig, ShapeConfig
from repro_torch.models.lm import AUDIO_FRAME_DIM


@dataclass
class SyntheticSource:
    """Deterministic infinite token stream: batch(step) is a pure function
    of (seed, step, shard), so restarts replay identically."""

    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    shard: int = 0
    num_shards: int = 1

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b = self.shape.global_batch // self.num_shards
        s = self.shape.seq_len
        out: dict = {}
        if self.cfg.frontend == Frontend.VISION_STUB.value:
            n_text = s - self.cfg.stub_patches
            tokens = rng.integers(0, self.cfg.vocab_size, (b, n_text),
                                  dtype=np.int32)
            out["patch_embeds"] = rng.standard_normal(
                (b, self.cfg.stub_patches, self.cfg.d_model)).astype(
                np.float32)
        else:
            tokens = rng.integers(0, self.cfg.vocab_size, (b, s),
                                  dtype=np.int32)
            if self.cfg.frontend == Frontend.AUDIO_STUB.value:
                out["frame_embeds"] = rng.standard_normal(
                    (b, s, AUDIO_FRAME_DIM)).astype(np.float32)
        out["tokens"] = tokens
        out["labels"] = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return out


@dataclass
class MemmapSource:
    """Token file source: flat int32 binary, sliced into (batch, seq) with a
    per-shard stride."""

    path: str
    cfg: ModelConfig
    shape: ShapeConfig
    shard: int = 0
    num_shards: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> dict:
        b = self.shape.global_batch // self.num_shards
        s = self.shape.seq_len
        n = self._data.shape[0]
        per_step = b * (s + 1)
        offset = (step * self.num_shards + self.shard) * per_step % max(
            1, n - per_step)
        window = np.asarray(self._data[offset: offset + per_step])
        window = window.reshape(b, s + 1) % self.cfg.vocab_size
        return {"tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int32)}


class Prefetcher:
    """Runs source.batch(step) ``depth`` steps ahead on a worker thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self.source.batch(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._q.get()

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


def write_token_file(path: str | Path, num_tokens: int, vocab: int,
                     seed: int = 0):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, vocab, num_tokens, dtype=np.int32)
    arr.tofile(path)
    return path
