"""Pluggable storage backends for the ephemeral shuffle store.

The store's byte-accounting and lifecycle logic is medium-agnostic; this
package supplies the media. The interface is lithops-style — a flat
key/value bytes API (``put``/``get``/``delete``/``list``) — plus an
object-level convenience layer (``put_table``/``get_table``) so the
memory backend can keep today's zero-copy behavior while disk and the
emulated object store round-trip through real serialization.

Three implementations:

- ``MemoryBackend`` — host RAM, zero-copy object storage (the seed
  behavior; a ``Table`` put is the same object on get).
- ``DiskBackend`` — real files under a tempdir, numpy column
  serialization. Local-SSD spill: cheaper than recompute, no emulated
  latency (the file IO is real).
- ``ObjectStoreBackend`` — an emulated S3/GCS tier: in-memory bytes with
  a configurable first-byte latency, bandwidth, and per-request +
  per-GB dollar cost, billed into per-app cost accounting the same way
  the worker pool bills function-seconds.

Each backend exposes ``spec()`` — tier name, ordering (colder = higher),
bandwidths, latency, and cost knobs — which is exactly what the tiering
decision node consumes to price spill-vs-evict-vs-recompute, on the
runtime and the simulator alike.
"""

from __future__ import annotations

import hashlib
import io
import pickle
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np

_NPZ_MAGIC = b"RNPZ"
_PKL_MAGIC = b"RPKL"


def serialize_table(table) -> bytes:
    """Encode a table as bytes: numpy columns via ``np.savez`` when the
    object is columnar (``Table``/``TableSlice``), pickle otherwise (the
    duck-typed fakes the property suites use)."""
    mat = getattr(table, "materialize", None)
    if callable(mat):
        table = mat()
    cols = getattr(table, "columns", None)
    if isinstance(cols, dict):
        buf = io.BytesIO()
        from repro_torch.analytics.table import to_numpy
        np.savez(buf, **{k: to_numpy(v) for k, v in cols.items()})
        return _NPZ_MAGIC + buf.getvalue()
    return _PKL_MAGIC + pickle.dumps(table)


def deserialize_table(data: bytes):
    magic, payload = data[:4], data[4:]
    if magic == _NPZ_MAGIC:
        from repro_torch.analytics.table import Table
        with np.load(io.BytesIO(payload)) as z:
            return Table({k: z[k] for k in z.files})
    if magic == _PKL_MAGIC:
        return pickle.loads(payload)
    raise ValueError(f"unknown serialization magic {magic!r}")


class StorageBackend:
    """Flat key/value bytes store (lithops ``Storage`` shape).

    ``tier`` names the backend; ``order`` ranks temperature (0 = hottest).
    ``io_seconds``/``request_cost`` price an *emulated* medium — real media
    (memory, local disk) return 0 and let wall-clock speak for itself. The
    shuffle store sleeps emulated seconds outside its lock and bills
    dollars into per-app cost accounting.
    """

    tier = "backend"
    order = 0
    zero_copy = False

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        """Return the stored bytes; raises ``KeyError`` if absent."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove a key; missing keys are a no-op (idempotent teardown)."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    # -- object-level layer (the store speaks tables, not bytes) ----------

    def put_table(self, key: str, table) -> int:
        data = serialize_table(table)
        self.put(key, data)
        return len(data)

    def get_table(self, key: str):
        return deserialize_table(self.get(key))

    # -- pricing ----------------------------------------------------------

    def spec(self) -> dict:
        return {"tier": self.tier, "order": self.order,
                "read_bw": None, "write_bw": None, "latency_s": 0.0,
                "cost_per_request": 0.0, "cost_per_gb": 0.0}

    def io_seconds(self, nbytes: int, op: str = "get") -> float:
        """Emulated seconds one ``op`` of ``nbytes`` takes (0 for real
        media — their IO cost is actual wall time)."""
        return 0.0

    def request_cost(self, nbytes: int) -> float:
        """Dollars one request of ``nbytes`` costs (0 for free media)."""
        return 0.0

    def close(self) -> None:
        """Release held resources (tempdirs, buffers)."""


class MemoryBackend(StorageBackend):
    """Host-RAM tier: ``put_table`` keeps the object itself, so a read
    returns the very slice the writer published — the zero-copy seed
    behavior of the shuffle path."""

    tier = "memory"
    order = 0
    zero_copy = True

    def __init__(self):
        self._data: dict[str, object] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = data

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def put_table(self, key: str, table) -> int:
        with self._lock:
            self._data[key] = table
        return int(getattr(table, "nbytes", 0))

    def get_table(self, key: str):
        with self._lock:
            v = self._data[key]
        return deserialize_table(v) if isinstance(v, bytes) else v

    def spec(self) -> dict:
        return {"tier": self.tier, "order": self.order,
                "read_bw": None, "write_bw": None, "latency_s": 0.0,
                "cost_per_request": 0.0, "cost_per_gb": 0.0}


class DiskBackend(StorageBackend):
    """Local-disk spill tier: real files in a tempdir. The advertised
    bandwidths exist only for the tiering decision's cost model — actual
    reads/writes cost whatever the filesystem costs."""

    tier = "disk"
    order = 1

    def __init__(self, root: str | Path | None = None,
                 read_bw: float = 500e6, write_bw: float = 500e6):
        self._own_root = root is None
        self.root = Path(root) if root is not None \
            else Path(tempfile.mkdtemp(prefix="repro-spill-"))
        self.root.mkdir(parents=True, exist_ok=True)
        self.read_bw = read_bw
        self.write_bw = write_bw
        self._paths: dict[str, Path] = {}
        self._lock = threading.Lock()

    def _path(self, key: str) -> Path:
        digest = hashlib.sha1(key.encode()).hexdigest()[:24]
        return self.root / f"{digest}.bin"

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        path.write_bytes(data)
        with self._lock:
            self._paths[key] = path

    def get(self, key: str) -> bytes:
        with self._lock:
            path = self._paths[key]     # KeyError if absent
        return path.read_bytes()

    def delete(self, key: str) -> None:
        with self._lock:
            path = self._paths.pop(key, None)
        if path is not None:
            path.unlink(missing_ok=True)

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._paths if k.startswith(prefix))

    def spec(self) -> dict:
        return {"tier": self.tier, "order": self.order,
                "read_bw": self.read_bw, "write_bw": self.write_bw,
                "latency_s": 1e-4, "cost_per_request": 0.0,
                "cost_per_gb": 0.0}

    def close(self) -> None:
        with self._lock:
            self._paths.clear()
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)


class ObjectStoreBackend(StorageBackend):
    """Emulated S3-style tier: durable-ish in-memory bytes behind a
    latency + bandwidth + dollars cost model. Defaults are S3-ish
    (10 ms first byte, 100 MB/s per stream, $4e-7/request + $0.01/GB
    moved); tests pass zeros to keep runs instantaneous."""

    tier = "object"
    order = 2

    def __init__(self, latency_s: float = 0.01, bw: float | None = 100e6,
                 cost_per_request: float = 4e-7,
                 cost_per_gb: float = 0.01):
        self.latency_s = latency_s
        self.bw = bw
        self.cost_per_request = cost_per_request
        self.cost_per_gb = cost_per_gb
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = data

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def spec(self) -> dict:
        return {"tier": self.tier, "order": self.order,
                "read_bw": self.bw, "write_bw": self.bw,
                "latency_s": self.latency_s,
                "cost_per_request": self.cost_per_request,
                "cost_per_gb": self.cost_per_gb}

    def io_seconds(self, nbytes: int, op: str = "get") -> float:
        s = self.latency_s
        if self.bw:
            s += nbytes / self.bw
        return s

    def request_cost(self, nbytes: int) -> float:
        return self.cost_per_request + nbytes * self.cost_per_gb / 1e9

    def close(self) -> None:
        with self._lock:
            self._data.clear()


_BUILTIN = {"memory": MemoryBackend, "disk": DiskBackend,
            "object": ObjectStoreBackend}


def make_backend(spec) -> StorageBackend:
    """Resolve a backend: an instance passes through, a name constructs
    the builtin with defaults."""
    if isinstance(spec, StorageBackend):
        return spec
    try:
        return _BUILTIN[spec]()
    except KeyError:
        raise ValueError(
            f"unknown storage backend {spec!r} "
            f"(expected one of {sorted(_BUILTIN)})") from None


__all__ = ["StorageBackend", "MemoryBackend", "DiskBackend",
           "ObjectStoreBackend", "make_backend", "serialize_table",
           "deserialize_table"]
