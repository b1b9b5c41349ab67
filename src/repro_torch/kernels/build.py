"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` at first use into ``build/repro_torch/`` at the root of the
checkout (named by a hash of the source, every ``csrc/*.cuh`` header beside
it and the flags, so an edited source or header rebuilds) and loaded with
``ctypes``. Nothing is compiled when a module is imported: the machines
that run the CPU tests have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output (``-Xptxas -v``: registers, shared memory, spills) per
# source, kept for whoever wants to print it
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    text = src.read_bytes() + b"".join(
        b"\0%s\0%s" % (p.name.encode(), p.read_bytes())
        for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _start(source: str):
    out = library_path(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(source: str, out: Path, job) -> Path:
    if job is None:
        return out
    proc, tmp = job
    log, _ = proc.communicate()
    BUILD_LOGS[source] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)
    return out


def build_all(sources=None) -> dict[str, Path]:
    """Compile every source (all of ``csrc/*.cu`` by default) with one
    ``nvcc`` each, all started together; returns ``{source: library}``."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    with _LOCK:
        jobs = {s: _start(s) for s in sources}
        return {s: _finish(s, out, job) for s, (out, job) in jobs.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    path = build_all([source])[source]
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = _LIBS[source] = ctypes.CDLL(str(path))
    return lib
