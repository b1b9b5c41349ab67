"""Fault-tolerant checkpointing: atomic, keep-K, async, in the reference's
layout (the port of ``repro/ckpt/checkpoint.py``).

Layout per step::

    <dir>/step_000000123.tmp/  (written)    -> atomic rename ->
    <dir>/step_000000123/
        manifest.json          step, leaves (shape, dtype), extra, paths
        leaf_00000.npy ...     one file per leaf (whole, unsharded)

Each package reads the other's checkpoints. A port state
(``training.init_train_state``: ``{"params": LM, "opt": {"step",
"master", "m", "v"}}``) is written as the reference's tree of the same
state: the model and every mapping keyed by its parameter names (the
optimizer's ``master``, ``m`` and ``v``) are restacked as
``convert.params_to_numpy`` restacks them (each layer leaf stacked over
the pattern's repeats), and the tree is flattened as ``jax.tree.flatten``
flattens it (dict keys sorted, tuples in order). So leaf ``i`` here is
leaf ``i`` of the reference's checkpoint of the same state. Any other
tree of tensors, numpy arrays and scalars is flattened the same way. The
manifest's ``treedef`` is the leaves' paths (the reference writes a JAX
repr there; neither package reads it).

bfloat16 leaves need no ``ml_dtypes``: they are written as their raw two
bytes with the header the reference's ``np.save`` writes for them
(``'descr': '<V2'``) and ``"bfloat16"`` in the manifest, and read back by
viewing those bits as ``torch.bfloat16``. (The reference reads such a leaf
back as a 2-byte void array, which its jitted step refuses.)

``load_checkpoint(like=state)`` copies every leaf into ``state``'s tensors
in place, on their device. Under sharding rules (``rules``, the current
``use_rules`` context's by default) each rank holds shards: a save gathers
every leaf whole (``convert.gather_named``, a collective: every rank
calls it), rank 0 alone writes, and a barrier over the mesh keeps every
rank from reading the directory before rank 0's rename; a load takes
this rank's shard of each whole leaf (``convert.shard_named``; the
optimizer's leaves take their parameters' axes, as ``opt_state_axes``
says), which is the elastic-rescale path: the rules may be another
mesh's than the save's.
"""

from __future__ import annotations

import json
import queue
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.convert import _restack, gather_named, shard_named
from repro_torch.models.lm import LM
from repro_torch.parallel.sharding import current_rules

_SENTINEL = object()
# the .npy header the reference's ``np.save`` writes for a bfloat16 leaf
BF16_DESCR = "<V2"


@dataclass
class _Leaf:
    """One leaf of the reference's tree: ``values`` holds one value, or
    (``stacked``) the rows of a layer leaf over the pattern's repeats;
    ``names``, the port's parameter name of each (``None`` for a leaf of
    no model)."""

    values: list
    names: list
    stacked: bool = False


@dataclass
class _Tree:
    """A state's leaves in the reference's order, their paths, and the
    model's config where the state holds one."""

    leaves: list = field(default_factory=list)
    paths: list = field(default_factory=list)
    cfg: Any = None


def _model_of(state):
    if isinstance(state, LM):
        return state
    if isinstance(state, dict):
        for v in state.values():
            found = _model_of(v)
            if found is not None:
                return found
    return None


def _reference_tree(state, whole=None) -> _Tree:
    """The leaves of ``state`` in the reference's tree and order.
    ``whole(named)`` maps each mapping keyed by the model's parameter
    names to the values to keep (the whole leaves under a split)."""
    model = _model_of(state)
    cfg = None if model is None else model.cfg
    names = None if model is None else \
        {k for k, _ in model.named_parameters()}
    out = _Tree(cfg=cfg)

    def restacked(named: dict):
        named = dict(named) if whole is None else whole(dict(named))
        return _restack({k: (k, v) for k, v in named.items()}, cfg,
                        lambda kv: _Leaf([kv[1]], [kv[0]]),
                        lambda rows: _Leaf([v for _, v in rows],
                                           [k for k, _ in rows], True))

    def convert(node):
        if isinstance(node, LM):
            return restacked(node.named_parameters())
        if isinstance(node, dict):
            if names is not None and node and set(node) == names:
                return restacked(node)
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(convert(v) for v in node)
        return _Leaf([node], [None])

    def walk(node, path: str):
        if isinstance(node, _Leaf):
            out.leaves.append(node)
            out.paths.append(path)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else str(k))
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}" if path else str(i))

    walk(convert(state), "")
    return out


def _splits(rules) -> bool:
    return rules is not None and rules.mesh is not None \
        and rules.mesh.live


def _writer(rules) -> bool:
    """Whether this process writes: rank 0, or the only one."""
    return not _splits(rules) or dist.get_rank() == 0


def _barrier(rules) -> None:
    if _splits(rules):
        dist.barrier()


def _host(v):
    """A host copy of one value, made now: a tensor's bits are copied off
    its device (or cloned on the CPU) before the caller's next step can
    write it in place."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return np.array(v, copy=True)


def _host_leaves(state, rules=None) -> _Tree:
    """``state``'s leaves in the reference's order, copied to the host
    (under ``rules`` that split them, gathered whole first: a collective,
    every rank calls it)."""
    rules = current_rules() if rules is None else rules

    def whole(named):
        if _splits(rules):
            return gather_named(named, _model_of(state).cfg, rules)
        return named

    tree = _reference_tree(state, whole)
    for leaf in tree.leaves:
        leaf.values = [_host(v) for v in leaf.values]
    return tree


def _numpy(v) -> tuple[np.ndarray, str]:
    """``(array, manifest dtype)``: a bfloat16 tensor as its bits
    (``int16``), named ``"bfloat16"``."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy(), "bfloat16"
        v = v.numpy()
    v = np.asarray(v)
    return v, str(v.dtype)


def _save_leaf(path: Path, leaf: _Leaf) -> dict:
    arrays = [_numpy(v) for v in leaf.values]
    dtype = arrays[0][1]
    arr = np.stack([a for a, _ in arrays]) if leaf.stacked else arrays[0][0]
    if dtype == "bfloat16":
        arr = _contiguous(arr)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
            arr.tofile(f)
    else:
        np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": dtype}


def _write(directory: Path, step: int, tree: _Tree, keep: int,
           extra: dict | None) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:09d}.tmp"
    final = directory / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "treedef": tree.paths,
                "num_leaves": len(tree.leaves), "leaves": [],
                "extra": extra or {}}
    for i, leaf in enumerate(tree.leaves):
        manifest["leaves"].append(_save_leaf(tmp / f"leaf_{i:05d}.npy",
                                             leaf))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomicity point
    _cleanup(directory, keep)
    return final


def save_checkpoint(directory: str | Path, step: int, state: Any,
                    keep: int = 3, extra: dict | None = None,
                    rules=None) -> Path:
    """Synchronous atomic save of ``state`` (a port state or any tree of
    tensors, arrays and scalars) as step ``step``; the ``keep`` newest
    steps stay. Under ``rules`` that split the state over ranks every rank
    calls it (the module docstring)."""
    rules = current_rules() if rules is None else rules
    directory = Path(directory)
    tree = _host_leaves(state, rules)
    final = directory / f"step_{step:09d}"
    if _writer(rules):
        final = _write(directory, step, tree, keep, extra)
    _barrier(rules)
    return final


def _cleanup(directory: Path, keep: int):
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for old in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(old, ignore_errors=True)
    for stale in directory.glob("step_*.tmp"):
        shutil.rmtree(stale, ignore_errors=True)


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    steps = sorted(p.name for p in directory.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    return int(steps[-1].split("_")[1]) if steps else None


def _contiguous(arr: np.ndarray) -> np.ndarray:
    # ``np.ascontiguousarray`` would make a 0-d array 1-d
    return np.require(arr, requirements="C")


def leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf as read from its file, as a CPU tensor of the manifest's
    ``dtype`` (a bfloat16 leaf's bits viewed as ``torch.bfloat16``)."""
    if dtype == "bfloat16":
        return torch.from_numpy(_contiguous(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(_contiguous(arr))


@torch.no_grad()
def _copy_into(target, value: torch.Tensor, what: str) -> None:
    if isinstance(target, torch.Tensor):
        if tuple(target.shape) != tuple(value.shape) \
                or target.dtype != value.dtype:
            raise ValueError(f"{what}: checkpoint holds {value.dtype} "
                             f"{tuple(value.shape)}, the state "
                             f"{target.dtype} {tuple(target.shape)}")
        target.copy_(value)
    elif isinstance(target, np.ndarray):
        if target.shape != tuple(value.shape):
            raise ValueError(f"{what}: checkpoint holds {tuple(value.shape)}"
                             f", the state {target.shape}")
        np.copyto(target, value.numpy())
    else:
        raise TypeError(f"{what}: a {type(target).__name__} leaf cannot be "
                        f"restored in place")


def load_checkpoint(directory: str | Path, step: int | None = None,
                    like: Any = None, rules=None) -> tuple[Any, dict]:
    """Restore ``(state, extra)`` of step ``step`` (the latest by
    default). With ``like`` (a state of the saved structure: tensors and
    numpy arrays), every leaf is copied into ``like``'s tensors in place,
    on their device, and ``like`` is returned; under ``rules`` (the current
    ``use_rules`` context's by default) that split the model, each rank
    takes its shard of every whole leaf. Without ``like``, the leaves are
    returned as ``np.load`` reads them (a bfloat16 leaf as its two raw
    bytes; ``leaf_tensor`` views them), as the reference returns them."""
    rules = current_rules() if rules is None else rules
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    specs = manifest["leaves"]
    if like is None:
        return [np.load(path / f"leaf_{i:05d}.npy")
                for i in range(manifest["num_leaves"])], manifest["extra"]
    tree = _reference_tree(like)
    if len(tree.leaves) != manifest["num_leaves"]:
        raise ValueError(f"{path} holds {manifest['num_leaves']} leaves, "
                         f"the state {len(tree.leaves)}")
    split = _splits(rules) and tree.cfg is not None
    for i, (leaf, spec, where) in enumerate(zip(tree.leaves, specs,
                                                tree.paths)):
        arr = leaf_tensor(np.load(path / f"leaf_{i:05d}.npy"),
                          spec["dtype"])
        rows = list(arr) if leaf.stacked else [arr]
        if len(rows) != len(leaf.values):
            raise ValueError(f"{where}: {len(rows)} rows saved, the state "
                             f"has {len(leaf.values)}")
        for row, target, name in zip(rows, leaf.values, leaf.names):
            if split and name is not None:
                row = shard_named({name: row}, tree.cfg, rules)[name]
            _copy_into(target, row, f"{where} ({name})" if name else where)
    return like, manifest["extra"]


class AsyncCheckpointer:
    """Background writer thread. ``save`` copies the state to the host on
    the caller's thread (gathered whole under rules that split it: every
    rank calls ``save``), and only then enqueues the copy, so a step that
    updates the state in place right after cannot race the write; rank 0
    alone writes. ``wait`` drains the queue (and, under ranks, ends in a
    barrier). ``stats`` holds one record a save: its step, bytes, and the
    seconds of the host copy and of the write."""

    def __init__(self, directory: str | Path, keep: int = 3, rules=None):
        self.directory = Path(directory)
        self.keep = keep
        self.rules = current_rules() if rules is None else rules
        self.stats: list[dict] = []
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._errors: list[Exception] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            step, tree, extra, record = item
            item = None
            try:
                t0 = time.perf_counter()
                _write(self.directory, step, tree, self.keep, extra)
                record["write_s"] = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - surfaced via .wait()
                self._errors.append(e)
            finally:
                del tree
                self._q.task_done()

    def save(self, step: int, state: Any, extra: dict | None = None):
        t0 = time.perf_counter()
        tree = _host_leaves(state, self.rules)
        record = {"step": step, "copy_s": time.perf_counter() - t0,
                  "bytes": sum(_nbytes(v) for leaf in tree.leaves
                               for v in leaf.values)}
        self.stats.append(record)
        if _writer(self.rules):
            self._q.put((step, tree, extra, record))

    def wait(self):
        self._q.join()
        _barrier(self.rules)
        if self._errors:
            raise self._errors[-1]

    def close(self):
        self.wait()
        self._q.put(_SENTINEL)
        self._thread.join(timeout=10)


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)
