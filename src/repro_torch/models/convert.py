"""Carry parameter trees between the reference's layout and the port's
modules.

``params_from_numpy(jax.tree.map(np.asarray, repro.models.init_lm(cfg,
key)[0]), cfg, device)`` gives the port's ``LM`` with the reference's
weights, so both packages can be run on the same model;
``params_to_numpy(model, cfg)`` is its inverse, and also restacks any
mapping keyed by the port's parameter names (gradients, the optimizer's
``master``, ``m`` and ``v``); ``opt_state_from_numpy`` carries the
reference's optimizer state across the same way. The reference stacks each pattern position's
leaves over the repeats (``params["blocks"][p][...]`` has a leading
``repeats`` axis); layer ``r * P + p`` is row ``r`` of position ``p``.

Under sharding rules that split more than the batch, ``shard_params``
gives a rank its shard of every leaf of a whole model (made from the seed,
or carried across by ``params_from_numpy``) and ``shard_named`` of any
mapping keyed by the parameters' names (the optimizer's ``master``, ``m``
and ``v``); ``gather_named`` is their inverse, for ``params_to_numpy``.
A dimension is cut as the reference's ``spec`` cuts it (an axis used
once: ``wv`` and ``w_gates``, ``("inner", "inner")``, are split on their
rows only), into equal blocks, block ``mesh.axes_index(A)`` kept, with one
exception of layout: the inner dimension of Mamba's ``in_proj`` and of
the xLSTM blocks' ``up`` holds two halves (the branch ``u`` and the gate
``z``), and a rank keeps block ``i`` of each half (``SPLIT_HALVES``), so
that its ``u`` and ``z`` are the same features (the reference's block of
the joined dimension is resharded by GSPMD before its split).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = val


def _unstack(tree: dict) -> dict:
    """``{port parameter name: array}`` of a reference-layout tree (row
    ``r`` of position ``p`` of ``blocks`` is layer ``r * P + p``)."""
    flat: dict = {}
    _flatten({k: v for k, v in tree.items() if k != "blocks"}, "", flat)
    period = len(tree["blocks"])
    for p, stacked in enumerate(tree["blocks"]):
        leaves: dict = {}
        _flatten(stacked, "", leaves)
        for name, arr in leaves.items():
            for r in range(arr.shape[0]):
                flat[f"layers.{r * period + p}.{name}"] = arr[r]
    return flat


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The port's model holding the weights of a reference parameter tree
    whose leaves are numpy arrays (bfloat16 leaves as ``ml_dtypes``
    arrays): the embedding, the final norm, the stub frontend's
    ``patch_proj`` or ``frame_proj``, and every layer's leaves (fp32 ones,
    such as Mamba's ``a_log`` or sLSTM's ``r_gates``, stay fp32). Raises if
    a leaf is missing, left over or of another shape or dtype."""
    dev = resolve_device(device)
    flat = _unstack(tree)
    model = LM(cfg, None, torch.device("meta"))
    want = dict(model.named_parameters())
    if set(flat) != set(want):
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(set(want) - set(flat))}, left over "
                         f"{sorted(set(flat) - set(want))}")
    state = {}
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(want[name].shape)}")
        t = _tensor(arr, dev)
        if t.dtype != want[name].dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected "
                             f"{want[name].dtype}")
        state[name] = torch.nn.Parameter(t, requires_grad=False)
    model.load_state_dict(state, assign=True)
    return model


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's optimizer state (``training.init_opt_state``'s layout:
    ``step``, and ``master``, ``m`` and ``v`` keyed by the port's parameter
    names) of the reference's, whose leaves are numpy arrays. Raises if a
    leaf is missing, left over or of another shape than the parameter's."""
    dev = resolve_device(device)
    shapes = {k: s for k, (s, _) in _meta_leaves(cfg).items()}
    out = {"step": _tensor(tree["step"], dev)}
    for key in ("master", "m", "v"):
        flat = _unstack(tree[key])
        if set(flat) != set(shapes):
            raise ValueError(f"{key}: trees differ: missing "
                             f"{sorted(set(shapes) - set(flat))}, left over "
                             f"{sorted(set(flat) - set(shapes))}")
        for name, arr in flat.items():
            if tuple(arr.shape) != shapes[name].shape:
                raise ValueError(f"{key}.{name}: shape {arr.shape}, "
                                 f"expected {shapes[name].shape}")
        out[key] = {name: _tensor(flat[name], dev) for name in shapes}
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # the bits, as an ml_dtypes array
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _nest(tree: dict, name: str, value) -> None:
    *parents, leaf = name.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def _restack(named: dict, cfg: ModelConfig, leaf, stack) -> dict:
    """The reference's tree of a mapping keyed by the port's parameter
    names: ``leaf(value)`` at the top-level names, ``stack(rows)`` at each
    layer leaf, ``rows`` that leaf's values over the repeats in order."""
    period = len(cfg.block_pattern)
    tree: dict = {}
    per_position: list[dict] = [{} for _ in range(period)]
    for name, t in named.items():
        if not name.startswith("layers."):
            _nest(tree, name, leaf(t))
            continue
        _, index, rest = name.split(".", 2)
        i = int(index)
        per_position[i % period].setdefault(rest, {})[i // period] = t
    blocks = []
    for leaves in per_position:
        stacked: dict = {}
        for rest, rows in leaves.items():
            _nest(stacked, rest, stack([rows[r] for r in range(len(rows))]))
        blocks.append(stacked)
    tree["blocks"] = tuple(blocks)
    return tree


def params_to_numpy(model, cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``model`` (an ``LM``, or a mapping
    from the port's parameter names to tensors): ``embed``,
    ``final_norm``, the stub frontend's projection and ``blocks``, a tuple
    over the pattern positions of each layer's leaves stacked over the
    repeats. Leaves are numpy arrays (bfloat16 ones as ``ml_dtypes``
    arrays)."""
    named = dict(model.named_parameters()) if isinstance(model, LM) \
        else dict(model)
    return _restack(named, cfg, _array,
                    lambda rows: np.stack([_array(r) for r in rows]))


@dataclass(frozen=True)
class ParamShape:
    """A parameter's shape and dtype, with no storage behind it."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@functools.lru_cache(maxsize=64)
def _meta_leaves(cfg: ModelConfig) -> dict:
    """``{name: (ParamShape, logical axes)}`` of every parameter, read off
    a model built on the meta device, so none is allocated (the planner
    walks qwen2-72b at full width). Cached per config; callers copy."""
    model = LM(cfg, None, torch.device("meta"))
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = (ParamShape(tuple(p.shape), p.dtype),
                         type(mod).AXES[leaf])
    return out


@functools.lru_cache(maxsize=64)
def _halves(cfg: ModelConfig) -> frozenset:
    """The parameters whose ``inner`` dimension holds two halves, each
    split on its own (a module's ``SPLIT_HALVES``)."""
    model = LM(cfg, None, torch.device("meta"))
    return frozenset(
        f"{mod_name}.{leaf}" for mod_name, mod in model.named_modules()
        for leaf in getattr(type(mod), "SPLIT_HALVES", ()))


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in the reference's tree (the
    second output of its ``init_lm``): a tuple of axis names (or ``None``)
    per leaf, ``"layers"`` first on the leaves stacked over the repeats."""
    axes = {k: a for k, (_, a) in _meta_leaves(cfg).items()}
    return _restack(axes, cfg, lambda a: a, lambda rows: ("layers",) + rows[0])


def param_shapes(cfg: ModelConfig) -> dict:
    """``ParamShape`` of every parameter in ``param_axes``'s tree (stacked
    leaves lead with the repeats), without allocating any."""
    shapes = {k: s for k, (s, _) in _meta_leaves(cfg).items()}
    return _restack(shapes, cfg, lambda s: s, lambda rows: ParamShape(
        (len(rows),) + rows[0].shape, rows[0].dtype))


# -- shards ------------------------------------------------------------------


def _spec_axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _cuts(rules, logical: tuple, shape: tuple, halves: bool = False) -> list:
    """``(dim, axes, n, index, halves)`` of every dimension of a leaf that
    ``rules`` split over more than one rank (``ShardingRules.spec``), this
    rank's block index among ``n``, and whether the dimension is cut as two
    halves (``halves``: the leaf's ``inner`` dimension); a dimension that
    does not divide raises."""
    mesh = rules.mesh
    cuts = []
    for dim, part in enumerate(rules.spec(*logical)):
        axes = tuple(a for a in mesh.axis_names if a in _spec_axes(part)
                     and int(mesh.shape[a]) > 1)
        n = math.prod(int(mesh.shape[a]) for a in axes)
        if n == 1:
            continue
        two = halves and logical[dim] == "inner"
        if shape[dim] % (2 * n if two else n):
            raise ValueError(f"dimension {dim} ({logical[dim]}) of {shape} "
                             f"does not split over {n} ranks of {axes}")
        cuts.append((dim, axes, n, mesh.axes_index(axes), two))
    return cuts


def _shard(t: torch.Tensor, cuts: list) -> torch.Tensor:
    for dim, _, n, index, two in cuts:
        if two:
            t = t.unflatten(dim, (2, t.shape[dim] // 2))
            step = t.shape[dim + 1] // n
            t = t.narrow(dim + 1, index * step, step).flatten(dim, dim + 1)
        else:
            step = t.shape[dim] // n
            t = t.narrow(dim, index * step, step)
    return t.contiguous()


def shard_named(named, cfg: ModelConfig, rules) -> dict:
    """``{name: this rank's shard}`` of a mapping from the port's parameter
    names to whole tensors of the parameters' shapes (parameters,
    gradients, optimizer state): each dimension split over mesh axes ``A``
    keeps block ``mesh.axes_index(A)`` of ``prod(|A|)``."""
    leaves, halves = _meta_leaves(cfg), _halves(cfg)
    return {k: _shard(t, _cuts(rules, leaves[k][1], tuple(t.shape),
                               k in halves))
            for k, t in dict(named).items()}


def shard_params(model: LM, rules) -> LM:
    """A model holding this rank's shard of every parameter of the whole
    ``model`` (on its device, gradients off as ``init_lm`` builds them; the
    whole model is left as it is)."""
    cfg = model.cfg
    named = {k: p.detach() for k, p in model.named_parameters()}
    local = LM(cfg, None, torch.device("meta"))
    for name, t in shard_named(named, cfg, rules).items():
        *path, leaf = name.split(".")
        setattr(local.get_submodule(".".join(path)), leaf,
                torch.nn.Parameter(t.clone(), requires_grad=False))
    return local


def gather_named(named, cfg: ModelConfig, rules) -> dict:
    """``shard_named``'s inverse on every rank: each leaf's shards gathered
    whole over the mesh axes that split it (a collective: every rank calls
    it with the same names, in the same order). ``named`` is an ``LM`` or
    a mapping by the parameters' names."""
    from repro_torch.parallel.collectives import gather_dim
    named = dict(named.named_parameters()) if isinstance(named, LM) \
        else dict(named)
    leaves, halves = _meta_leaves(cfg), _halves(cfg)
    out = {}
    with torch.no_grad():
        for k, t in named.items():
            full = t.detach()
            for dim, axes, _, _, two in reversed(_cuts(
                    rules, leaves[k][1], leaves[k][0].shape, k in halves)):
                group = rules.mesh.group(axes)
                if two:
                    full = gather_dim(full.unflatten(
                        dim, (2, full.shape[dim] // 2)).contiguous(),
                        dim + 1, group).flatten(dim, dim + 1)
                else:
                    full = gather_dim(full.contiguous(), dim, group)
            out[k] = full
    return out
