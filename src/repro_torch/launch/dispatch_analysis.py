"""Dispatch-level cost analysis of one traced step: the twin of
``repro/launch/hlo_analysis.py``.

The reference parses optimized HLO text, because XLA's
``cost_analysis()`` visits a while loop's body once: it rebuilds the call
graph, reads each loop's trip count and multiplies what the body costs.
Here the step is run eagerly under a ``TorchDispatchMode`` on meta
tensors, which have shapes, dtypes and strides and no storage. Eager
PyTorch dispatches every iteration of every layer, microbatch and scan
step, so loops count by construction, and no trip count is read.

``analyze(fn, *args, **kwargs)`` runs ``fn`` once under a ``Tracer`` and
returns its ``Costs``:

- **FLOPs** of every matrix product and convolution, by the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry, but for a
  grouped convolution's backward: ``_conv_backward_flops``; the reference
  counts its ``dot`` and ``convolution`` instructions), plus
- **the kernels'** work, counted at their wrappers (K1-K3 in
  ``kernels/partition.py``, K4, K4b and K5 in ``kernels/attention.py``)
  by the formula each kernel module gives for it (``*_work``): what the
  function does, not how a route does it. Nothing inside a kernel's call
  is counted a second time, so a trace of the CPU's program (the plain
  routes) counts what a trace of the card's does. ``attention_flops`` and
  the launches, FLOPs and bytes by kernel keep that part apart.
- **Collectives**, at ``repro_torch.parallel.collectives``' one recording
  point (``_record``, which every collective call of the port passes,
  the pipeline's ``batch_isend_irecv`` among them): calls and result
  bytes on this rank by the reference's kinds.

The trace also follows the step's memory: every storage the step's
arguments hold, and every one an operation makes, is live from its making
until Python frees it, as the caching allocator would see it;
``peak_bytes`` is the most live at once (the kernels' per-stream scratch
of the card's program included). A meta tensor cannot be read, so a host
read in the step (``.item()``, ``.tolist()``, a data-dependent shape)
raises under the trace.

Each operation's outputs come from a cache keyed by the operation and its
inputs' shapes, strides and dtypes where they are fresh tensors; views
run as they are, and an in-place operation hands back the tensor it
writes. Meta kernels in PyTorch are Python reference implementations for
most elementwise operations; the cache keeps a production cell's
millions of operations from running them again.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import traced as _traced

# the port's collective kinds (``collectives.COLLECTIVE_STATS``) by the
# reference's names (its HLO instructions)
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "collective_permute": "collective-permute"}
ATTENTION_KERNELS = ("flash_attention", "flash_attention_bwd",
                     "decode_attention")


def _conv_backward_flops(grad_out, x, w, *args, out_val=None, **kwargs):
    """A convolution's backward: its input's gradient and its weight's,
    each the forward's ``2 * numel(out) * prod(w.shape[1:])`` FLOPs (the
    registry's own formula transposes the weight as if ``groups`` were 1,
    which counts a depthwise convolution's backward ``C_in`` times over)."""
    mask = args[-1] if args else kwargs["output_mask"]
    per = 2 * grad_out.numel() * w[0].numel()
    return per * (int(bool(mask[0])) + int(bool(mask[1])))


FLOP_FORMULAS = {**flop_registry, torch.ops.aten.convolution_backward:
                 _conv_backward_flops}


@dataclass
class Costs:
    """What one traced call does on this rank. ``flops``,
    ``collective_bytes``, ``collective_counts``, ``add`` and
    ``total_collective_bytes`` are the reference's; the kernels' part and
    the memory are the trace's own (``add`` sums the counts and keeps the
    larger memory figures)."""

    flops: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    flops_by_op: dict = field(default_factory=dict)
    attention_flops: float = 0.0
    kernel_launches: dict = field(default_factory=dict)
    kernel_flops: dict = field(default_factory=dict)
    kernel_bytes: dict = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.attention_flops += other.attention_flops * mult
        for name in ("collective_bytes", "collective_counts", "flops_by_op",
                     "kernel_launches", "kernel_flops", "kernel_bytes"):
            mine = getattr(self, name)
            for k, v in getattr(other, name).items():
                mine[k] = mine.get(k, 0) + v * mult
        for name in ("argument_bytes", "output_bytes", "peak_bytes"):
            setattr(self, name, max(getattr(self, name),
                                    getattr(other, name)))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def collective_costs(stats: dict) -> tuple[dict, dict]:
    """``(bytes, counts)`` by the reference's kinds of a
    ``collectives.COLLECTIVE_STATS`` snapshot (result bytes): what a real
    run's rank did, in ``Costs``' terms."""
    return ({KINDS[k]: v["result_bytes"] for k, v in stats.items()},
            {KINDS[k]: v["calls"] for k, v in stats.items()})


# how an operation's outputs are made: fresh tensors from the cache's
# shapes; the argument an in-place operation writes, returned as it is;
# or by running it (views, and whatever else shares or changes storage)
_FRESH, _INPLACE, _DIRECT = 0, 1, 2
# operations whose outputs share an input's storage without saying so in
# their schema
_ALIASING = {torch.ops.aten._unsafe_view.default,
             torch.ops.aten.lift_fresh.default}


def _classify(func) -> tuple[int, object]:
    """``(how, where)``: for an in-place operation, where the tensor it
    writes and returns sits (a position or a keyword)."""
    schema = func._schema
    rets = schema.returns
    if func in _ALIASING or func.is_view:
        return _DIRECT, None
    if any(str(r.type) not in ("Tensor", "Tensor[]", "Tensor?")
           for r in rets):
        return _DIRECT, None
    if not schema.is_mutable and all(r.alias_info is None for r in rets):
        return _FRESH, None
    if len(rets) == 1 and rets[0].alias_info is not None \
            and rets[0].alias_info.is_write:
        sets = rets[0].alias_info.before_set
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write \
                    and arg.alias_info.before_set == sets:
                return _INPLACE, (arg.name if arg.kwarg_only else i)
    return _DIRECT, None


def _key(x):
    """A hashable key of an argument: a tensor by its shape, strides,
    dtype and device; a number with its type (``2``, ``2.0`` and ``True``
    are equal keys in Python, and give outputs of other dtypes)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if type(x) is list or type(x) is tuple:
        return tuple(map(_key, x))
    if type(x) in (int, float, bool, complex):
        return (type(x), x)
    return x


class _Meta(tuple):
    """A cached output tensor: ``(shape, stride, dtype)``."""


def _spec(out):
    """The cache's entry of an operation's output; a tensor that is not a
    meta tensor (an operation on host tensors holding data) raises
    ``ValueError``: such an operation is not cached."""
    if isinstance(out, torch.Tensor):
        if not out.is_meta:
            raise ValueError("a tensor with data")
        return _Meta((tuple(out.shape), out.stride(), out.dtype))
    if isinstance(out, (list, tuple)):
        return type(out)(_spec(v) for v in out)
    if out is None:
        return None
    raise TypeError(type(out))


def _build(spec):
    if type(spec) is _Meta:
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                                   device="meta")
    if spec is None:
        return None
    return type(spec)(_build(s) for s in spec)


def _tensors(x, out: list) -> list:
    """Every tensor held by ``x`` (a tensor, a module's parameters and
    buffers, or the values of a mapping or a sequence)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, torch.nn.Module):
        out.extend(x.parameters())
        out.extend(x.buffers())
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def storage_bytes(x) -> int:
    """The bytes of the distinct storages ``x`` holds."""
    seen = {}
    for t in _tensors(x, []):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class Tracer(TorchDispatchMode):
    """Counts what the operations it dispatches do (module docstring).
    ``program`` is the device whose program is followed: ``"cuda"`` (the
    kernels' CUDA routes: their outputs and per-stream scratch) or
    ``"cpu"`` (their plain routes, run on the meta tensors where they can
    be, their own operations not counted; K4 with a gradient keeps the
    card's autograd structure, K4b's plain version in its backward, where
    a real CPU run differentiates K4's plain version).

    Outputs are cached by shapes across tracers (``_cache``): an
    operation's output shapes depend on nothing else, and the cells of a
    sweep share most of them."""

    _kinds: dict = {}
    _cache: dict = {}

    def __init__(self, program: str = "cuda"):
        super().__init__()
        if program not in ("cuda", "cpu"):
            raise ValueError(f"program must be cuda or cpu, got {program!r}")
        self.program = program
        self.costs = Costs()
        self._inside = 0             # depth of kernel calls being run
        self._live: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self._now = 0
        self._scratch: dict[str, torch.Tensor] = {}

    # -- memory ---------------------------------------------------------------

    def _hold(self, t: torch.Tensor) -> None:
        if not t.is_meta:                # host tensors with data
            return
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._live:
            return
        n = st.nbytes()
        self._live[sid] = n
        self._refs[sid] = weakref.ref(st, lambda _, sid=sid: self._drop(sid))
        self._now += n
        if self._now > self.costs.peak_bytes:
            self.costs.peak_bytes = self._now

    def _drop(self, sid: int) -> None:
        self._now -= self._live.pop(sid, 0)
        self._refs.pop(sid, None)

    def _hold_all(self, out) -> None:
        if isinstance(out, torch.Tensor):
            self._hold(out)
        elif isinstance(out, (list, tuple)):
            for t in out:
                if isinstance(t, torch.Tensor):
                    self._hold(t)

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        how = self._kinds.get(func)
        if how is None:
            how = self._kinds[func] = _classify(func)
        key = entry = None
        if how[0] != _DIRECT:
            try:
                key = (func, _key(args),
                       tuple(sorted(zip(kwargs, map(_key, kwargs.values())))))
                entry = self._cache.get(key)
            except TypeError:            # an unhashable argument
                key = None
        if entry is not None:
            spec, flops = entry
            if how[0] == _FRESH:
                out = _build(spec)
            else:
                at = how[1]
                out = kwargs[at] if isinstance(at, str) else args[at]
        else:
            out = func(*args, **kwargs)
            count = FLOP_FORMULAS.get(func._overloadpacket)
            flops = count(*args, **kwargs, out_val=out) if count else 0
            if key is not None:
                self._remember(key, how, out, flops)
        if flops and not self._inside:
            c, op = self.costs, str(func._overloadpacket)
            c.flops += flops
            c.flops_by_op[op] = c.flops_by_op.get(op, 0) + flops
        self._hold_all(out)
        return out

    def _remember(self, key, how, out, flops) -> None:
        """Cache what the operation gave: a fresh operation's outputs by
        their shapes (not one that made host tensors with data); an
        in-place one's if it wrote a meta tensor and left its shape and
        strides as they were."""
        if how[0] == _FRESH:
            try:
                self._cache[key] = (_spec(out), flops)
            except ValueError:
                pass
            return
        at = how[1]
        arg = key[2][[k for k, _ in key[2]].index(at)][1] \
            if isinstance(at, str) else key[1][at]
        if isinstance(out, torch.Tensor) and out.is_meta \
                and arg == _key(out):
            self._cache[key] = (None, flops)

    # -- the kernels' and the collectives' hooks -------------------------------

    def kernel(self, name: str, flops: float, nbytes: float, card, plain):
        c = self.costs
        if not self._inside:
            c.flops += flops
            if name in ATTENTION_KERNELS:
                c.attention_flops += flops
            c.kernel_launches[name] = c.kernel_launches.get(name, 0) + 1
            c.kernel_flops[name] = c.kernel_flops.get(name, 0) + flops
            c.kernel_bytes[name] = c.kernel_bytes.get(name, 0) + nbytes
        self._inside += 1
        try:
            return plain() if self.program == "cpu" and plain is not None \
                else card()
        finally:
            self._inside -= 1

    def scratch(self, name: str, numel: int, dtype: torch.dtype) -> None:
        if self.program != "cuda":
            return
        buf = self._scratch.get(name)
        if buf is None or buf.numel() < numel:
            self._scratch[name] = torch.empty((numel,), dtype=dtype,
                                              device="meta")

    def collective(self, kind: str, result_bytes: int) -> None:
        c, name = self.costs, KINDS[kind]
        c.collective_counts[name] = c.collective_counts.get(name, 0) + 1
        c.collective_bytes[name] = c.collective_bytes.get(name, 0) \
            + result_bytes

    # -- running --------------------------------------------------------------

    def __enter__(self):
        if _traced.TRACER is not None:
            raise RuntimeError("a dispatch trace is already active")
        _traced.TRACER = self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _traced.TRACER = None
            self._scratch.clear()

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` under the trace; returns its output.
        ``self.costs`` then holds what it did, its argument, output and
        peak bytes among them (the arguments' storages live throughout
        unless the step drops them)."""
        held = _tensors((args, kwargs), [])
        self.costs.argument_bytes = storage_bytes(held)
        with self:
            for t in held:
                self._hold(t)
            out = fn(*args, **kwargs)
        self.costs.output_bytes = storage_bytes(out)
        return out


def analyze(fn, *args, **kwargs) -> Costs:
    """The ``Costs`` of ``fn(*args, **kwargs)`` on meta tensors, following
    the card's program (the kernels' CUDA routes)."""
    tracer = Tracer("cuda")
    tracer.run(fn, *args, **kwargs)
    return tracer.costs
