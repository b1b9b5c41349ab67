"""Collectives of the port: the int8-wire gradient all-reduce (the port of
``repro/parallel/collectives.py``), the process-group calls the data and
pipeline planes make, and the differentiable collectives of tensor and
sequence parallelism: the explicit form of what GSPMD inserted in the
reference around its sharded einsums.

The tensor-parallel ones are ``torch.autograd.Function``s over one
process group (an axis's or a tuple of axes', ``Mesh.group``); each is
the identity where the group is ``None`` (a split over one rank):

- ``copy_to`` / ``reduce_from``: Megatron's pair, identity forward with a
  sum of the gradient backward, and the reverse; ``reduce_both``, the
  sum both ways (partial sums each rank then uses its own way);
- ``gather_along`` / ``reduce_scatter_along``: the ranks' blocks joined
  along a dimension, with a sum-and-split backward, and its transpose;
- ``split_along`` / ``gather_replicated``: this rank's block of a
  replicated tensor, the blocks' gradients gathered backward, and its
  transpose, the blocks joined forward and this rank's block of a
  gradient every rank holds alike taken backward (no collective);
- ``exchange_rows``: ``all_to_all`` (row ``i`` of ``(n, ...)`` to rank
  ``i``) whose backward is the inverse exchange, the same call on the
  gradient: the expert-parallel MoE's dispatch and return;
- ``int8_gather_along``: the twin of the reference's ``_int8_broadcast``
  (``repro/models/attention.py``): each rank quantizes its block with one
  scale per row of the last dimension (absmax / 127), the int8 codes and
  the fp32 scales are gathered and dequantized; its backward is the plain
  sum-and-split of the gradient (a straight-through estimator).

Every call goes through ``_staged``: under ``gloo`` (the CPU, or ranks that
share one card) a CUDA tensor is copied to host memory, the collective runs
there, and the result is copied back, on every call; under ``nccl`` the
tensor goes as it is. Nothing else picks a path. A collective that fails
raises on its rank; none is retried or skipped.

``COLLECTIVE_STATS`` counts the calls, bytes (of this rank's tensors),
result bytes (what the call leaves on this rank: ``n`` times the bytes of
an all-gather over ``n`` ranks) and host seconds of every collective by
kind, so a run can report what tensor parallelism cost it. ``_record`` is
the one point every call passes; a dispatch trace
(``repro_torch.launch.dispatch_analysis``) counts there too.

``compressed_allreduce`` is the reference's int8 ring-style all-reduce:
all_to_all(int8) -> local dequantize-and-sum -> requantize ->
all_gather(int8), about 4x fewer wire bytes than fp32 at the cost of one
requantization. As in the reference, the train step does not wire it
(``OptimizerConfig.grad_compression`` is carried and not read).
"""

from __future__ import annotations

import time
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from repro_torch.kernels import traced as _traced


def _staged(fn: Callable, *tensors: torch.Tensor, group=None):
    """Run ``fn(*tensors)`` (a collective that writes into its tensor
    arguments) and return them. Under ``gloo``, CUDA tensors go through
    host copies, written back to the originals after the call. Under the
    ``fake`` backend (a dry-run's process group, ``launch/dryrun.py``)
    nothing is called or copied: it moves no data, and a point-to-point
    call would find no backend for a meta tensor."""
    backend = dist.get_backend(group)
    if backend == "fake":
        return tensors
    if backend != "gloo" or not any(t.is_cuda for t in tensors):
        fn(*tensors)
        return tensors
    host = [t.cpu() for t in tensors]
    fn(*host)
    for t, h in zip(tensors, host):
        t.copy_(h)
    return tensors


COLLECTIVE_STATS: dict[str, dict] = {}


def reset_collective_stats() -> None:
    COLLECTIVE_STATS.clear()


def _record(kind: str, nbytes: int, seconds: float,
            result_bytes: int) -> None:
    row = COLLECTIVE_STATS.setdefault(kind, {"calls": 0, "bytes": 0,
                                             "result_bytes": 0,
                                             "seconds": 0.0})
    row["calls"] += 1
    row["bytes"] += int(nbytes)
    row["result_bytes"] += int(result_bytes)
    row["seconds"] += seconds
    if _traced.TRACER is not None:
        _traced.TRACER.collective(kind, int(result_bytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _timed(kind: str, nbytes: int, fn, *tensors, group=None,
           result_bytes: int | None = None):
    t0 = time.perf_counter()
    out = _staged(fn, *tensors, group=group)
    _record(kind, nbytes, time.perf_counter() - t0,
            nbytes if result_bytes is None else result_bytes)
    return out


def all_reduce_(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (or reduce it by ``op``, a
    ``dist.ReduceOp``)."""
    op = dist.ReduceOp.SUM if op is None else op
    _timed("all_reduce", _nbytes(t),
           lambda x: dist.all_reduce(x, op=op, group=group), t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in rank order (gathered as
    rows of ``t.numel()`` elements, a 0-d ``t`` among them)."""
    n = dist.get_world_size(group)
    out = t.new_empty((n, t.numel()))
    _timed("all_gather", _nbytes(t),
           lambda o, x: dist.all_gather(list(o.unbind(0)), x, group=group),
           out, t.reshape(-1).contiguous(), group=group,
           result_bytes=_nbytes(out))
    return out.view((n,) + tuple(t.shape))


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t (n, ...)``: row ``i`` goes to rank ``i``; returns the rows every
    rank sent here, in rank order."""
    out = torch.empty_like(t)
    _timed("all_to_all", _nbytes(t),
           lambda o, x: dist.all_to_all_single(o, x, group=group),
           out, t.contiguous(), group=group)
    return out


def exchange(send: torch.Tensor | None, dst: int | None,
             recv: torch.Tensor | None, src: int | None, group) -> None:
    """One ``batch_isend_irecv`` of ``send`` to global rank ``dst`` and
    into ``recv`` from global rank ``src`` (either may be absent), recorded
    as a ``collective_permute`` of the tensor's bytes (what the reference's
    ``ppermute`` leaves on every rank of the shift)."""
    tensors = [t for t in (send, recv) if t is not None]
    if not tensors:
        return

    def run(*staged):
        it = iter(staged)
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, next(it), dst, group=group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, next(it), src, group=group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    nbytes = max(_nbytes(t) for t in tensors)
    _timed("collective_permute", nbytes, run,
           *[t.contiguous() if t is send else t for t in tensors],
           group=group)


class _ReplicatedSum(torch.autograd.Function):
    """Sum over a group whose ranks all compute the same loss from the sum:
    each rank's gradient with respect to its own term is the loss's
    gradient with respect to the sum, so the backward passes it on as it
    is (the reference's ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``, for a result that every
    rank then uses identically (``_ReplicatedSum``)."""
    return _ReplicatedSum.apply(x, group)


# -- the int8 gradient all-reduce ---------------------------------------------


def _quantize(x: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor quantization: int8 codes and the fp32 scale
    (``absmax / 127``); ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    lim = float(2 ** (bits - 1) - 1)
    absmax = torch.clamp(x.abs().max(), min=1e-12)
    scale = absmax / lim
    q = torch.clamp(torch.round(x / scale), -lim, lim).to(torch.int8)
    return q, scale


def compressed_allreduce(x: torch.Tensor, group, bits: int = 8
                         ) -> torch.Tensor:
    """int8-wire all-reduce of ``x`` (the same shape on every rank) over
    ``group``: the sum over the ranks, within the two quantizations."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % n
    chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1)

    q, scale = _quantize(chunks, bits)
    # reduce-scatter phase: rank i receives chunk i from every peer
    gathered = all_to_all(q, group)                           # (n, chunk)
    scales = all_gather(scale, group)                         # (n,)
    partial_sum = (gathered.float() * scales[:, None]).sum(dim=0)

    # all-gather phase: requantize the reduced chunk, share it with all
    q2, scale2 = _quantize(partial_sum, bits)
    all_q = all_gather(q2, group)                             # (n, chunk)
    all_s = all_gather(scale2, group)                         # (n,)
    total = (all_q.float() * all_s[:, None]).reshape(-1)
    return total[:x.numel()].reshape(x.shape).to(x.dtype)


def make_compressed_grad_allreduce(mesh, axis: str = "pod", bits: int = 8):
    """``fn(grads) -> the mean over mesh axis `axis` of every leaf of the
    mapping `grads``, int8 on the wire. The gradients must be whole on
    each rank (replicated along ``axis``)."""
    group = mesh.group(axis)
    n = int(mesh.shape[axis])

    def reduce(grads: Mapping[str, torch.Tensor]) -> dict:
        return {k: compressed_allreduce(g, group, bits) / n
                for k, g in grads.items()}

    return reduce


def flat_all_reduce_(tensors: list[torch.Tensor], group,
                     bucket: int = 1 << 26) -> None:
    """Sum every tensor of ``tensors`` (fp32) over ``group`` in place, in
    buckets of at most ``bucket`` elements: one collective a bucket."""
    i = 0
    while i < len(tensors):
        j, count = i, 0
        while j < len(tensors) and (j == i or count + tensors[j].numel()
                                    <= bucket):
            count += tensors[j].numel()
            j += 1
        part = tensors[i:j]
        buf = torch.cat([t.reshape(-1) for t in part])
        all_reduce_(buf, group)
        offset = 0
        for t in part:
            t.copy_(buf[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        i = j



# -- tensor and sequence parallelism -------------------------------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in rank order (no
    gradient)."""
    if group_size(group) == 1:
        return t
    parts = all_gather(t.contiguous(), group)           # (n, *t.shape)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``
    (no gradient): the sum is taken whole and split here, since ``gloo``
    has no reduce-scatter."""
    n = group_size(group)
    if n == 1:
        return t
    total = all_reduce_(t.contiguous().clone(), group)
    return total.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, i = group_size(group), group_rank(group)
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad.contiguous(), ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        n, i = group_size(ctx.group), group_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[i].contiguous(), None, None


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad_scale=1.0):
        ctx.dim, ctx.group, ctx.grad_scale = dim, group, grad_scale
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        out = reduce_scatter_dim(grad, ctx.dim, ctx.group)
        if ctx.grad_scale != 1.0:
            out = out * ctx.grad_scale
        return out, None, None, None


class _ReduceScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad, ctx.dim, ctx.group), None, None


def quantize_rows(x: torch.Tensor):
    """Symmetric int8 codes of ``x`` with one fp32 scale per row of its last
    dimension, ``absmax / 127`` (at least 1e-9 / 127), and the scales with
    the last dimension kept (size 1): the reference's ``_int8_broadcast``
    quantization."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-9) \
        / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


class _Int8GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        q, scale = quantize_rows(x)
        q_all = gather_dim(q, dim, group)
        s_all = gather_dim(scale, dim, group)
        return (q_all.float() * s_all).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward: a
    replicated input entering each rank's own part of a computation."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward; the identity backward: each rank's
    partial result summed into one every rank then uses alike."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group,
                 grad_scale: float = 1.0) -> torch.Tensor:
    """The ranks' blocks joined along ``dim`` forward; backward, the sum
    over ``group`` of the gradient, this rank's block of it (times
    ``grad_scale``: ``1/r`` where each gradient arrives from ``r`` ranks
    that computed the same thing)."""
    return x if group_size(group) == 1 else \
        _GatherAlong.apply(x, dim, group, grad_scale)


def reduce_scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``gather_along``'s transpose: this rank's block along ``dim`` of the
    sum over ``group`` forward, the gradient's blocks joined backward."""
    return x if group_size(group) == 1 else \
        _ReduceScatterAlong.apply(x, dim, group)


def reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of partial sums, which each rank then uses its
    own way: forward and backward an all-reduce (``reduce_from`` then
    ``copy_to``)."""
    return copy_to(reduce_from(x, group), group)


def split_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, which every rank of
    ``group`` holds alike; backward, the blocks' gradients gathered whole
    (each rank's part of the computation downstream is its own)."""
    return x if group_size(group) == 1 else \
        _SplitAlong.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks joined along ``dim`` for a computation every rank
    of ``group`` then runs alike: backward, this rank's block of the
    gradient, which every rank holds whole and alike (``gather_along``
    would sum ``n`` equal copies)."""
    return x if group_size(group) == 1 else \
        _GatherReplicated.apply(x, dim, group)


def exchange_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all`` of ``x (n, ...)`` (row ``i`` to rank ``i``; the rows
    every rank sent here, in rank order), differentiable: the backward
    sends each gradient row back where its row came from, the same
    exchange. Recorded under ``all_to_all`` in ``COLLECTIVE_STATS``."""
    return x if group_size(group) == 1 else _ExchangeRows.apply(x, group)


def int8_gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``gather_along`` on an int8 wire (``_Int8GatherAlong``): the ranks'
    blocks quantized per row of the last dimension, gathered with their
    scales and dequantized to ``x``'s dtype; the backward is
    ``gather_along``'s."""
    return x if group_size(group) == 1 else \
        _Int8GatherAlong.apply(x, dim, group)
