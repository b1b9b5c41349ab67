"""Collectives of the port: the int8-wire gradient all-reduce (the port of
``repro/parallel/collectives.py``) and the process-group calls the data
and pipeline planes make.

Every call goes through ``_staged``: under ``gloo`` (the CPU, or ranks that
share one card) a CUDA tensor is copied to host memory, the collective runs
there, and the result is copied back, on every call; under ``nccl`` the
tensor goes as it is. Nothing else picks a path.

``compressed_allreduce`` is the reference's int8 ring-style all-reduce:
all_to_all(int8) -> local dequantize-and-sum -> requantize ->
all_gather(int8), about 4x fewer wire bytes than fp32 at the cost of one
requantization. As in the reference, the train step does not wire it
(``OptimizerConfig.grad_compression`` is carried and not read).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.distributed as dist


def _staged(fn: Callable, *tensors: torch.Tensor, group=None):
    """Run ``fn(*tensors)`` (a collective that writes into its tensor
    arguments) and return them. Under ``gloo``, CUDA tensors go through
    host copies, written back to the originals after the call."""
    if dist.get_backend(group) != "gloo" \
            or not any(t.is_cuda for t in tensors):
        fn(*tensors)
        return tensors
    host = [t.cpu() for t in tensors]
    fn(*host)
    for t, h in zip(tensors, host):
        t.copy_(h)
    return tensors


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    _staged(lambda x: dist.all_reduce(x, group=group), t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in rank order (gathered as
    rows of ``t.numel()`` elements, a 0-d ``t`` among them)."""
    n = dist.get_world_size(group)
    out = t.new_empty((n, t.numel()))
    _staged(lambda o, x: dist.all_gather(list(o.unbind(0)), x, group=group),
            out, t.reshape(-1).contiguous(), group=group)
    return out.view((n,) + tuple(t.shape))


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t (n, ...)``: row ``i`` goes to rank ``i``; returns the rows every
    rank sent here, in rank order."""
    out = torch.empty_like(t)
    _staged(lambda o, x: dist.all_to_all_single(o, x, group=group),
            out, t.contiguous(), group=group)
    return out


def exchange(send: torch.Tensor | None, dst: int | None,
             recv: torch.Tensor | None, src: int | None, group) -> None:
    """One ``batch_isend_irecv`` of ``send`` to global rank ``dst`` and
    into ``recv`` from global rank ``src`` (either may be absent)."""
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

    _staged(run, *[t.contiguous() if t is send else t for t in tensors],
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

