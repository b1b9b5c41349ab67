"""Mamba (selective SSM) block (the port of ``repro/models/ssm.py``).

Prefill walks the sequence a chunk at a time, carrying the ``(B, Din, N)``
state from chunk to chunk, as the reference does. Inside a chunk the
reference runs an associative scan; PyTorch has none, so the port runs the
recurrence ``h_t = a_t * h_{t-1} + bx_t`` step by step, one ``addcmul`` a
position. That is exact in the reference's sense (no product of the
``a_t`` is ever divided out: over a 128-step chunk those products fall
below the smallest fp32 number). ``a_bar`` and ``bx`` are built a chunk
at a time, so the ``(B, C, Din, N)`` fp32 tensors exist for one chunk
only. Decode is the one-token recurrence. Compute follows the reference's
dtypes: the projections in the weights' dtype, the selective parameters
and the state in fp32, ``a_log`` and ``d_skip`` kept fp32.

Under a ``TensorPlan`` whose rules split ``inner`` (over ``model``, or
``("data", "model")`` under ``long_500k``) each rank holds its block of
the inner features: ``in_proj``'s columns (its block of the branch ``u``
and of the gate ``z``: ``convert.shard_params`` keeps block ``i`` of each
half), ``conv_*``, ``dt_proj``'s columns, ``dt_bias``, ``a_log``,
``d_skip``, ``x_proj``'s and ``out_proj``'s rows, and the ``(B, Din/n,
N)`` state. The scan is elementwise in the inner features and needs no
collective. ``x_proj`` takes the rank's rows, so ``dt``, ``B`` and ``C``
are partial sums, summed over the inner ranks (forward and backward:
``collectives.reduce_both``); ``out_proj`` too, so the output is summed
(``reduce_from``). The input enters through ``copy_to``.

Under ``seq_tp`` (jamba's ``train_4k`` / ``prefill_32k``: ``seq`` and
``inner`` both over ``model``) the residual is the rank's block of the
sequence, and the recurrence needs all of it: the block gathers the
sequence (``gather_along``, whose backward sums the ranks' gradients and
hands each its block), runs its inner block over the whole sequence and
hands back its block of the sequence of the summed output
(``reduce_scatter_along``). Where ``seq`` and ``inner`` are split over
other axes (``inner`` over ``model`` beside ``seq`` over ``data``) the
block gathers the sequence the same way, its input enters the inner
ranks through ``copy_to``, and the summed output is cut to the rank's
positions (``tensor.Reshard``); where ``seq`` is split and ``inner`` is
not, every rank runs the whole block and keeps its positions. The
reference's ``spec`` gives ``model`` to the first logical axis that asks
for it: its ``(batch, seq, inner)`` activations are sequence-sharded,
and GSPMD moves them; this layout is the port's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.config import ModelConfig, SSMConfig
from repro_torch.models.layers import frozen, init_normal
from repro_torch.parallel import collectives as C


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    ssm = cfg.ssm or SSMConfig()
    d_in = ssm.expand * cfg.d_model
    dt_rank = ssm.dt_rank or -(-cfg.d_model // 16)
    return d_in, ssm.d_state, ssm.d_conv, dt_rank


class Mamba(nn.Module):
    """The reference's ``init_mamba`` leaves: ``in_proj (d, 2 Din)``,
    ``conv_w (K, Din)``, ``conv_b``, ``x_proj (Din, dt_rank + 2N)``,
    ``dt_proj (dt_rank, Din)``, ``dt_bias``, ``out_proj (Din, d)`` in the
    config's dtype, and ``a_log (Din, N)`` (S4D-real) and ``d_skip`` in
    fp32."""

    AXES = {"in_proj": ("w_embed", "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "a_log": ("inner", None), "d_skip": ("inner",),
            "out_proj": ("inner", "w_embed")}
    SPLIT_HALVES = ("in_proj",)     # u and z: convert.shard_params

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d = cfg.d_model
        d_in, n, d_conv, dt_rank = _dims(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.in_proj = init_normal((d, 2 * d_in), d ** -0.5, dtype,
                                   generator, device)
        self.conv_w = init_normal((d_conv, d_in), d_conv ** -0.5, dtype,
                                  generator, device)
        self.conv_b = frozen(torch.zeros((d_in,), dtype=dtype, device=device))
        self.x_proj = init_normal((d_in, dt_rank + 2 * n), d_in ** -0.5,
                                  dtype, generator, device)
        self.dt_proj = init_normal((dt_rank, d_in), dt_rank ** -0.5, dtype,
                                   generator, device)
        dt = torch.rand((d_in,), generator=generator, device=device) * 0.1
        self.dt_bias = frozen(torch.log(torch.expm1(dt.clamp(min=1e-3)))
                              .to(dtype))
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        self.a_log = frozen(torch.log(a).expand(d_in, n).contiguous())
        self.d_skip = frozen(torch.ones((d_in,), dtype=torch.float32,
                                        device=device))
        self.out_proj = init_normal((d_in, d), d_in ** -0.5, dtype,
                                    generator, device)


def init_mamba(cfg: ModelConfig, generator, device) -> Mamba:
    return Mamba(cfg, generator, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence. x: ``(B, S, Din)``, w:
    ``(K, Din)``. Returns ``(y, new_state)``, the state holding the
    trailing ``K - 1`` inputs (zeros before the first). One grouped
    ``conv1d`` (the reference sums ``K`` shifted products, a launch each
    here; a decode step of xlstm runs 48 of these)."""
    k, d = w.shape
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, d))
    xpad = torch.cat([state, x], dim=1)
    y = F.conv1d(xpad.transpose(1, 2), w.T[:, None, :], b, groups=d)
    new_state = xpad[:, -(k - 1):] if k > 1 else state
    return y.transpose(1, 2), new_state


def active_positions(stop: torch.Tensor, s: int) -> torch.Tensor:
    """``(B, S)`` bool: position ``t`` of row ``b`` lies before
    ``stop[b]``."""
    return torch.arange(s, device=stop.device)[None, :] < stop[:, None]


def conv_tail(u_raw: torch.Tensor, k: int, stop: torch.Tensor,
              init: torch.Tensor | None = None) -> torch.Tensor:
    """The causal conv's state of each row after it has taken in positions
    ``[0, stop[b])`` of ``u_raw (B, S, Din)`` only: the row's ``k - 1``
    inputs before ``stop[b]``, gathered row by row, with ``init`` (the
    state before position 0; zeros by default) in front of position 0."""
    b, _, d = u_raw.shape
    if init is None:
        init = u_raw.new_zeros((b, k - 1, d))
    padded = torch.cat([init.to(u_raw.dtype), u_raw], dim=1)
    rows = stop.to(device=u_raw.device, dtype=torch.long)[:, None] \
        + torch.arange(k - 1, device=u_raw.device)
    return padded.gather(1, rows[..., None].expand(b, k - 1, d))


def _inner_group(plan):
    """The process group of the inner split, or ``None``."""
    return plan.inner.group if plan is not None and plan.inner else None


def _selective(p: Mamba, u: torch.Tensor, cfg: ModelConfig, group=None):
    """The step sizes ``dt (B, S, Din)`` (softplus, fp32) and the input and
    output projections ``b, c (B, S, N)`` (fp32) of each position (under an
    inner split, ``x_proj``'s partial sums summed over ``group``)."""
    _, n, _, dt_rank = _dims(cfg)
    proj = u @ p.x_proj
    if group is not None:
        proj = C.reduce_both(proj, group)
    dt, b_ssm, c_ssm = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus((dt @ p.dt_proj).float() + p.dt_bias.float())
    return dt, b_ssm.float(), c_ssm.float()


def _discretize(p: Mamba, dt: torch.Tensor, b_ssm: torch.Tensor,
                u: torch.Tensor):
    """``a_bar = exp(dt * A)`` and ``bx = dt * u * B``, each
    ``(B, S, Din, N)`` fp32, for the positions given."""
    a = -torch.exp(p.a_log)
    a_bar = torch.exp(dt[..., None] * a)
    bx = (dt * u.float())[..., None] * b_ssm[..., None, :]
    return a_bar, bx


def _ssm_inputs(p: Mamba, u: torch.Tensor, cfg: ModelConfig, group=None):
    """Selective parameters for each position. u: ``(B, S, Din)`` ->
    ``(a_bar, bx, c)``."""
    dt, b_ssm, c_ssm = _selective(p, u, cfg, group)
    return (*_discretize(p, dt, b_ssm, u), c_ssm)


def _scan_chunk(h0: torch.Tensor, a_bar: torch.Tensor, bx: torch.Tensor):
    """The recurrence over one chunk. h0: ``(B, Din, N)``; a_bar, bx:
    ``(B, C, Din, N)`` -> (every position's state ``(B, C, Din, N)``, the
    last one). With gradients off each state is written in place into one
    buffer (``out=``); autograd refuses ``out=``, so with them on the states
    are collected and stacked."""
    h = h0
    if torch.is_grad_enabled():
        states = []
        for a_t, bx_t in zip(a_bar.unbind(1), bx.unbind(1)):
            h = torch.addcmul(bx_t, a_t, h)
            states.append(h)
        return torch.stack(states, dim=1), h
    h_all = torch.empty_like(bx)
    for a_t, bx_t, out in zip(a_bar.unbind(1), bx.unbind(1),
                              h_all.unbind(1)):
        h = torch.addcmul(bx_t, a_t, h, out=out)
    return h_all, h


def _weight(p: Mamba, leaf: str, plan):
    return getattr(p, leaf) if plan is None else plan.weight(p, leaf)


def _enter(x: torch.Tensor, plan):
    """The block's input on this rank (the module docstring): the whole
    sequence gathered under a sequence split, through ``copy_to`` over the
    inner axes the sequence split does not share (``tensor.Reshard``)."""
    if plan is None:
        return x
    return plan.reshard(plan.inner).enter(x)


def _leave(out: torch.Tensor, plan):
    """The block's output as the residual takes it: the inner ranks'
    partial sums summed, and this rank's block of the sequence where it is
    split (a reduce-scatter over the axes the inner split shares with it,
    a slice over the others)."""
    if plan is None:
        return out
    return plan.reshard(plan.inner).leave(out)


def mamba(p: Mamba, x: torch.Tensor, cfg: ModelConfig, chunk: int = 128,
          return_state: bool = False, plan=None, stop=None):
    """Train/prefill forward. x: ``(B, S, D)`` -> ``(B, S, D)`` [, the
    final ``{"h", "conv"}`` state]. ``S`` must be a multiple of the chunk
    (or at most one chunk), as in the reference. Under a ``plan``, x is
    the residual as the rank holds it (the module docstring).

    ``stop`` (``(B,)`` positions of the whole sequence, or ``None``): row
    ``b``'s state takes in positions ``[0, stop[b])`` only. From
    ``stop[b]`` on its step size is 0, so ``a_bar = 1`` and ``bx = 0`` and
    ``h`` passes through unchanged, and the conv state is the row's
    ``K - 1`` inputs before ``stop[b]`` (``conv_tail``). The outputs at
    those positions are not the model's."""
    x = _enter(x, plan)
    group = _inner_group(plan)
    b, s, _ = x.shape
    n = _dims(cfg)[1]
    u, z = (x @ _weight(p, "in_proj", plan)).chunk(2, dim=-1)
    u_raw = u
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b)
    u = F.silu(u.float()).to(x.dtype)
    dt, b_ssm, c_ssm = _selective(p, u, cfg, group)
    if stop is not None:
        dt = torch.where(active_positions(stop, s)[..., None], dt, 0.0)

    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    h = torch.zeros((b, u.shape[-1], n), dtype=torch.float32,
                    device=x.device)
    ys = []
    for lo in range(0, s, chunk):
        hi = lo + chunk
        a_bar, bx = _discretize(p, dt[:, lo:hi], b_ssm[:, lo:hi],
                                u[:, lo:hi])
        h_all, h = _scan_chunk(h, a_bar, bx)
        del a_bar, bx
        y_c = (h_all @ c_ssm[:, lo:hi, :, None])[..., 0]
        ys.append(y_c + p.d_skip * u[:, lo:hi].float())
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = _leave(y @ _weight(p, "out_proj", plan), plan)
    if return_state:
        k = p.conv_w.shape[0]
        if stop is not None:
            tail = conv_tail(u_raw, k, stop)
        else:
            tail = u_raw[:, -(k - 1):] if k > 1 else conv_state
        return out, {"h": h, "conv": tail.to(conv_state.dtype)}
    return out


# -- Decode --------------------------------------------------------------------


def init_mamba_state(cfg: ModelConfig, batch: int, device,
                     plan=None) -> dict:
    """Zeroed ``{"h" (B, Din, N) fp32, "conv" (B, K - 1, Din)}``; under a
    ``plan`` that splits ``inner``, this rank's ``Din / n`` features."""
    d_in, n, d_conv, _ = _dims(cfg)
    if plan is not None and plan.inner:
        d_in = plan.inner.block(d_in)[1]
    return {
        "h": torch.zeros((batch, d_in, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, d_conv - 1, d_in),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def mamba_step(p: Mamba, state: dict, x: torch.Tensor,
               cfg: ModelConfig, plan=None) -> tuple[torch.Tensor, dict]:
    """One decode step. x: ``(B, 1, D)`` -> ``(out, new state)`` (under a
    ``plan`` that splits ``inner``, the state this rank's block)."""
    if plan is not None and plan.seq:
        raise ValueError("a decode step under a sequence split")
    x = _enter(x, plan)
    u, z = (x @ _weight(p, "in_proj", plan)).chunk(2, dim=-1)
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b, state["conv"])
    u = F.silu(u.float()).to(x.dtype)
    a_bar, bx, c_ssm = _ssm_inputs(p, u, cfg, _inner_group(plan))
    h = a_bar[:, 0] * state["h"] + bx[:, 0]
    y = (h @ c_ssm[:, 0, :, None])[..., 0]
    y = y + p.d_skip * u[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return _leave(y @ _weight(p, "out_proj", plan), plan), \
        {"h": h, "conv": conv_state}
