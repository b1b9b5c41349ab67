"""xLSTM blocks [arXiv:2405.04517] (the port of ``repro/models/xlstm.py``):
mLSTM (matrix memory, chunkwise-parallel with stabilized exponential
gating) and sLSTM (scalar memory, a sequential recurrence with
block-diagonal hidden-to-hidden weights).

The mLSTM forward is the reference's chunkwise form: per chunk an
attention-like quadratic product plus the carried ``(C, n, m)`` state,
the stabilizer ``m`` starting at -1e9. The sLSTM runs its recurrence one
position at a time, as the reference's ``lax.scan`` does; its recurrent
weights ``r_gates (4, H, dv, dv)`` are laid out as ``(H, dv, 4 dv)``, so
that each step is one batched product over the heads: with gradients off
from the buffer ``r_step`` (laid out again whenever ``r_gates`` was loaded
or updated in place), with them on once per call, inside the graph. The
reference's ``shard_map`` sLSTM over the batch axes is this scan on each
data-parallel rank's rows, its ``r_gates`` gradient summed by the train
step's all-reduce.

Under a ``TensorPlan`` whose rules split ``inner`` (over ``model``, or
``("data", "model")`` under ``long_500k``), each rank holds block ``i``
of ``n`` of the inner features: of ``up``'s branch ``u`` and gate ``z``
(``convert.shard_params`` keeps block ``i`` of each half), of ``conv_*``,
``norm`` and ``down``'s rows, and the rows of ``wq``, ``wk``, ``wv``,
``w_if`` and ``w_gates`` (their products are partial sums). The value
features ``(H, dv)`` flattened split the same way (``_values``): a rank
holds whole heads, or part of one head's ``dv`` where ``n`` exceeds the
heads.

- mLSTM: ``q``, ``k`` and the gates are summed over the inner ranks
  (``reduce_both``: each rank uses them its own way) and held whole, so
  the normalizer ``n`` and the stabilizer ``m`` are replicated, as in the
  reference; ``v`` is reduce-scattered to the rank's value block, and the
  memory ``C`` and the output are that block's. The head norm's sum of
  squares is summed over the inner ranks where a head's ``dv`` is split.
- sLSTM: the gates' input part is summed over the inner ranks and the
  recurrence runs whole on every rank with ``r_gates`` replicated (the
  reference's ``shard_map`` takes ``gates_x`` with ``P(batch, None,
  None)``); each rank hands only its block of the hidden states to the
  head norm, the ``z`` gate and ``down``. So each rank's ``r_gates``
  gradient is partial (``INNER_PARTIAL``: the train step sums it over
  the inner axes).

``down``'s partial outputs are summed (``reduce_from``); the input enters
through ``copy_to``. An ``inner`` split over the batch's own axes splits
the weights only: every leaf is read through ``TensorPlan.leaves``,
which gathers them whole, and the blocks run as on one rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import NamedTuple

from repro_torch.core.config import ModelConfig, XLSTMConfig
from repro_torch.models.layers import frozen, init_normal
from repro_torch.models.ssm import (
    _causal_conv,
    _enter,
    _leave,
    _leaves,
    active_positions,
    conv_tail,
)
from repro_torch.parallel import collectives as C


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    x = cfg.xlstm or XLSTMConfig()
    d_in = int(x.proj_factor * cfg.d_model)
    h = cfg.num_heads
    qk = int(x.qk_dim_factor * d_in)
    return d_in, h, qk, qk // h, d_in // h      # d_in, H, qk, dk, dv


class Values(NamedTuple):
    """A rank's value features: block ``[lo, lo + n)`` of the flattened
    ``(H, dv)``, that is ``dv`` features of each of heads ``[h0, h0 +
    heads)``; ``group``, the inner split's process group where a head's
    ``dv`` is split over ranks (its norm then sums over them), else
    ``None``."""

    lo: int
    n: int
    h0: int
    heads: int
    dv: int
    group: object

    @property
    def head_slice(self) -> slice:
        return slice(self.h0, self.h0 + self.heads)


def _values(cfg: ModelConfig, plan=None) -> Values:
    """This rank's ``Values`` (all of them without an inner split)."""
    return values_of(cfg, None if plan is None else plan.inner)


def values_of(cfg: ModelConfig, split) -> Values:
    """The ``Values`` of this rank's block of an inner split ``split`` (a
    ``tensor.Split``; all of them where it is ``None`` or one rank)."""
    d_in, h, _, _, dv = _dims(cfg)
    if split is None or not split:
        return Values(0, d_in, 0, h, dv, None)
    lo, n = split.block(d_in)
    if n % dv == 0:
        return Values(lo, n, lo // dv, n // dv, dv, None)
    if dv % n == 0:
        return Values(lo, n, lo // dv, 1, n, split.group)
    raise NotImplementedError(f"an inner block of {n} features over heads "
                              f"of {dv}")


def _headnorm(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
              vals: Values | None = None, dims: tuple[int, int] = (0, 0)
              ) -> torch.Tensor:
    """Per-head RMS norm. h: ``(..., H, dv)``; scale: ``(H*dv,)``. With
    ``vals`` whose head's ``dv`` is split over ranks (``dims``: the heads
    and ``dv`` whole), the head's sum of squares is summed over the inner
    ranks first: every rank puts its own at its head's slot of an
    ``(..., H, 1)`` tensor of zeros, one sum over ``vals.group``."""
    h32 = h.float()
    if vals is None or vals.group is None:
        rms = torch.rsqrt(h32.square().mean(dim=-1, keepdim=True) + eps)
    else:
        heads, dv = dims
        ss = F.pad(h32.square().sum(dim=-1, keepdim=True),
                   (0, 0, vals.h0, heads - vals.h0 - vals.heads))
        total = C.reduce_both(ss, vals.group)[..., vals.head_slice, :]
        rms = torch.rsqrt(total / dv + eps)
    out = (h32 * rms).flatten(-2)
    return (out * scale.float()).to(scale.dtype)


def _up_conv(p, x: torch.Tensor, conv_state=None, plan=None):
    """The shared front of both blocks: the up projection split into the
    branch ``u`` and the gate ``z``, and ``silu`` of the causal conv of
    ``u``. Returns ``(u, z, conv, new conv state)``."""
    p = _leaves(p, plan)
    u, z = (x @ p.up).chunk(2, dim=-1)
    c, conv_state = _causal_conv(u, p.conv_w, p.conv_b, conv_state)
    return u, z, F.silu(c.float()).to(x.dtype), conv_state


def _down(p, hid: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
          plan=None) -> torch.Tensor:
    """Head norm of ``hid (B, S, heads, dv)``, the ``silu(z)`` gate and the
    down projection (under a ``plan``, the rank's value block's, the
    partial outputs summed)."""
    vals = _values(cfg, plan)
    _, heads, _, _, dv = _dims(cfg)
    p = _leaves(p, plan)
    y = _headnorm(hid, p.norm, vals=vals, dims=(heads, dv))
    y = y * F.silu(z.float()).to(y.dtype)
    return _leave(y @ p.down, plan)


def _summed(part: torch.Tensor, group, bias=None) -> torch.Tensor:
    """Partial sums over the inner ranks summed (plus ``bias``, which
    every rank adds alike), for each rank to use its own way."""
    if group is None:
        return part if bias is None else part + bias
    total = C.reduce_from(part, group)
    return C.copy_to(total if bias is None else total + bias, group)


# =========================== mLSTM =============================================


class MLSTM(nn.Module):
    """The reference's ``init_mlstm`` leaves: ``up (d, 2 d_in)``,
    ``conv_w (K, d_in)``, ``conv_b``, ``wq``/``wk (d_in, qk)``,
    ``wv (d_in, d_in)``, ``norm``, ``down (d_in, d)`` in the config's
    dtype, and the gates ``w_if (d_in, 2H)`` and ``b_if`` (forget biases
    3..6) in fp32."""

    AXES = {"up": ("w_embed", "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "wq": ("inner", None),
            "wk": ("inner", None), "wv": ("inner", "inner"),
            "w_if": ("inner", None), "b_if": (None,), "norm": ("inner",),
            "down": ("inner", "w_embed")}
    SPLIT_HALVES = ("up",)          # u and z: convert.shard_params
    # leaves the inner split leaves whole whose gradient every inner rank
    # has whole: the bias joins the gates after their sum (``_summed``)
    INNER_WHOLE = ("b_if",)

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d = cfg.d_model
        d_in, h, qk, _, _ = _dims(cfg)
        x = cfg.xlstm or XLSTMConfig()
        dtype = getattr(torch, cfg.dtype)
        self.up = init_normal((d, 2 * d_in), d ** -0.5, dtype, generator,
                              device)
        self.conv_w = init_normal((x.conv_kernel, d_in), 0.3, dtype,
                                  generator, device)
        self.conv_b = frozen(torch.zeros((d_in,), dtype=dtype, device=device))
        self.wq = init_normal((d_in, qk), d_in ** -0.5, dtype, generator,
                              device)
        self.wk = init_normal((d_in, qk), d_in ** -0.5, dtype, generator,
                              device)
        self.wv = init_normal((d_in, d_in), d_in ** -0.5, dtype, generator,
                              device)
        self.w_if = init_normal((d_in, 2 * h), d_in ** -0.5, torch.float32,
                                generator, device)
        self.b_if = frozen(torch.cat([
            torch.zeros((h,), device=device),
            torch.linspace(3.0, 6.0, h, device=device)]))
        self.norm = frozen(torch.ones((d_in,), dtype=dtype, device=device))
        self.down = init_normal((d_in, d), d_in ** -0.5, dtype, generator,
                                device)


def init_mlstm(cfg: ModelConfig, generator, device) -> MLSTM:
    return MLSTM(cfg, generator, device)


# the input gate's log at a position a row's state does not take in: a
# large finite "keep" (-inf would make NaN of the chunk's cummax and exp)
KEEP_LOG_I = -1e30


def _mlstm_qkv_gates(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                     conv_state=None, plan=None, stop=None):
    """Shared pre-processing. x: ``(B, S, D)`` -> q, k ``(B, S, H, dk)``
    (k scaled by ``dk ** -0.5``), v ``(B, S, heads, dv)`` (the rank's value
    block, ``_values``), log_i, log_f ``(B, S, H)`` fp32, z, and the conv
    state. With ``stop`` (``mlstm``), the gates keep the state from each
    row's ``stop`` on (``log_i = KEEP_LOG_I``, ``log_f = 0``) and the conv
    state is the row's inputs before it (``conv_tail``)."""
    _, h, _, dk, _ = _dims(cfg)
    vals = _values(cfg, plan)
    group = plan.inner.group if plan is not None and plan.inner else None
    x = _enter(x, plan)
    p = _leaves(p, plan)
    b, s, _ = x.shape
    u, z, c, conv_new = _up_conv(p, x, conv_state, plan)
    q = _summed(c @ p.wq, group).view(b, s, h, dk)
    k = _summed(c @ p.wk, group).view(b, s, h, dk)
    v = u @ p.wv
    if group is not None:
        v = C.reduce_scatter_along(v, -1, group)
    v = v.view(b, s, vals.heads, vals.dv)
    gates = _summed(c.float() @ p.w_if, group, p.b_if)
    log_i, raw_f = gates.view(b, s, 2, h).unbind(2)
    log_f = F.logsigmoid(raw_f)
    if stop is not None:
        active = active_positions(stop, s)[..., None]
        log_i = torch.where(active, log_i, KEEP_LOG_I)
        log_f = torch.where(active, log_f, 0.0)
        conv_new = conv_tail(u, p.conv_w.shape[0], stop, conv_state)
    return q, k * dk ** -0.5, v, log_i, log_f, z, conv_new


def mlstm(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, chunk: int = 256,
          return_state: bool = False, plan=None, stop=None):
    """Chunkwise-parallel mLSTM forward. x: ``(B, S, D)`` -> ``(B, S, D)``
    [, the final ``{"c", "n", "m", "conv"}`` state]. ``S`` must be a
    multiple of the chunk (or at most one chunk), as in the reference.
    Under a ``plan`` that splits ``inner``, ``C`` and the output are the
    rank's value block's (``hs``: its heads), ``n`` and ``m`` whole.

    ``stop`` (``(B,)`` positions of the whole sequence, or ``None``): row
    ``b``'s state takes in positions ``[0, stop[b])`` only. From there on
    the input gate is "keep" and the forget gate 1 (``log_f = 0``), so
    ``C``, ``n`` and the stabilizer ``m`` carry through unchanged; the
    outputs at those positions are not the model's."""
    _, h, _, dk, _ = _dims(cfg)
    vals = _values(cfg, plan)
    hs = vals.head_slice
    q, k, v, log_i, log_f, z, conv_last = _mlstm_qkv_gates(
        p, x, cfg, plan=plan, stop=stop)
    b, s = q.shape[:2]

    chunk = min(chunk, s)
    assert s % chunk == 0
    dev = x.device
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=dev).tril()
    c_mat = torch.zeros((b, vals.heads, dk, vals.dv), dtype=torch.float32,
                        device=dev)
    n_vec = torch.zeros((b, h, dk), dtype=torch.float32, device=dev)
    m = torch.full((b, h), -1e9, dtype=torch.float32, device=dev)
    outs = []
    for lo in range(0, s, chunk):
        hi = lo + chunk
        lic = log_i[:, lo:hi].transpose(1, 2)          # (B,H,C)
        f_cum = log_f[:, lo:hi].transpose(1, 2).cumsum(dim=-1)   # F_t
        g = lic - f_cum                                # g_s = li_s - F_s
        mx = torch.maximum(m[..., None], g.cummax(dim=-1).values)
        m_t = f_cum + mx                   # the stabilizer at each position
        alpha = torch.exp(m[..., None] - mx)           # inter-chunk scale
        w = torch.exp(g[:, :, None, :] - mx[..., None])    # (B,H,t,s)
        w = torch.where(causal, w, 0.0)

        qf = q[:, lo:hi].transpose(1, 2).float()       # (B,H,C,dk)
        kf = k[:, lo:hi].transpose(1, 2).float()
        vf = v[:, lo:hi].transpose(1, 2).float()       # (B,heads,C,dv)
        qh, kh = qf[:, hs], kf[:, hs]
        scores = (qh @ kh.transpose(-1, -2)) * w[:, hs]
        num = scores @ vf + alpha[:, hs, :, None] * (qh @ c_mat)
        n_t = w @ kf + alpha[..., None] * n_vec[:, :, None]
        den = torch.maximum((qf * n_t).sum(dim=-1).abs(), torch.exp(-m_t))
        outs.append((num / den[:, hs, :, None]).transpose(1, 2))

        # the carry at the chunk's end
        w_last = torch.exp(g - mx[..., -1:])           # (B,H,C)
        c_mat = alpha[:, hs, -1, None, None] * c_mat \
            + (kh * w_last[:, hs, :, None]).transpose(-1, -2) @ vf
        n_vec = n_t[:, :, -1]
        m = m_t[..., -1]
    h_all = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    out = _down(p, h_all, z, cfg, plan)
    if return_state:
        return out, {"c": c_mat, "n": n_vec, "m": m, "conv": conv_last}
    return out


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     plan=None) -> dict:
    """Zeroed ``{c (B, H, dk, dv), n (B, H, dk), m (B, H) fp32, conv}``;
    under a ``plan`` that splits ``inner``, ``c`` of the rank's value
    block and ``conv`` of its inner features."""
    d_in, h, _, dk, _ = _dims(cfg)
    vals = _values(cfg, plan)
    x = cfg.xlstm or XLSTMConfig()
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, vals.heads, dk, vals.dv), **f32),
        "n": torch.zeros((batch, h, dk), **f32),
        "m": torch.full((batch, h), -1e9, **f32),
        "conv": torch.zeros((batch, x.conv_kernel - 1, vals.n),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def mlstm_step(p: MLSTM, state: dict, x: torch.Tensor,
               cfg: ModelConfig, plan=None) -> tuple[torch.Tensor, dict]:
    """One decode step. x: ``(B, 1, D)`` -> ``(out, new state)``."""
    hs = _values(cfg, plan).head_slice
    q, k, v, log_i, log_f, z, conv_state = _mlstm_qkv_gates(
        p, x, cfg, state["conv"], plan)
    qf = q[:, 0].float()                   # (B,H,dk)
    kf = k[:, 0].float()
    vf = v[:, 0].float()                   # (B,heads,dv)
    li, lf = log_i[:, 0], log_f[:, 0]      # (B,H)

    m_new = torch.maximum(lf + state["m"], li)
    f_sc = torch.exp(lf + state["m"] - m_new)
    i_sc = torch.exp(li - m_new)
    c_new = f_sc[:, hs, None, None] * state["c"] \
        + i_sc[:, hs, None, None] * kf[:, hs, :, None] * vf[..., None, :]
    n_new = f_sc[..., None] * state["n"] + i_sc[..., None] * kf
    num = (qf[:, hs, None, :] @ c_new)[..., 0, :]
    den = torch.maximum((qf * n_new).sum(dim=-1).abs(), torch.exp(-m_new))
    h_out = (num / den[:, hs, None])[:, None]        # (B,1,heads,dv)
    return _down(p, h_out, z, cfg, plan), {"c": c_new, "n": n_new,
                                           "m": m_new, "conv": conv_state}


# =========================== sLSTM =============================================


def _step_layout(r_gates: torch.Tensor) -> torch.Tensor:
    """``r_gates (4, H, dv, dv)`` as ``(H, dv, 4 dv)``: column ``g*dv + w``
    of head ``h`` is ``r_gates[g, h, :, w]``."""
    g, h, dv, _ = r_gates.shape
    return r_gates.permute(1, 2, 0, 3).reshape(h, dv, g * dv).contiguous()


class SLSTM(nn.Module):
    """The reference's ``init_slstm`` leaves: ``up (d, 2 d_in)``,
    ``conv_w``, ``conv_b``, ``w_gates (d_in, 4 d_in)`` (z, i, f, o),
    ``norm``, ``down`` in the config's dtype, and ``r_gates (4, H, dv, dv)``
    and ``b_gates`` (forget bias 3) in fp32. The buffer ``r_step`` holds
    ``r_gates`` in the step's layout for the no-grad path; it is made again
    whenever ``r_gates`` is loaded, or has been written in place (its
    version counter moved) since the last layout."""

    AXES = {"up": ("w_embed", "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "w_gates": ("inner", "inner"),
            "r_gates": (None, None, None, None), "b_gates": (None,),
            "norm": ("inner",), "down": ("inner", "w_embed")}
    SPLIT_HALVES = ("up",)          # u and z: convert.shard_params
    # leaves the inner split leaves whole whose gradient each inner rank
    # only partly computes (``TensorPlan.grad_sync_axes``)
    INNER_PARTIAL = ("r_gates",)
    INNER_WHOLE = ("b_gates",)      # as the mLSTM's ``b_if``

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, _, dv = _dims(cfg)
        x = cfg.xlstm or XLSTMConfig()
        dtype = getattr(torch, cfg.dtype)
        self.up = init_normal((d, 2 * d_in), d ** -0.5, dtype, generator,
                              device)
        self.conv_w = init_normal((x.conv_kernel, d_in), 0.3, dtype,
                                  generator, device)
        self.conv_b = frozen(torch.zeros((d_in,), dtype=dtype, device=device))
        self.w_gates = init_normal((d_in, 4 * d_in), d_in ** -0.5, dtype,
                                   generator, device)
        self.r_gates = init_normal((4, h, dv, dv), dv ** -0.5, torch.float32,
                                   generator, device)
        self.b_gates = frozen(torch.cat([
            torch.zeros((2 * d_in,), device=device),          # z, i
            torch.full((d_in,), 3.0, device=device),          # f bias
            torch.zeros((d_in,), device=device)]))            # o
        self.norm = frozen(torch.ones((d_in,), dtype=dtype, device=device))
        self.down = init_normal((d_in, d), d_in ** -0.5, dtype, generator,
                                device)
        self.register_buffer("r_step", None, persistent=False)
        SLSTM._relayout(self)
        self.register_load_state_dict_post_hook(SLSTM._relayout)

    @staticmethod
    def _relayout(module: "SLSTM", incompatible_keys=None) -> None:
        with torch.no_grad():
            module.r_step = _step_layout(module.r_gates)
        module._r_version = (id(module.r_gates), module.r_gates._version)

    def step_weights(self) -> torch.Tensor:
        """``r_gates`` in the step's layout: laid out inside the graph when
        gradients are on (so they reach ``r_gates``), else the buffer, laid
        out again if ``r_gates`` changed since."""
        if torch.is_grad_enabled():
            return _step_layout(self.r_gates)
        if self._r_version != (id(self.r_gates), self.r_gates._version):
            SLSTM._relayout(self)
        return self.r_step


def init_slstm(cfg: ModelConfig, generator, device) -> SLSTM:
    return SLSTM(cfg, generator, device)


def _slstm_scan(p: SLSTM, gates_x: torch.Tensor, h: int, dv: int,
                state: dict, stop=None):
    """The recurrence over ``gates_x (B, S, 4 d_in)``, the input's part of
    the gates (fp32), from ``state``. Returns the hidden states
    ``(B, S, d_in)`` and the final ``(c, n, h, m)``, each ``(B, d_in)``.
    With ``stop`` (``(B,)``), row ``b`` keeps its previous ``(c, n, h, m)``
    at every position from ``stop[b]`` on (``torch.where`` after the
    step's arithmetic, which is left as it is).

    Inside the loop every tensor is laid out head-major, ``(H, B, dv)``, so
    that the step's recurrent product is one ``baddbmm`` of the heads'
    ``(B, dv) @ (dv, 4 dv)`` onto the input's gates."""
    b, s, _ = gates_x.shape

    def heads(t):                          # (B, d_in) -> (H, B, dv)
        return t.view(b, h, dv).transpose(0, 1)

    gx = gates_x.float().view(b, s, 4, h, dv).permute(1, 3, 0, 2, 4) \
        .reshape(s, h, b, 4 * dv)          # [t, h, b, g*dv + w]
    c, n, hid, m = (heads(state[k]) for k in ("c", "n", "h", "m"))
    r_step = p.step_weights()
    grad = torch.is_grad_enabled()
    # each position's rows that take it in, as (1, B, 1) against (H, B, dv)
    keep = None if stop is None \
        else active_positions(stop, s).T[:, None, :, None]
    # autograd refuses ``out=``: with gradients on the states are stacked
    hs = [] if grad else gx.new_empty((s, h, b, dv))
    for t, gx_t in enumerate(gx.unbind(0)):
        pre = torch.baddbmm(gx_t, hid, r_step).view(h, b, 4, dv)
        zt, li, ft, ot = pre.unbind(2)
        lfm = F.logsigmoid(ft) + m
        m_new = torch.maximum(lfm, li)
        i_sc = torch.exp(li - m_new)
        f_sc = torch.exp(lfm - m_new)
        c_new = torch.addcmul(i_sc * torch.tanh(zt), f_sc, c)
        n_new = torch.maximum(torch.addcmul(i_sc, f_sc, n),
                              torch.exp(-m_new))
        if grad:
            h_new = torch.sigmoid(ot) * (c_new / n_new)
            hs.append(h_new)
        else:
            h_new = torch.mul(torch.sigmoid(ot), c_new / n_new, out=hs[t])
        if keep is None:
            c, n, hid, m = c_new, n_new, h_new, m_new
        else:
            c, n, hid, m = (torch.where(keep[t], new, old) for new, old in (
                (c_new, c), (n_new, n), (h_new, hid), (m_new, m)))

    def flat(t):                           # (H, B, dv) -> (B, d_in)
        return t.transpose(0, 1).reshape(b, h * dv)

    if grad:
        hs = torch.stack(hs)
    hs = hs.permute(2, 0, 1, 3).reshape(b, s, h * dv)
    return hs, tuple(flat(t) for t in (c, n, hid, m))


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     plan=None) -> dict:
    """Zeroed ``{c, n (ones), h, m (B, d_in) fp32, conv}``: the recurrence
    runs whole on every rank, so only ``conv`` is the rank's inner block
    under a ``plan`` that splits ``inner``."""
    d_in = _dims(cfg)[0]
    n_conv = _values(cfg, plan).n
    x = cfg.xlstm or XLSTMConfig()
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d_in), **f32),
        "n": torch.ones((batch, d_in), **f32),
        "h": torch.zeros((batch, d_in), **f32),
        "m": torch.zeros((batch, d_in), **f32),
        "conv": torch.zeros((batch, x.conv_kernel - 1, n_conv),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def _slstm_core(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, state: dict,
                plan=None, stop=None):
    _, h, _, _, dv = _dims(cfg)
    vals = _values(cfg, plan)
    group = plan.inner.group if plan is not None and plan.inner else None
    x = _enter(x, plan)
    p = _leaves(p, plan)
    u, z, c, conv_state = _up_conv(p, x, state["conv"], plan)
    if stop is not None:
        conv_state = conv_tail(u, p.conv_w.shape[0], stop, state["conv"])
    if group is None:
        gates_x = (c @ p.w_gates).float() + p.b_gates
    else:
        gates_x = _summed((c @ p.w_gates).float(), group, p.b_gates)
    hs, carry = _slstm_scan(p, gates_x, h, dv, state, stop)
    new_state = dict(zip(("c", "n", "h", "m"), carry), conv=conv_state)
    mine = hs[..., vals.lo:vals.lo + vals.n]
    out = _down(p, mine.view(*hs.shape[:2], vals.heads, vals.dv)
                .to(x.dtype), z, cfg, plan)
    return out, new_state


def slstm(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, chunk: int = 0,
          return_state: bool = False, plan=None, stop=None):
    """sLSTM forward from the initial state. x: ``(B, S, D)``; ``chunk``
    is taken and ignored, as in the reference. ``stop`` (``(B,)``, or
    ``None``): row ``b``'s state takes in positions ``[0, stop[b])`` only
    and is kept from there on (``_slstm_scan``); its conv state is the
    row's inputs before ``stop[b]``."""
    out, state = _slstm_core(p, x, cfg, init_slstm_state(
        cfg, x.shape[0], x.device, plan), plan, stop)
    return (out, state) if return_state else out


def slstm_step(p: SLSTM, state: dict, x: torch.Tensor,
               cfg: ModelConfig, plan=None) -> tuple[torch.Tensor, dict]:
    """One decode step. x: ``(B, 1, D)`` -> ``(out, new state)``."""
    return _slstm_core(p, x, cfg, state, plan)
