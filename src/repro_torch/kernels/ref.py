"""Plain PyTorch versions of the port's kernels (the contracts).

Each function computes what its CUDA kernel computes: the partition kernels
of ``partition.cu`` exactly, the attention kernels of
``flash_attention.cu``, ``flash_attention_bwd.cu`` and
``decode_attention.cu`` within the tolerance of their dtype (the kernels
keep the probabilities in fp32, these cast them to the value dtype before
the PV product, as the reference's oracles do; K4b's is fp32 throughout).
The kernel wrappers (``repro_torch.kernels.partition`` and ``.attention``)
take these for CPU tensors only; ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""

from __future__ import annotations

import torch


def partition_histogram_ref(part_ids: torch.Tensor,
                            num_partitions: int) -> torch.Tensor:
    """K1: ``(N,)`` int32 ids -> ``(P,)`` int32 counts."""
    return torch.bincount(part_ids, minlength=num_partitions)[
        :num_partitions].to(torch.int32)


def partition_scatter_ref(rows: torch.Tensor, part_ids: torch.Tensor,
                          num_partitions: int):
    """K2: stable grouping of ``(N, D)`` rows by partition id.

    Returns ``(out_rows (N, D), offsets (P,) int32)`` where
    ``out_rows[offsets[p] : offsets[p] + counts[p]]`` are partition ``p``'s
    rows in original order.
    """
    order = torch.argsort(part_ids, stable=True)
    counts = partition_histogram_ref(part_ids, num_partitions)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return rows[order], offsets


# rows of the probe side per one-hot block: keeps the (rows, M) match
# matrix of the plain probe near 64 MB at the largest gated build side
_PROBE_CHUNK_ELEMS = 1 << 24


def fused_probe_ref(probe_keys, v0, v1, build_keys, build_cat, build_valid,
                    num_groups: int):
    """K3: one-hot equality probe of every probe key against the whole
    build side, masked by ``build_valid``. Returns ``(group, weight)``:
    ``cat % G`` and ``v0 * v1`` of the matching build row, or 0 and 0.0
    where no valid build row matches."""
    n, m = probe_keys.shape[0], build_keys.shape[0]
    step = max(1, _PROBE_CHUNK_ELEMS // max(1, m))
    valid = build_valid != 0
    groups, weights = [], []
    for lo in range(0, n, step):
        pk = probe_keys[lo:lo + step]
        mi = ((pk[:, None] == build_keys[None, :])
              & valid[None, :]).to(torch.int32)
        found = mi.sum(dim=1) > 0
        cat = (mi * build_cat[None, :]).sum(dim=1).to(torch.int32)
        groups.append(cat % num_groups)
        weights.append(torch.where(found, v0[lo:lo + step] * v1[lo:lo + step],
                                   torch.zeros((), dtype=torch.float32,
                                               device=v0.device)))
    if not groups:
        return (torch.zeros((0,), dtype=torch.int32, device=probe_keys.device),
                torch.zeros((0,), dtype=torch.float32, device=v0.device))
    return torch.cat(groups), torch.cat(weights)


# -- attention -------------------------------------------------------------------


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """K4: q ``(B, S, H, hd)``, k, v ``(B, S, K, hd)`` with H divisible by
    K -> ``(B, S, H, hd)`` in q's dtype; fp32 scores and softmax. KV is
    expanded here as the reference expands it (``jnp.repeat(k, H // K,
    axis=2)``: each kv head ``H // K`` times in a row)."""
    s, hd = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshk->bqhk", probs.to(v.dtype), v)
    return out.to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            causal: bool = True) -> torch.Tensor:
    """What K4 writes beside its output when asked (K4b reads it): each
    query row's natural log-sum-exp of its scaled scores, masked above the
    diagonal when causal, ``(B, H, S)`` fp32. ``v`` is not read; it is
    taken so that the call matches ``flash_attention_ref``'s."""
    hd = q.shape[3]
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            d_out: torch.Tensor, causal: bool = True):
    """K4b: the gradient of ``flash_attention_ref`` by the explicit formula,
    in fp32: with ``P = softmax(Q K^T * scale)`` (masked above the diagonal
    when causal) and ``delta = rowsum(d_out * out)``, ``dS = P * (d_out
    V^T - delta)``, ``dq = dS K * scale``, ``dk = dS^T Q * scale`` and
    ``dv = P^T d_out``, dk and dv summed over each kv head's ``H // K``
    query heads. Returns ``(dq, dk, dv)`` in q's dtype."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qf, of, gf = q.float(), out.float(), d_out.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scale = hd ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", qf, kf) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    dp = torch.einsum("bqhd,bshd->bhqs", gf, vf)
    delta = (gf * of).sum(dim=-1).transpose(1, 2)          # (B, H, S)
    ds = probs * (dp - delta[..., None])
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqs,bqhd->bshd", ds, qf) * scale
    dv = torch.einsum("bhqs,bqhd->bshd", probs, gf)
    dk = dk.view(b, s, kh, g, hd).sum(dim=3)
    dv = dv.view(b, s, kh, g, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    """K5: q ``(B, H, hd)``, caches ``(B, S, K, hd)``, length ``(B,)`` valid
    prefix sizes -> ``(B, H, hd)`` in q's dtype. GQA: H = K * G, and query
    head i attends through kv head i // G. A length of 0 gives zeros, as
    the reference's kernel does (its sum is clamped to 1e-30)."""
    hd = q.shape[2]
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = q.shape[1] // kh
    k_exp = k_cache.repeat_interleave(g, dim=2)          # (B, S, H, hd)
    v_exp = v_cache.repeat_interleave(g, dim=2)
    scores = torch.einsum("bhk,bshk->bhs", q.float(), k_exp.float())
    scores = scores * (hd ** -0.5)
    valid = torch.arange(s, device=q.device)[None, :] \
        < length.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).masked_fill(~valid[:, None, :], 0.)
    out = torch.einsum("bhs,bshk->bhk", probs.to(v_exp.dtype), v_exp)
    return out.to(q.dtype)
