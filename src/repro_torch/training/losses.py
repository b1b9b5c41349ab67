"""Sequence-chunked cross-entropy fused with the unembedding (the port of
``repro/training/losses.py``).

At large batch and vocabulary the fp32 logits ``(B, S, V)`` must never
exist whole. The sequence is cut into chunks, and each chunk's logits,
log-sum-exp and label term run under a checkpoint: only the chunk's hidden
states and labels are kept for the backward, which computes the chunk's
logits again. So at most one chunk's ``(B, chunk, V)`` fp32 logits (and
their gradient) exist at a time, in the forward and in the backward.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import Embedding

# At most this many rows of fp32 logits (and their gradient) exist at once,
# whatever the batch: at B=32 and a 128,256-word vocabulary, 512 positions
# would be 8.4 GB of logits.
_MAX_LOGIT_ROWS = 2048


def _chunk_terms(hc: torch.Tensor, lc: torch.Tensor, table: torch.Tensor,
                 vocab: int):
    """One chunk ``hc (B, C, D)``, ``lc (B, C)``: the sum of its unmasked
    tokens' ``logsumexp - label logit`` and their count. The padded vocab
    columns read -1e9, as in the reference."""
    logits = (hc @ table).float()
    if table.shape[-1] != vocab:
        pad = torch.arange(table.shape[-1], device=hc.device) >= vocab
        logits = logits.masked_fill(pad, -1e9)
    lse = torch.logsumexp(logits, dim=-1)
    label = logits.gather(-1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((lse - label) * mask).sum(), mask.sum()


def chunked_cross_entropy(embed: Embedding, h: torch.Tensor,
                          labels: torch.Tensor, cfg: ModelConfig,
                          chunk: int = 512, total_count=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``h (B, S, D)`` final hidden states, ``labels (B, S)`` int (-1 =
    masked) -> ``(mean loss, token count)``, both fp32 scalars. The chunk is
    the largest divisor of ``S`` not above ``chunk`` nor above
    ``_MAX_LOGIT_ROWS / B`` (a VLM's text span need not be a multiple of
    512). With ``total_count`` (a data-parallel
    rank's rows of a batch of that many tokens) the sum is divided by it:
    the rank's share of the whole batch's mean."""
    b, s = h.shape[:2]
    table = embed.table.T if embed.unembed is None else embed.unembed
    chunk = min(chunk, max(1, _MAX_LOGIT_ROWS // b), s)
    while s % chunk:
        chunk -= 1
    total = h.new_zeros((), dtype=torch.float32)
    count = h.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, chunk):
        part, n = checkpoint(_chunk_terms, h[:, lo:lo + chunk],
                             labels[:, lo:lo + chunk], table, cfg.vocab_size,
                             use_reentrant=False)
        total = total + part
        count = count + n
    denom = count if total_count is None else torch.as_tensor(
        total_count, dtype=torch.float32, device=h.device)
    return total / denom.clamp(min=1.0), count
