"""Sequence-chunked cross-entropy fused with the unembedding (the port of
``repro/training/losses.py``).

At large batch and vocabulary the fp32 logits ``(B, S, V)`` must never
exist whole. The sequence is cut into chunks, and each chunk's logits,
log-sum-exp and label term run under a checkpoint: only the chunk's hidden
states and labels are kept for the backward, which computes the chunk's
logits again. So at most one chunk's ``(B, chunk, V)`` fp32 logits (and
their gradient) exist at a time, in the forward and in the backward.

Under a ``TensorPlan`` that splits the vocab the loss is vocab-parallel:
each rank computes its vocab columns' logits of the chunk, the rows' max
and sum of exponentials are reduced over the vocab ranks, and each label's
logit comes from the rank that owns it (a sum over the ranks of the logit
or 0). The full logits are never gathered; the hidden states enter
replicated over the vocab ranks (``vocab_input``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import Embedding, unembed_table
from repro_torch.parallel import collectives as C

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


def _chunk_terms_vocab_parallel(hc: torch.Tensor, lc: torch.Tensor,
                                table: torch.Tensor, vocab: int, lo: int,
                                group):
    """``_chunk_terms`` with ``table`` this rank's vocab columns
    ``[lo, lo + V_local)``: the max and the sum of exponentials of each
    row over the whole vocab, and the label's logit, are reduced over
    ``group``; every rank returns the same terms."""
    logits = (hc @ table).float()
    n = table.shape[-1]
    cols = torch.arange(lo, lo + n, device=hc.device)
    logits = logits.masked_fill(cols >= vocab, -1e9)
    with torch.no_grad():
        m = C.all_reduce_(logits.amax(dim=-1), group,
                          dist.ReduceOp.MAX)
    sumexp = C.reduce_from((logits - m[..., None]).exp().sum(dim=-1), group)
    lse = m + sumexp.log()
    local = lc.long() - lo
    own = ((local >= 0) & (local < n)).float()
    label = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    label = C.reduce_from(label * own, group)
    mask = (lc >= 0).float()
    return ((lse - label) * mask).sum(), mask.sum()


def vocab_input(h: torch.Tensor, plan) -> torch.Tensor:
    """The final hidden states as the vocab-parallel loss takes them
    (``tensor.Reshard.enter`` of the vocab split, position by position):
    gathered along the sequence over the axes the vocab split shares with
    a sequence split (its gradient summed over the ranks and split back),
    and entering the vocab ranks' columns through ``copy_to`` over the
    others. Where the
    sequence is split over axes the vocab is not, each rank keeps the
    positions of its block of them (``vocab_labels``), and the loss sums
    over those ranks (``chunked_cross_entropy``)."""
    if plan is None:
        return h
    return plan.reshard(plan.vocab).enter(h, local=True)


def whole_sequence(plan) -> bool:
    """Whether ``vocab_input`` gives every position of the sequence."""
    return plan is None or not plan.reshard(plan.vocab).alone


def vocab_labels(labels: torch.Tensor, plan) -> torch.Tensor:
    """``(B, S)`` labels of the positions ``vocab_input`` gives."""
    if whole_sequence(plan):
        return labels
    shared = plan.reshard(plan.vocab).shared
    local = plan.seq_block(labels)
    return C.gather_dim(local.contiguous(), 1, shared.group) if shared \
        else local


def chunked_cross_entropy(embed: Embedding, h: torch.Tensor,
                          labels: torch.Tensor, cfg: ModelConfig,
                          chunk: int = 512, total_count=None, plan=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``h (B, S, D)`` final hidden states, ``labels (B, S)`` int (-1 =
    masked) -> ``(mean loss, token count)``, both fp32 scalars. The chunk is
    the largest divisor of ``S`` not above ``chunk`` nor above
    ``_MAX_LOGIT_ROWS / B`` (a VLM's text span need not be a multiple of
    512). With ``total_count`` (a data-parallel
    rank's rows of a batch of that many tokens) the sum is divided by it:
    the rank's share of the whole batch's mean. Under a ``plan`` ``h`` is
    ``vocab_input``'s, ``labels`` ``vocab_labels``', the loss
    vocab-parallel where the plan splits the vocab, and the sum and count
    summed over the sequence's axes the vocab split leaves out (the sum
    with ``replicated_sum``: every rank then has the same loss)."""
    b, s = h.shape[:2]
    table = unembed_table(embed, plan)
    terms, extra = _chunk_terms, ()
    if plan is not None and plan.vocab:
        v_lo = plan.vocab.block(table.shape[-1] * plan.vocab.n)[0]
        terms = _chunk_terms_vocab_parallel
        extra = (v_lo, plan.vocab.group)
    chunk = min(chunk, max(1, _MAX_LOGIT_ROWS // b), s)
    while s % chunk:
        chunk -= 1
    total = h.new_zeros((), dtype=torch.float32)
    count = h.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, chunk):
        part, n = checkpoint(terms, h[:, lo:lo + chunk],
                             labels[:, lo:lo + chunk], table, cfg.vocab_size,
                             *extra, use_reentrant=False)
        total = total + part
        count = count + n
    if not whole_sequence(plan):
        group = plan.reshard(plan.vocab).alone.group
        total = C.replicated_sum(total, group)
        count = C.all_reduce_(count.detach().clone(), group)
    denom = count if total_count is None else torch.as_tensor(
        total_count, dtype=torch.float32, device=h.device)
    return total / denom.clamp(min=1.0), count
