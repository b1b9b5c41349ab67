"""How a rank runs the model under sharding rules that split more than the
batch: tensor parallelism (``heads``, ``kv_heads``, ``mlp`` and
``vocab``), the sequence-sharded residual (``seq``, with ``mlp_seq``),
the sequence-sharded decode cache (``cache_seq``, over ``model`` or
``("data", "model")``), ZeRO-3 (``w_embed`` over ``data`` or the whole
mesh), expert parallelism (``expert``, with the MoE plane ``moe_impl`` or
``expert_act`` picks, and the experts' ``d_expert`` split by ``mlp``
where ``expert`` is not: ``models/moe.py``) and the Mamba / xLSTM inner
split (``inner``: ``models/ssm.py``, ``models/xlstm.py``), each over any
mesh axes but the batch's.

The reference names each tensor's logical axes and lets GSPMD place the
collectives. Here ``TensorPlan`` resolves the rules once, outside any
checkpointed layer (the autograd engine's device thread, which recomputes
such a layer on CUDA, does not see ``use_rules``), and the model's code
asks it for the process groups and for its weights:

- ``weight(module, leaf)`` is this rank's shard of a parameter with its
  ``w_embed`` dimension gathered (``collectives.gather_along``: the
  gradient is reduce-scattered back to the shard), or the copy gathered
  once a step under ``zero2`` with ``regather`` (``gathered``);
- ``reshard(split)`` (``Reshard``) is how a block split over some axes
  meets a residual split along the sequence over others: the sequence
  gathered where the block needs it, the block's partial sums summed and
  cut back to the rank's positions;
- ``grad_sync_axes(name)`` names the mesh axes over which a leaf's
  gradient is still a partial sum after the backward: the batch axes and
  the sequence axes it is not sharded over (each rank saw only its rows
  and, under a block that does not split the sequence's axes, its
  positions), or, under a head split, the head axes for the kv
  projections the kv split does not cut (each rank used only its query
  heads' kv heads), and, under a kv split alone, the kv axes for the
  query-head leaves (each rank computes the query heads of its kv heads),
  or, where a recurrent block's ``inner`` is split, the inner axes for the
  block's leaves that the split does not cut and whose gradient each inner
  rank only partly computes (``partial``: the sLSTM's replicated
  ``r_gates``, whose recurrence each rank runs whole but feeds back only
  its own slice), and not the inner axes for those each inner rank has
  whole (``whole``: the gates' biases). A leaf sharded over ``expert`` is
  not summed over ``model``: the all-to-all's backward brings each rank
  every source's gradient of its experts (under either all-to-all plane;
  the ``gather`` plane's ranks see every token).

A rank holds a parameter's shard as ``ShardingRules.spec`` cuts it
(``repro_torch.models.convert.shard_params``): a dimension split over
mesh axes ``A`` keeps block ``mesh.axes_index(A)`` of ``prod(|A|)``
equal blocks.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (
    _FLAGS,
    ShardingRules,
    require_executable,
)


def _axes(part) -> tuple[str, ...]:
    """A ``spec`` entry as a tuple of mesh axes."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


class Split:
    """One logical axis split over mesh axes: ``axes`` (mesh order), ``n``
    ranks, this rank's ``index`` and the ``group`` (``None`` when
    ``n == 1``)."""

    def __init__(self, mesh, axes: tuple[str, ...]):
        self.axes = tuple(a for a in mesh.axis_names
                          if a in axes and int(mesh.shape[a]) > 1)
        self.n = math.prod(int(mesh.shape[a]) for a in self.axes)
        self.index = mesh.axes_index(self.axes) if self.n > 1 else 0
        self.group = mesh.group(self.axes) if self.n > 1 else None
        if self.group is not None and dist.get_rank(self.group) != self.index:
            raise RuntimeError(f"group rank {dist.get_rank(self.group)} is not "
                               f"the mesh index {self.index} along "
                               f"{self.axes}")

    def __bool__(self) -> bool:
        return self.n > 1

    def block(self, size: int) -> tuple[int, int]:
        """``(lo, length)`` of this rank's block of ``size``."""
        if size % self.n:
            raise ValueError(f"{size} does not split over {self.n} ranks of "
                             f"{self.axes}")
        step = size // self.n
        return self.index * step, step


def _split(rules: ShardingRules, logical: str) -> Split:
    return Split(rules.mesh, _axes(rules.rules.get(logical)))


class TensorPlan:
    """The rules of one step resolved for this rank (see the module
    docstring). ``gathered`` maps a parameter's id to its full copy under
    ``zero2`` with ``regather``."""

    def __init__(self, rules: ShardingRules):
        require_executable(rules)
        self.rules = rules
        self.mesh = rules.mesh
        r = rules.rules
        self.batch = _split(rules, "batch")
        self.seq = _split(rules, "seq")
        self.heads = _split(rules, "heads")
        self.kv_heads = _split(rules, "kv_heads")
        self.mlp = _split(rules, "mlp")
        self.vocab = _split(rules, "vocab")
        self.cache = _split(rules, "cache_seq")
        self.expert = _split(rules, "expert")
        self.expert_act = _split(rules, "expert_act")
        self.inner = _split(rules, "inner")
        self.moe_impl = r.get("moe_impl")
        self.mlp_seq = bool(_split(rules, "mlp_seq"))
        # the axes along which ranks hold other tokens: what the MoE's
        # router statistics are averaged over (``stats``)
        self.stats = Split(self.mesh, self.batch.axes + self.seq.axes)
        self.kv_compress = bool(r.get("kv_compress"))
        self.gathered: dict[int, object] = {}
        self._zero: dict[tuple, object] = {}
        # the query heads a rank computes: the head split's, or, where only
        # the kv heads are split, those that read the rank's kv heads
        self.q_heads = self.heads if self.heads else self.kv_heads
        # the MoE experts' block: their split and the mlp split inside them
        # (where ``make_rules`` leaves the experts whole)
        inside = _axes(rules.spec("expert", "w_embed", "mlp")[2])
        self.moe_inside = Split(self.mesh, tuple(
            a for a in inside if a not in self.expert.axes))
        self.moe_block = Split(self.mesh,
                               self.expert.axes + self.moe_inside.axes)
        # made here, on every rank in the same order: a group is made
        # collectively
        self._reshard = {}
        for axes in ((), self.mlp.axes, self.vocab.axes, self.inner.axes,
                     self.q_heads.axes, self.moe_block.axes):
            if axes not in self._reshard:
                self._reshard[axes] = Reshard(self.mesh, self.seq, axes)

    def reshard(self, block: Split) -> "Reshard":
        """How a block split over ``block`` meets the sequence split."""
        return self._reshard[block.axes]

    # -- parameters ------------------------------------------------------------

    def zero_dim(self, module, leaf: str):
        """``(dim, Split)`` of a leaf's ``w_embed`` dimension where the rules
        shard it, else ``None``."""
        return self.zero_dim_of(type(module).AXES[leaf])

    def zero_dim_of(self, logical: tuple):
        """``zero_dim`` of a leaf with these logical axes."""
        if logical not in self._zero:
            found = None
            if "w_embed" in logical:
                dim = logical.index("w_embed")
                split = Split(self.mesh,
                              _axes(self.rules.spec(*logical)[dim]))
                found = (dim, split) if split else None
            self._zero[logical] = found
        return self._zero[logical]

    def weight(self, module, leaf: str):
        """The parameter as this rank computes with it: its shard, with the
        ``w_embed`` dimension gathered."""
        p = getattr(module, leaf)
        full = self.gathered.get(id(p))
        if full is not None:
            return full
        zero = self.zero_dim(module, leaf)
        if zero is None:
            return p
        dim, split = zero
        return C.gather_along(p, dim, split.group,
                              1.0 / self.repeats(split.axes))

    def repeats(self, axes: tuple[str, ...]) -> int:
        """How many ranks along ``axes`` compute the same thing: those of
        the axes that split neither the batch nor the sequence (under
        ``pure_dp`` with a batch too small for the whole mesh, ZeRO's
        ``w_embed`` spans axes whose ranks repeat each other's rows)."""
        busy = set(self.batch.axes) | set(self.seq.axes)
        return math.prod(int(self.mesh.shape[a]) for a in axes
                         if a not in busy)

    def leaf_axes(self, logical: tuple) -> set[str]:
        """The mesh axes a leaf with these logical axes is sharded over."""
        out: set[str] = set()
        for part in self.rules.spec(*logical):
            out.update(_axes(part))
        return {a for a in out if int(self.mesh.shape[a]) > 1}

    def grad_sync_axes(self, logical: tuple, partial: bool = False,
                       whole: bool = False) -> tuple[str, ...]:
        """The mesh axes to sum a leaf's gradient over after the backward
        (the module docstring), in mesh order. ``partial``: the leaf is one
        of a recurrent block's that the inner split leaves whole but each
        inner rank only partly differentiates; ``whole``: one the inner
        split leaves whole whose gradient every inner rank has whole (its
        use follows the sum over the inner ranks)."""
        sharded = self.leaf_axes(logical)
        need = set(self.batch.axes) | set(self.seq.axes)
        if whole:
            need -= set(self.inner.axes)
        if self.heads and "kv_heads" in logical:
            need |= set(self.heads.axes)
        if self.kv_heads and not self.heads and "heads" in logical:
            need |= set(self.kv_heads.axes)
        if partial:
            need |= set(self.inner.axes)
        return tuple(a for a in self.mesh.axis_names
                     if a in need - sharded and int(self.mesh.shape[a]) > 1)

    # -- the sequence ------------------------------------------------------------

    def local_positions(self, positions):
        """This rank's block of ``(B, S)`` positions (all of them without a
        sequence split)."""
        return self.seq_block(positions)

    def seq_block(self, t):
        """This rank's block of the sequence (dimension 1) of ``t``, which
        every rank holds whole (a plain slice)."""
        if not self.seq:
            return t
        lo, n = self.seq.block(t.shape[1])
        return t[:, lo:lo + n]


class Reshard:
    """A block split over mesh axes ``T`` (``block``: heads, mlp, vocab,
    inner or the experts) on a residual split along the sequence over
    ``S``. The block computes partial sums over ``T`` of rows that every
    rank of ``T`` holds alike; the residual keeps rank ``i``'s block of the
    sequence. GSPMD reshards between the two; here:

    - ``enter``: the sequence gathered over ``S`` (``gather_along``, its
      backward the sum of the ranks' gradients), then ``copy_to`` over
      ``T - S``; ``leave``: the partial sums summed over ``T - S``
      (``reduce_from``), then, axis by axis of ``S`` in mesh order, a
      reduce-scatter where the axis is in ``T`` and a slice where it is
      not. ``T == S`` is Megatron's sequence parallelism (an all-gather in,
      a reduce-scatter out), ``S`` empty its tensor parallelism;
    - ``local=True``, for a block that works position by position (the
      MLP, the loss, an MoE whose chunks a rank's block holds whole): only
      ``S & T`` is gathered and reduce-scattered, and every rank keeps the
      positions of its block of ``S - T``.

    The gradient a rank ends with is then a partial sum over the axes of
    ``S`` that ``T`` does not split, for every leaf of the block
    (``TensorPlan.grad_sync_axes`` sums ``S`` less the leaf's own axes)."""

    def __init__(self, mesh, seq: Split, block: tuple[str, ...]):
        self.seq = seq
        self.rest = Split(mesh, tuple(a for a in block if a not in seq.axes))
        self.shared = Split(mesh, tuple(a for a in seq.axes if a in block))
        self.alone = Split(mesh, tuple(a for a in seq.axes
                                       if a not in block))
        # each axis of ``S``, in mesh order, and whether ``T`` splits it
        self.per_axis = [(a in block, Split(mesh, (a,))) for a in seq.axes] \
            if self.shared and self.alone else []

    def gather(self, x, local: bool = False):
        """The sequence as the block takes it (``enter`` without the
        ``copy_to``)."""
        split = self.shared if local else self.seq
        return C.gather_along(x, 1, split.group) if split else x

    def replicate(self, x):
        """A tensor every rank of ``T`` uses its own way: ``copy_to`` over
        ``T - S``."""
        return C.copy_to(x, self.rest.group) if self.rest else x

    def enter(self, x, local: bool = False):
        return self.replicate(self.gather(x, local))

    def leave(self, y, local: bool = False):
        if self.rest:
            y = C.reduce_from(y, self.rest.group)
        if self.shared and (local or not self.alone):
            return C.reduce_scatter_along(y, 1, self.shared.group)
        if local or not self.seq:
            return y
        if not self.shared:
            lo, n = self.seq.block(y.shape[1])
            return y[:, lo:lo + n]
        for inside, split in self.per_axis:
            if inside:
                y = C.reduce_scatter_along(y, 1, split.group)
            else:
                lo, n = split.block(y.shape[1])
                y = y[:, lo:lo + n]
        return y


def tensor_plan(rules: ShardingRules | None) -> TensorPlan | None:
    """``TensorPlan`` of ``rules``, or ``None`` where they split nothing but
    the batch over more than one rank (no rules, no mesh, data parallelism
    alone): the model then runs as on one device."""
    if rules is None or rules.mesh is None:
        return None
    for logical, phys in rules.rules.items():
        if logical in ("batch", "layers") + _FLAGS or phys is None:
            continue
        if math.prod(int(rules.mesh.shape[a]) for a in _axes(phys)) > 1:
            return TensorPlan(rules)
    return None
