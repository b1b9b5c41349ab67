"""How a rank runs the model under sharding rules that split more than the
batch: tensor parallelism (``heads``, ``kv_heads``, ``mlp`` and ``vocab``
over ``model``), the sequence-sharded residual of ``seq_tp`` (``seq``,
with ``mlp_seq``), the sequence-sharded decode cache (``cache_seq``, over
``model`` or ``("data", "model")``), ZeRO-3 (``w_embed`` over ``data``
or the whole mesh), expert parallelism (``expert`` over ``model``, with
the MoE plane ``moe_impl`` or ``expert_act`` picks: ``models/moe.py``)
and the Mamba / xLSTM inner split (``inner`` over ``model`` or ``("data", "model")``:
``models/ssm.py``, ``models/xlstm.py``).

The reference names each tensor's logical axes and lets GSPMD place the
collectives. Here ``TensorPlan`` resolves the rules once, outside any
checkpointed layer (the autograd engine's device thread, which recomputes
such a layer on CUDA, does not see ``use_rules``), and the model's code
asks it for the process groups and for its weights:

- ``weight(module, leaf)`` is this rank's shard of a parameter with its
  ``w_embed`` dimension gathered (``collectives.gather_along``: the
  gradient is reduce-scattered back to the shard), or the copy gathered
  once a step under ``zero2`` with ``regather`` (``gathered``);
- ``grad_sync_axes(name)`` names the mesh axes over which a leaf's
  gradient is still a partial sum after the backward: the batch axes it is
  not sharded over (data parallelism), and, where the residual is
  sequence-sharded, the sequence axes for every leaf not sharded over them
  (each rank saw only its positions), or, under ``head_tp`` with kv heads
  that do not divide, the head axes for the kv projections (each rank used
  only its query heads' kv heads), or, where a recurrent block's
  ``inner`` is split, the inner axes for the block's leaves that the
  split does not cut and whose gradient each inner rank only partly
  computes (``partial``: the sLSTM's replicated ``r_gates``, whose
  recurrence each rank runs whole but feeds back only its own slice).
  A leaf sharded over ``expert`` is not summed over ``model``: the
  all-to-all's backward brings each rank every source's gradient of its
  experts (under either all-to-all plane; the ``gather`` plane's ranks
  see every token).

A rank holds a parameter's shard as ``ShardingRules.spec`` cuts it
(``repro_torch.models.convert.shard_params``): a dimension split over
mesh axes ``A`` keeps block ``mesh.axes_index(A)`` of ``prod(|A|)``
equal blocks.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import _FLAGS, ShardingRules


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
        if self.seq:
            if self.heads or self.kv_heads:
                raise NotImplementedError("a sequence-sharded residual with "
                                          "heads split as well")
            if self.vocab.axes != self.seq.axes:
                raise NotImplementedError(
                    f"a sequence split over {self.seq.axes} needs the vocab "
                    f"split over the same axes, not {self.vocab.axes}")
            if self.mlp and self.mlp.axes != self.seq.axes:
                raise NotImplementedError(
                    f"mlp over {self.mlp.axes} beside the sequence over "
                    f"{self.seq.axes}")
        if self.kv_heads and self.kv_heads.axes != self.heads.axes:
            raise NotImplementedError("kv heads split without the heads")
        if self.expert_act and self.expert_act.axes != self.expert.axes:
            raise NotImplementedError(
                f"expert_act over {self.expert_act.axes} with the experts "
                f"over {self.expert.axes} (reached by no plan of either "
                f"profile; ROADMAP Queue 1 item 11.4d)")
        if self.inner and self.seq and self.inner.axes != self.seq.axes:
            raise NotImplementedError(
                f"inner over {self.inner.axes} beside the sequence over "
                f"{self.seq.axes} (ROADMAP Queue 1 item 11.4d)")
        if (self.moe_impl == "shard_map_a2a" or self.expert_act) \
                and self.seq and self.seq.axes != self.expert.axes:
            raise NotImplementedError(
                f"the MoE all-to-all over {self.expert.axes} beside the "
                f"sequence over {self.seq.axes} (ROADMAP Queue 1 item "
                f"11.4d)")

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

    def grad_sync_axes(self, logical: tuple,
                       partial: bool = False) -> tuple[str, ...]:
        """The mesh axes to sum a leaf's gradient over after the backward
        (the module docstring), in mesh order. ``partial``: the leaf is one
        of a recurrent block's that the inner split leaves whole but each
        inner rank only partly differentiates."""
        sharded = self.leaf_axes(logical)
        need = set(self.batch.axes) - sharded
        if self.seq and not sharded & set(self.seq.axes):
            need |= set(self.seq.axes)
        if self.heads and not self.kv_heads and "kv_heads" in logical:
            need |= set(self.heads.axes)
        if partial and self.inner:
            need |= set(self.inner.axes) - sharded
        return tuple(a for a in self.mesh.axis_names
                     if a in need and int(self.mesh.shape[a]) > 1)

    # -- the sequence ------------------------------------------------------------

    def local_positions(self, positions):
        """This rank's block of ``(B, S)`` positions (all of them without a
        sequence split)."""
        if not self.seq:
            return positions
        lo, n = self.seq.block(positions.shape[1])
        return positions[:, lo:lo + n]


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
