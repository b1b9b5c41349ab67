"""Logical-axis sharding rules (the port of ``repro/parallel/sharding.py``).

Model code names tensor axes logically (``"batch"``, ``"seq"``,
``"embed"``, ``"heads"``, ``"expert"``, ...). A ``ShardingRules`` mapping,
made by the decision nodes of ``repro_torch.parallel.strategies``, binds
logical names to mesh axes (``repro_torch.launch.mesh.Mesh``). ``spec``
gives the reference's ``PartitionSpec`` as a tuple (``None``, an axis name
or a tuple of names per dimension, an axis used once), and ``sharding``
the bound ``DeviceMesh``'s ``Shard``/``Replicate`` placements.

What runs: the batch split (data parallelism over ``data``, and ``pod`` in
its data role), the layer split over ``pod`` (``pp_rules``, with the
splits below inside each stage but the experts') and every split
``make_rules`` gives a production cell of the ten models: ``heads``,
``kv_heads``, ``mlp``, ``vocab``, ``seq`` (with ``mlp_seq``),
``cache_seq``, ``w_embed`` (ZeRO-3), ``expert`` with the MoE plane
``moe_impl`` or ``expert_act`` picks (``shard_map_a2a``, GSPMD's
``all_to_all`` of the planner's baseline profile, ``gather``,
``shard_map_local``) and ``inner`` (Mamba, mLSTM, sLSTM), each rank
holding its shards (``repro_torch.models.convert.shard_params``) and
making the collectives of ``repro_torch.parallel.tensor``: any of them
also over the batch's mesh axes (the weights gathered as ZeRO-3's, the
activations whole on those axes, as the reference's ``spec`` gives
them), and the kv heads over other axes than the query heads (their
weights gathered). ``logical_shard`` only checks the rank. Splits that
the residual's sequence split does not fit are resharded around the
block (``tensor.Reshard``). ``require_executable`` refuses only the two
rule sets on which the reference itself raises or computes another
function.

Canonical logical axes (as in the reference):

  batch      global batch dim (DP: data (+pod))
  seq        sequence dim (SP under seq_tp)
  embed      d_model / residual stream (never sharded)
  heads      attention query heads (TP under head_tp)
  kv_heads   attention kv heads (TP when divisible)
  qkv        per-head feature dim (never sharded)
  mlp        FFN hidden dim (TP column/row)
  expert     MoE expert dim (EP)
  cap        MoE capacity dim
  vocab      vocabulary dim (TP)
  inner      SSM / xLSTM inner feature dim (TP)
  state      SSM state dim (never sharded)
  w_embed    a weight's d_model dim (ZeRO-3 over data)
  layers     stacked repeats (PP over pod under pp_rules)
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Mapping

_RULES: contextvars.ContextVar["ShardingRules | None"] = \
    contextvars.ContextVar("sharding_rules", default=None)

# rule keys that are switches, not logical axes
_FLAGS = ("moe_impl", "causal_skip", "kv_compress")


class ShardingRules:
    """Binds logical axis names to mesh axes (or None = replicated)."""

    def __init__(self, mesh, rules: Mapping[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, *logical_axes: str | None) -> tuple:
        """One entry per dimension: ``None``, a mesh axis or a tuple of
        them; a mesh axis already used by an earlier dimension drops out."""
        parts: list = []
        used: set[str] = set()
        for ax in logical_axes:
            phys = None if ax is None else self.rules.get(ax)
            if phys is None:
                parts.append(None)
            elif isinstance(phys, (tuple, list)):
                fresh = tuple(p for p in phys if p not in used)
                used.update(fresh)
                # one axis left stands alone, as in a PartitionSpec
                parts.append(fresh[0] if len(fresh) == 1 else fresh or None)
            elif phys in used:
                parts.append(None)
            else:
                used.add(phys)
                parts.append(phys)
        return tuple(parts)

    def sharding(self, *logical_axes: str | None):
        """The placements (one per mesh axis: ``Shard(dim)`` or
        ``Replicate()``) of a tensor with these logical axes on the mesh's
        ``DeviceMesh``, or ``None`` without one."""
        if self.mesh is None or getattr(self.mesh, "device_mesh", None) \
                is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        dims = {}
        for dim, part in enumerate(self.spec(*logical_axes)):
            for axis in (part if isinstance(part, tuple) else (part,)):
                if axis is not None:
                    dims[axis] = dim
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in self.mesh.axis_names)

    def axis_size(self, logical: str) -> int:
        """Number of shards a logical axis is split into."""
        if self.mesh is None:
            return 1
        phys = self.rules.get(logical)
        if phys is None:
            return 1
        if isinstance(phys, (tuple, list)):
            return int(math.prod(self.mesh.shape[p] for p in phys))
        return int(self.mesh.shape[phys])


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def current_rules() -> ShardingRules | None:
    return _RULES.get()


def batch_group():
    """The process group over the mesh axes the current rules split the
    batch over, or ``None`` when no rule splits it over more than one
    rank (no rules, no mesh, or batch axes of size 1)."""
    rules = _RULES.get()
    if rules is None or rules.mesh is None or rules.axis_size("batch") == 1:
        return None
    return rules.mesh.group(rules.rules["batch"])


def logical_shard(x, *logical_axes: str | None):
    """The reference's sharding constraint: here only its rank check. Every
    tensor a rank holds is already its local shard."""
    rules = _RULES.get()
    if rules is not None and rules.mesh is not None \
            and x.dim() != len(logical_axes):
        raise ValueError(
            f"rank mismatch: {tuple(x.shape)} vs logical axes {logical_axes}")
    return x


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


def divisible(n: int, logical: str) -> bool:
    rules = _RULES.get()
    if rules is None:
        return True
    return n % rules.axis_size(logical) == 0


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in v)


def make_param_sharding(rules: ShardingRules, logical_tree) -> Any:
    """Map a tree (dicts, lists and tuples) of logical-axis tuples to
    their placements (``ShardingRules.sharding``)."""
    if _is_axes(logical_tree):
        return rules.sharding(*logical_tree)
    if isinstance(logical_tree, dict):
        return {k: make_param_sharding(rules, v)
                for k, v in logical_tree.items()}
    return type(logical_tree)(make_param_sharding(rules, v)
                              for v in logical_tree)


def _mesh_axes(rules: ShardingRules, logical: str) -> tuple[str, ...]:
    """The mesh axes of more than one rank a logical axis is split over."""
    phys = rules.rules.get(logical)
    if phys is None:
        return ()
    axes = tuple(phys) if isinstance(phys, (tuple, list)) else (phys,)
    return tuple(a for a in axes if int(rules.mesh.shape[a]) > 1)


def require_executable(rules: ShardingRules | None, pipeline: bool = False,
                       cfg=None) -> None:
    """Refuse a rule set the port does not run (``TensorPlan`` asks too,
    with neither ``pipeline`` nor ``cfg``): the two the reference cannot
    run as the unsharded model, each refused naming what it does:

    - an MoE model's experts split under the ``pipeline``, over the
      experts or on their mlp dimension: the reference's pipeline sends
      an MoE layer's 3-D expert weights to the dense MLP
      (``repro/parallel/pipeline.py:80`` calls ``_apply_block`` with
      ``is_moe=False``, ``repro/models/lm.py:169-174``), which raises on
      any MoE model (the port's pipeline runs one with its experts whole);
    - the MoE all-to-all (``moe_impl="shard_map_a2a"``) without the
      experts split over ``model`` alone (unsplit where ``model`` is 1):
      ``repro/models/moe.py:138`` cuts ``E // model`` local experts
      whatever the weights' split, so its einsum raises where the experts
      are unsplit on ``model`` > 1, and it computes another function than
      the unsharded layer where they are split over other axes (over
      ``data`` beside the batch: a loss of 6.743961 against 6.826857 on
      granite's fp32 smoke config).

    Raises ``NotImplementedError``."""
    if rules is None or rules.mesh is None:
        return
    refused, why = {}, []
    experts = _mesh_axes(rules, "expert")
    model = int(rules.mesh.shape.get("model", 1))
    if rules.rules.get("moe_impl") == "shard_map_a2a" \
            and experts != (("model",) if model > 1 else ()):
        refused["moe_impl"] = "shard_map_a2a"
        why.append("the reference's moe_shard_map cuts num_experts // model "
                   "local experts whatever the experts' split "
                   "(repro/models/moe.py:138): it raises where the experts "
                   "are unsplit on model > 1, and computes another "
                   "function than the unsharded layer where they are "
                   "split over other axes")
    # without a cfg only the experts' own split tells of an MoE model
    moe = cfg is None or cfg.moe is not None
    inside = _mesh_axes(rules, "mlp") if cfg is not None else ()
    if pipeline and moe and (experts or inside):
        logical = "expert" if experts else "mlp"
        refused[logical] = rules.rules[logical]
        why.append("the reference's pipeline raises on any MoE layer "
                   "(repro/parallel/pipeline.py:80 runs it as a dense MLP, "
                   "repro/models/lm.py:169-174)")
    if refused:
        raise NotImplementedError(
            f"these rules shard {refused} over mesh axes larger than 1: "
            + "; ".join(why))


# every logical axis a rule set names (``make_rules``'), switches aside
LOGICAL_AXES = ("batch", "seq", "kv_seq", "mlp_seq", "cache_seq", "embed",
                "qkv", "cap", "state", "layers", "kv_rep", "w_embed",
                "vocab", "mlp", "heads", "kv_heads", "expert", "expert_act",
                "inner")

# Layouts the reference runs under hand-written rules (GSPMD places them)
# that no plan of the planner's reaches, but the first, which
# ``make_rules`` gives wherever ``model`` divides ``d_expert`` and not the
# experts. Each names the logical axes it splits; ``layout_rules`` makes
# the rest ``None``.
LAYOUTS = {
    # the experts on their mlp dimension: every rank routes every token
    "experts_on_mlp": {"batch": "data", "mlp": "model", "vocab": "model"},
    # expert_act over other axes than the experts
    "expert_act_data": {"batch": "data", "expert": "model",
                        "expert_act": "data", "vocab": "model"},
    # an MoE layer under a sequence split over other axes than its
    # experts: the gather plane, and the all-to-all's per-block capacity
    "moe_beside_seq": {"seq": "data", "vocab": "model", "expert": "model"},
    "a2a_beside_seq": {"seq": "data", "vocab": "model", "expert": "model",
                       "moe_impl": "shard_map_a2a"},
    # the recurrent blocks' inner split beside a sequence split
    "inner_beside_seq": {"seq": "data", "vocab": "model", "inner": "model"},
    # the sequence beside the heads, kv heads and mlp over other axes
    "seq_beside_heads": {"seq": "model", "vocab": "model", "heads": "data",
                         "kv_heads": "data", "mlp": "data"},
    # the sequence beside the vocab and the mlp over other axes
    "seq_beside_vocab": {"seq": "data", "vocab": "model", "mlp": "model"},
    # the heads over the sequence's own axes (Megatron's sequence
    # parallelism)
    "seq_with_heads": {"seq": "model", "vocab": "model", "heads": "model",
                       "kv_heads": "model", "mlp": "model"},
    # the kv heads split without the query heads
    "kv_heads_alone": {"batch": "data", "kv_heads": "model",
                       "vocab": "model", "mlp": "model"},
    # the mlp over the batch's own axis: FSDP's weights, gathered
    "mlp_over_batch": {"batch": "data", "mlp": "data", "vocab": "model"},
    # the heads and kv heads over the batch's own axis
    "heads_over_batch": {"batch": "data", "heads": "data",
                         "kv_heads": "data", "vocab": "model"},
    # the vocab over the batch's own axis: the table gathered
    "vocab_over_batch": {"batch": "data", "vocab": "data"},
    # the sequence over the batch's own axis: the activations whole
    "seq_over_batch": {"batch": "data", "seq": "data", "vocab": "model",
                       "mlp": "model"},
    # the heads over the batch's axis and another: each rank computes the
    # block of the other axis
    "heads_mixed_batch": {"batch": "data", "heads": ("data", "model"),
                          "kv_heads": ("data", "model"), "mlp": "model"},
    # the experts over the batch's own axis (GShard's, DeepSpeed-MoE's):
    # every rank runs them all on its rows
    "experts_over_batch": {"batch": "data", "expert": "data",
                           "vocab": "model"},
    # the recurrent blocks' inner features over the batch's own axis (and
    # a hybrid's experts)
    "inner_over_batch": {"batch": "data", "inner": "data", "expert": "data",
                         "vocab": "model"},
    # the kv heads over another axis than the query heads: gathered
    "kv_heads_off_heads": {"heads": "model", "kv_heads": "data",
                           "mlp": "model", "expert": "model"},
    # the kv heads over some of the query heads' axes
    "kv_within_heads": {"heads": ("data", "model"), "kv_heads": "model",
                        "mlp": "model"},
}


def layout_rules(mesh, layout) -> ShardingRules:
    """The ``ShardingRules`` of a ``LAYOUTS`` name or of a rules dict on
    ``mesh``: the logical axes it names, every other one ``None``."""
    named = LAYOUTS[layout] if isinstance(layout, str) else layout
    return ShardingRules(mesh, {**{a: None for a in LOGICAL_AXES}, **named})
