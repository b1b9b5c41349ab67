"""Control-plane strategy decisions per (arch x shape x mesh) cell (the
port of ``repro/parallel/strategies.py``).

The LM-side instance of the paper's Fig. 6 decision node: given *system
knowledge* (mesh shape, link and memory rates, device memory) and *data
distribution* (tensor and token sizes from the model and shape configs),
the decision node emits the decision tuple

    func     -> attention/MoE implementation strategy,
    scale    -> microbatch count (function instances ∝ data size),
    schedule -> pod-axis role: "data" (round-robin spread) or
                "pipeline" (packing for link locality),

which ``make_rules`` materializes as logical->physical sharding rules.
Everything is napkin-math cost-modeled the way the paper's T1/T2 thresholds
are: byte counts over link bandwidth against compute over peak FLOP/s.

The decisions are the reference's, line for line, with its hardware
constants replaced by ``hw`` (a ``repro_torch.device.Hardware``, the
H100's figures by default): a planner given the reference's figures
decides as the reference does. Parameter bytes come from
``repro_torch.models.convert.param_shapes`` and ``param_axes`` (a model
built on the meta device: nothing is allocated).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.config import (
    FFNKind,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.core.decisions import (
    Decision,
    DecisionContext,
    DecisionNode,
    DecisionWorkflow,
    Schedule,
)
from repro_torch.device import H100_SXM, Hardware
from repro_torch.models.layers import VOCAB_PAD
from repro_torch.parallel.sharding import ShardingRules, pad_to_multiple

# A train plan's bytes a chip (parameters, gradients and AdamW's state at
# 16 B a parameter plus the trainer's accumulators, ``Hardware.
# accum_bytes``, plus the activation estimate) must fit this share of its
# memory.
TRAIN_HBM_SHARE = 0.8


# ---------------------------------------------------------------------------
# Cost-model helpers (napkin math, the T1/T2 analogue)
# ---------------------------------------------------------------------------


def _prod(values) -> int:
    return int(np.prod(list(values)))


def attn_strategy_cost(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                       hw: Hardware = H100_SXM) -> dict:
    """Per-layer extra-communication bytes of each attention strategy."""
    s, b = shape.seq_len, shape.global_batch
    hd = cfg.resolved_head_dim
    kv_bytes = 2 * s * cfg.num_kv_heads * hd * 2          # K+V bf16, per seq
    res_bytes = s * cfg.d_model * 2                        # residual, per seq
    return {
        # head_tp: Megatron f/g collectives: 2 all-reduces of the residual
        "head_tp": 2 * 2 * res_bytes * b,
        # seq_tp: KV broadcast (hash join) + AG/RS around the FFN
        "seq_tp": (kv_bytes + 2 * res_bytes) * b,
        # replicated attention: no comm but tp x redundant compute -> charge
        # the waste as equivalent bytes at the compute roofline
        "replicated": (2 * s * s * cfg.num_heads * hd * b / hw.peak_flops)
        * hw.link_bw * (tp - 1),
    }


def pick_attention_strategy(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                            hw: Hardware = H100_SXM) -> str:
    if not any(k == "attention" for k in cfg.block_pattern):
        return "none"
    if shape.mode == "decode":
        # decode: cache sharded along sequence; heads sharded iff divisible
        return "decode_kv_shard"
    costs = attn_strategy_cost(cfg, shape, tp, hw)
    feasible = {}
    if cfg.num_heads % tp == 0:
        feasible["head_tp"] = costs["head_tp"]
    if shape.seq_len % tp == 0:
        feasible["seq_tp"] = costs["seq_tp"]
    feasible["replicated"] = costs["replicated"]
    return min(feasible, key=feasible.get)


def pick_moe_strategy(cfg: ModelConfig, shape: ShapeConfig, tp: int) -> str:
    if cfg.ffn != FFNKind.MOE or cfg.moe is None:
        return "none"
    m = cfg.moe
    if shape.mode == "decode":
        # decode: activations are already replicated across the model axis
        # and volumes are latency-dominated: keep experts in place and sum
        # outputs (hash join: ship nothing big)
        return "gather"
    tokens = shape.seq_len
    # train/prefill: the explicit shuffle (sort-merge-join move) when the
    # shapes divide
    if m.num_experts % tp == 0 and tokens % tp == 0:
        return "shard_map_a2a"
    a2a = 2 * m.top_k * tokens * cfg.d_model / tp
    gather = m.capacity_factor * m.top_k * tokens * cfg.d_model \
        * (tp - 1) / tp
    return "all_to_all" if a2a < gather and m.num_experts % tp == 0 \
        else "gather"


def _leaves(tree):
    """The leaves of a ``param_shapes``/``param_axes`` tree in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list) or (isinstance(tree, tuple) and not all(
            isinstance(a, (str, type(None))) for a in tree)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def exact_param_bytes_per_chip(cfg: ModelConfig, rules: ShardingRules) -> int:
    """Exact per-chip parameter bytes under a rule set: each leaf's bytes
    over the shards of the dimensions its rules split evenly."""
    from repro_torch.models.convert import param_axes, param_shapes
    total = 0
    for s, a in zip(_leaves(param_shapes(cfg)), _leaves(param_axes(cfg))):
        shards = 1
        for dim, logical in zip(s.shape, a):
            if logical is None:
                continue
            n = rules.axis_size(logical)
            if n > 1 and dim % n == 0:
                shards *= n
        total += s.nbytes // shards
    return total


def estimate_activation_bytes(cfg: ModelConfig, shape: ShapeConfig, dp: int,
                              tp: int, microbatches: int,
                              seq_sharded: bool) -> float:
    """Saved-residual bytes/chip with block remat (+50% temp headroom)."""
    b_local = max(1, shape.global_batch // dp) / microbatches
    res = cfg.num_layers * b_local * shape.seq_len * cfg.d_model * 2
    if seq_sharded:
        res /= tp
    return 1.5 * res


def state_multiplier(shape: ShapeConfig, hw: Hardware = H100_SXM) -> float:
    """The planner's bytes a chip over its bf16 parameter bytes: in
    training (2 + 12 + 2 + ``hw.accum_bytes``) / 2 (the weight, AdamW's
    fp32 master, m and v, the gradient and the trainer's accumulators), 8
    under the reference's figures; 1 otherwise."""
    if shape.mode != "train":
        return 1.0
    return (16.0 + hw.accum_bytes) / 2


def plan_memory(cfg: ModelConfig, shape: ShapeConfig, mesh,
                pc_attn: str, fsdp_pref: str, layout: str = "tp",
                hw: Hardware = H100_SXM) -> tuple[str, int]:
    """Resolve (fsdp, microbatches) from exact param bytes + act estimate."""
    tp = int(mesh.shape["model"])
    devices = _prod(mesh.shape.values())
    if layout == "pure_dp":
        dp, tp = devices, 1
    else:
        dp = _prod(mesh.shape[a] for a in mesh.shape if a != "model")
    seq_sharded = pc_attn == "seq_tp" and layout != "pure_dp"
    state_mult = state_multiplier(shape, hw)

    def fixed_bytes(fsdp: str) -> float:
        pc = ParallelConfig(attn_strategy=pc_attn, fsdp=fsdp, layout=layout)
        rules = make_rules(mesh, cfg, shape, pc, hw)
        return exact_param_bytes_per_chip(cfg, rules) * state_mult

    if shape.mode != "train":
        fsdp = "off" if fsdp_pref == "auto" else fsdp_pref
        if fixed_bytes(fsdp) > 0.9 * hw.hbm_bytes and fsdp == "off":
            fsdp = "on"
        return fsdp, 1

    fsdp = fsdp_pref
    if fsdp == "auto":
        fsdp = "off" if fixed_bytes("off") < 0.35 * hw.hbm_bytes else "on"
    fixed = fixed_bytes(fsdp)

    mb = 1
    max_mb = max(1, shape.global_batch // dp)
    while mb < max_mb and fixed + estimate_activation_bytes(
            cfg, shape, dp, tp, mb, seq_sharded) > TRAIN_HBM_SHARE * hw.hbm_bytes:
        mb *= 2
    return fsdp, mb


def pick_pod_role(cfg: ModelConfig, shape: ShapeConfig, mesh) -> str:
    """Round-robin (pod=data) vs packing (pod=pipeline): paper Fig. 4(e).

    DP over the slow cross-pod links costs a gradient all-reduce of the full
    model every step; pipelining keeps weights pod-local and only ships
    activations. Pick pipeline when grad bytes >> activation bytes.
    """
    if "pod" not in mesh.shape:
        return "data"
    if shape.mode != "train":
        return "data"
    grad_bytes = cfg.param_count() * 2
    act_bytes = shape.global_batch * shape.seq_len * cfg.d_model * 2
    return "pipeline" if grad_bytes > 4 * act_bytes else "data"


# ---------------------------------------------------------------------------
# Decision node + workflow (paper-facing API)
# ---------------------------------------------------------------------------


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              overrides: ParallelConfig | None = None,
              profile: str = "optimized",
              hw: Hardware = H100_SXM) -> ParallelConfig:
    """Resolve all 'auto' fields of ParallelConfig for one cell.

    profile="baseline" is the paper-faithful plan (GSPMD-inferred MoE
    dispatch, TP-only layouts, full-S^2 attention); profile="optimized"
    applies the reference's validated defaults.
    """
    tp = int(mesh.shape["model"])
    pc = overrides or ParallelConfig()
    optimized = profile == "optimized"
    layout = pc.layout
    if layout == "auto":
        layout = pick_layout(cfg, shape, mesh, hw) if optimized else "tp"
    attn = pc.attn_strategy
    if layout == "pure_dp":
        attn = "replicated" if attn == "auto" else attn
    elif attn == "auto":
        attn = pick_attention_strategy(cfg, shape, tp, hw)
    moe = pc.moe_strategy
    if moe == "auto":
        moe = pick_moe_strategy(cfg, shape, tp)
        if not optimized and moe == "shard_map_a2a":
            moe = "all_to_all"
    if layout == "pure_dp":
        moe = "gather" if moe not in ("none",) else moe
    fsdp, mb_auto = plan_memory(cfg, shape, mesh, attn, pc.fsdp, layout, hw)
    mb = pc.microbatches if pc.microbatches > 1 else mb_auto
    pod_role = pc.pod_axis_role
    if pod_role == "auto":
        pod_role = pick_pod_role(cfg, shape, mesh)
    # semantics-preserving defaults of the reference's hillclimbs
    causal_skip = pc.causal_skip or (optimized and shape.mode != "decode")
    mlp_mode = pc.mlp_mode
    if optimized and mlp_mode == "tp":
        mlp_mode = "auto"
    remat = pc.remat
    if layout == "pure_dp" and remat == "block":
        remat = "dots"   # activations are tiny under full-mesh DP
    return dataclasses.replace(
        pc,
        attn_strategy=attn,
        moe_strategy=moe,
        layout=layout,
        microbatches=mb,
        fsdp=fsdp,
        remat=remat,
        causal_skip=causal_skip,
        mlp_mode=mlp_mode,
        pod_axis_role=pod_role,
        sequence_sharded_residual=(attn == "seq_tp"),
    )


def pick_layout(cfg: ModelConfig, shape: ShapeConfig, mesh,
                hw: Hardware = H100_SXM) -> str:
    """Pure data parallelism + full-mesh ZeRO beats any tensor parallelism
    when the model is small enough: zero TP collectives, wire = one weight
    gather + one gradient reduce-scatter per step. The scale decision of the
    paper (function count ∝ data size) applied to a fixed mesh."""
    if shape.mode != "train":
        return "tp"
    devices = _prod(mesh.shape.values())
    if shape.global_batch % devices != 0:
        return "tp"
    if cfg.d_model % devices != 0:    # ZeRO shards the w_embed dim
        return "tp"
    opt_bytes = cfg.param_count() * 14 / devices
    b_loc = shape.global_batch // devices
    act_bytes = 1.5 * cfg.num_layers * b_loc * shape.seq_len \
        * cfg.d_model * 2
    if opt_bytes + act_bytes > 0.5 * hw.hbm_bytes:
        return "tp"
    # wire comparison: pure_dp pays ~8 bytes/param/step (3x ZeRO weight
    # gathers + gradient reduce-scatter) vs TP's per-layer residual traffic
    pure_dp_wire = 8.0 * cfg.param_count()
    tp_dp = _prod(mesh.shape[a] for a in mesh.shape if a != "model")
    tp_wire = 3 * cfg.num_layers * (shape.global_batch / tp_dp) \
        * shape.seq_len * cfg.d_model * 2 * 2
    return "pure_dp" if pure_dp_wire < tp_wire else "tp"


def strategy_node(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  hw: Hardware = H100_SXM) -> DecisionNode:
    """Paper-style decision node wrapping plan_cell (Fig. 6 analogue)."""

    def fn(ctx: DecisionContext) -> Decision:
        pc = plan_cell(cfg, shape, mesh, hw=hw)
        nodes = tuple(range(len(mesh.devices.flat)))
        policy = "packing" if pc.pod_axis_role == "pipeline" else "round-robin"
        return Decision(
            func=f"attn={pc.attn_strategy},moe={pc.moe_strategy}",
            scale=pc.microbatches,
            schedule=Schedule(policy, nodes),
            extras=(("parallel_config", pc),),
        )

    return DecisionNode(f"strategy:{cfg.name}:{shape.name}", fn)


# ---------------------------------------------------------------------------
# Rules materialization
# ---------------------------------------------------------------------------


def _dp_axes(mesh, pod_role: str):
    if "pod" in mesh.shape and pod_role == "data":
        return ("pod", "data")
    return ("data",) if "data" in mesh.shape else None


def make_rules(mesh, cfg: ModelConfig, shape: ShapeConfig,
               pc: ParallelConfig, hw: Hardware = H100_SXM) -> ShardingRules:
    tp = int(mesh.shape["model"])
    dp_ax = _dp_axes(mesh, pc.pod_axis_role)
    dp = _prod(mesh.shape[a] for a in dp_ax) if dp_ax else 1

    if pc.layout == "pure_dp":
        all_axes = tuple(mesh.shape)
        devices = _prod(mesh.shape.values())
        batch_local = shape.global_batch // max(1, pc.microbatches)
        batch_rule = all_axes if batch_local % devices == 0 else dp_ax
        rules: dict = {name: None for name in (
            "seq", "kv_seq", "mlp_seq", "cache_seq", "embed", "qkv", "cap",
            "state", "layers", "kv_rep", "vocab", "mlp", "heads",
            "kv_heads", "expert", "expert_act", "inner")}
        rules["batch"] = batch_rule
        rules["w_embed"] = all_axes     # full-mesh ZeRO-3 weight sharding
        if pc.causal_skip:
            rules["causal_skip"] = True
        if cfg.moe is not None and batch_rule == all_axes:
            rules["moe_impl"] = "shard_map_local"
        return ShardingRules(mesh, rules)

    batch_local = shape.global_batch // max(1, pc.microbatches) \
        if shape.mode == "train" else shape.global_batch
    batch_rule = dp_ax if dp_ax and batch_local % dp == 0 else (
        "data" if batch_local % int(mesh.shape.get("data", 1)) == 0 else None)

    vpad = pad_to_multiple(cfg.vocab_size, VOCAB_PAD)
    d_inner = 0
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
    elif cfg.xlstm is not None:
        d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)

    # FSDP (ZeRO-3): shard the weight-matrix embed dim over the data axis
    # when params+opt would otherwise blow device memory (only within a
    # pod: the pod axis keeps full replicas so cross-pod traffic stays
    # gradient-only)
    fsdp = pc.fsdp
    if fsdp == "auto":  # normally resolved by plan_memory via plan_cell
        fsdp = "on" if cfg.param_count() * 14 / tp > 0.4 * hw.hbm_bytes \
            else "off"
    fsdp_ax = "data" if (fsdp == "on" and "data" in mesh.shape
                         and cfg.d_model % int(mesh.shape["data"]) == 0) \
        else None

    # ship-weights-vs-ship-activations (the hash-join question for the FFN):
    # under a sequence-sharded residual, keeping activations put and
    # replicating MLP weights over `model` beats AG/RS when the per-layer
    # weight bytes are smaller than the activation traffic
    mlp_mode = pc.mlp_mode
    if mlp_mode == "auto":
        # activation AG/RS happens once per step; weight gathers repeat per
        # microbatch: compare at the step level
        act_wire = 2 * (shape.global_batch / max(1, dp)) \
            * shape.seq_len * cfg.d_model * 2
        w_wire = 3 * cfg.d_model * max(cfg.d_ff, 1) * 2 \
            * max(1, pc.microbatches)
        mlp_mode = "seq" if (pc.attn_strategy == "seq_tp"
                             and w_wire < act_wire) else "tp"
    rules_mlp_seq = "model" if (mlp_mode == "seq"
                                and pc.attn_strategy == "seq_tp") else None

    rules: dict = {
        "batch": batch_rule,
        "seq": None, "kv_seq": None, "cache_seq": None,
        "mlp_seq": rules_mlp_seq,
        "embed": None, "qkv": None, "cap": None, "state": None,
        "layers": None, "kv_rep": None,
        "w_embed": fsdp_ax,
        "vocab": "model" if vpad % tp == 0 else None,
        "mlp": None if rules_mlp_seq else (
            "model" if cfg.d_ff and cfg.d_ff % tp == 0 else None),
        "heads": None, "kv_heads": None,
        "expert": None, "expert_act": None,
        "inner": "model" if d_inner and d_inner % tp == 0 else None,
    }

    if cfg.moe is not None:
        if cfg.moe.num_experts % tp == 0:
            rules["expert"] = "model"
            if pc.moe_strategy == "all_to_all":
                rules["expert_act"] = "model"
            elif pc.moe_strategy == "shard_map_a2a" \
                    and shape.seq_len % tp == 0 and shape.mode != "decode":
                # the explicit shuffle data plane (``models.moe``)
                rules["moe_impl"] = "shard_map_a2a"
        else:  # experts not divisible: fall back to mlp-dim TP inside experts
            rules["expert"] = None
            rules["mlp"] = "model" if cfg.moe.d_expert % tp == 0 else None

    if pc.kv_compress:
        rules["kv_compress"] = True
    if pc.causal_skip:
        rules["causal_skip"] = True

    strat = pc.attn_strategy
    if strat == "head_tp":
        rules["heads"] = "model"
        kv_div = cfg.num_kv_heads % tp == 0
        rules["kv_heads"] = "model" if kv_div else None
        rules["kv_rep"] = "model" if kv_div else None
    elif strat == "seq_tp":
        rules["seq"] = "model"
        # KV stays at num_kv_heads width and is broadcast (hash join)
    elif strat == "decode_kv_shard":
        rules["cache_seq"] = "model"
        if cfg.num_heads % tp == 0:
            rules["heads"] = "model"
        if cfg.num_kv_heads % tp == 0:
            rules["kv_heads"] = "model"
    # "replicated"/"none": leave attention axes unsharded

    if shape.name == "long_500k":
        # batch=1: recruit the idle data axis for state/cache sharding
        extra = ("data", "model")
        if d_inner and d_inner % (dp * tp) == 0:
            rules["inner"] = extra
        if shape.seq_len % (dp * tp) == 0:
            rules["cache_seq"] = extra
        if vpad % (dp * tp) == 0:
            rules["vocab"] = extra
        rules["batch"] = None

    return ShardingRules(mesh, rules)


def build_workflow(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   hw: Hardware = H100_SXM) -> DecisionWorkflow:
    wf = DecisionWorkflow(f"{cfg.name}:{shape.name}")
    wf.add(strategy_node(cfg, shape, mesh, hw))
    return wf
