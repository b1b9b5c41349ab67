"""Configuration of the port: a plain copy of the reference's
``repro/core/config.py``.

``ModelConfig`` carries an architecture definition, ``ShapeConfig`` one
input-shape cell, and ``OptimizerConfig``, ``ParallelConfig``,
``CheckpointConfig`` and ``RunConfig`` a training run. The dataclasses are
frozen and field-for-field equal to the reference's, so equality,
``resolved_head_dim``, ``param_count`` and ``fingerprint`` agree.
``ParallelConfig``'s fields are resolved by the port's planner
(``repro_torch.parallel.strategies.plan_cell``) and materialized as
sharding rules (``make_rules``). The trainer reads ``microbatches``,
``remat`` and ``zero2`` and runs the rules' batch split (data
parallelism), the pipeline over ``pod`` and the tensor, sequence,
expert, inner and ZeRO-3 splits.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Mapping, Sequence


class BlockKind(str, enum.Enum):
    """Kinds of residual blocks the unified LM stack can interleave."""

    ATTENTION = "attention"
    MAMBA = "mamba"
    MLSTM = "mlstm"
    SLSTM = "slstm"


class FFNKind(str, enum.Enum):
    DENSE = "dense"          # SwiGLU MLP
    MOE = "moe"              # top-k routed experts
    NONE = "none"            # block has no separate FFN (e.g. xLSTM)


class Frontend(str, enum.Enum):
    TOKENS = "tokens"        # plain token ids
    VISION_STUB = "vision"   # precomputed patch embeddings + token ids
    AUDIO_STUB = "audio"     # precomputed EnCodec frame embeddings / codec tokens


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    every_k_layers: int = 1          # MoE applied every k-th block (Jamba: 2)
    router_jitter: float = 0.0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                  # d_inner = expand * d_model
    dt_rank: int = 0                 # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8             # every k-th block is sLSTM, rest mLSTM
    conv_kernel: int = 4
    qk_dim_factor: float = 0.5
    v_dim_factor: float = 1.0
    proj_factor: float = 2.0         # pre-up-projection factor for mLSTM


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    ffn: FFNKind = FFNKind.DENSE
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    # layout: pattern of block kinds tiled over num_layers, e.g.
    # ("attention",) for dense, ("mamba",)*7 + ("attention",) for Jamba 1:7.
    block_pattern: tuple[str, ...] = (BlockKind.ATTENTION.value,)
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = Frontend.TOKENS.value
    stub_patches: int = 256          # VLM stub frontend patch count
    max_position: int = 131072
    dtype: str = "bfloat16"
    # Families: "dense" | "moe" | "ssm" | "hybrid" | "vlm" | "audio"
    family: str = "dense"
    sub_quadratic: bool = False      # eligible for long_500k decode

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def block_kind(self, layer: int) -> BlockKind:
        return BlockKind(self.block_pattern[layer % len(self.block_pattern)])

    def layer_is_moe(self, layer: int) -> bool:
        if self.ffn != FFNKind.MOE or self.moe is None:
            return False
        return layer % self.moe.every_k_layers == (self.moe.every_k_layers - 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        hd = self.resolved_head_dim
        for layer in range(self.num_layers):
            kind = self.block_kind(layer)
            if kind == BlockKind.ATTENTION:
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.num_heads + 2 * self.num_kv_heads) * hd
            elif kind == BlockKind.MAMBA:
                ssm = self.ssm or SSMConfig()
                d_in = ssm.expand * d
                dt_rank = ssm.dt_rank or -(-d // 16)
                total += d * 2 * d_in            # in_proj
                total += d_in * ssm.d_conv + d_in  # conv w + b
                total += d_in * (dt_rank + 2 * ssm.d_state)  # x_proj
                total += dt_rank * d_in + d_in   # dt_proj
                total += d_in * ssm.d_state      # A_log
                total += d_in                    # D
                total += d_in * d                # out_proj
            elif kind == BlockKind.MLSTM:
                x = self.xlstm or XLSTMConfig()
                d_in = int(x.proj_factor * d)
                qk = int(x.qk_dim_factor * d_in)
                h = self.num_heads
                total += 2 * d * d_in            # up proj (2 branches)
                total += d_in * x.conv_kernel + d_in
                total += 2 * d_in * qk           # wq, wk
                total += d_in * d_in             # wv
                total += d_in * 2 * h + 2 * h    # i/f gates
                total += d_in                    # head norm
                total += d_in * d                # down proj
            elif kind == BlockKind.SLSTM:
                x = self.xlstm or XLSTMConfig()
                d_in = int(x.proj_factor * d)
                h = self.num_heads
                dv = d_in // h
                total += 2 * d * d_in            # up proj
                total += d_in * x.conv_kernel + d_in
                total += d_in * 4 * d_in + 4 * d_in  # w_gates + b
                total += 4 * h * dv * dv         # block-diag recurrence
                total += d_in                    # head norm
                total += d_in * d                # down proj
            # FFN
            if self.layer_is_moe(layer):
                assert self.moe is not None
                total += d * self.moe.num_experts * 3 * self.moe.d_expert
                total += d * self.moe.num_experts  # router
            elif self.ffn != FFNKind.NONE:
                total += 3 * d * self.d_ff       # SwiGLU gate/up/down
            if self.ffn != FFNKind.NONE:
                total += 2 * d                   # 2 RMSNorm scales
            else:
                total += d                       # single pre-norm
        total += d                               # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.ffn != FFNKind.MOE or self.moe is None:
            return self.param_count()
        dense_like = self.param_count()
        m = self.moe
        n_moe_layers = sum(
            1 for layer in range(self.num_layers) if self.layer_is_moe(layer)
        )
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return dense_like - n_moe_layers * inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.mode == "decode":
            return self.global_batch          # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # Gradient compression for cross-pod all-reduce: "none"|"bf16"|"int8"
    grad_compression: str = "none"


@dataclass(frozen=True)
class ParallelConfig:
    """Resolved control-plane decisions for one (arch x shape x mesh) cell:
    the reference's decision tuple (func, scale, schedule)."""

    # func: which implementation variant
    attn_strategy: str = "auto"      # "head_tp" | "seq_tp" | "replicated" | "auto"
    moe_strategy: str = "auto"       # "all_to_all" | "gather" |
                                     # "shard_map_a2a" | "auto"
    layout: str = "auto"             # "tp" | "pure_dp" | "auto"
    # scale: how much parallelism / accumulation
    microbatches: int = 1
    remat: str = "block"             # "none" | "block" | "dots"
    # schedule: placement of work over the mesh
    pod_axis_role: str = "data"      # "data" (round-robin) | "pipeline" (packing)
    sequence_sharded_residual: bool = False
    fsdp: str = "auto"               # "on" | "off" | "auto"
    zero2: bool = False              # gather FSDP weights once per step
    # data-plane knobs
    use_pallas_attention: bool = False
    kv_compress: bool = False        # int8-wire the seq_tp KV broadcast
    causal_skip: bool = False        # skip upper-triangle attention chunks
    mlp_mode: str = "tp"             # "tp" | "seq" | "auto"
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/repro_ckpt"
    keep: int = 3
    every_steps: int = 50
    async_write: bool = True


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    parallel: ParallelConfig = ParallelConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    steps: int = 100
    seed: int = 0
    priority: int = 0                # controller priority (higher wins)


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def fingerprint(*cfgs: Any) -> str:
    """Stable content hash of configs (the reference's executable-cache
    key)."""
    blob = json.dumps([dataclasses.asdict(c) for c in cfgs], sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def override(cfg, dotted: Mapping[str, Any]):
    """Apply {"optimizer.lr": 1e-4}-style overrides to a nested dataclass."""
    for key, value in dotted.items():
        cfg = _override_one(cfg, key.split("."), value)
    return cfg


def _override_one(cfg, parts: Sequence[str], value):
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    child = getattr(cfg, parts[0])
    return dataclasses.replace(
        cfg, **{parts[0]: _override_one(child, parts[1:], value)}
    )
