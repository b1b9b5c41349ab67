"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias. [arXiv:2407.10671; hf]

The largest assigned arch: the scale decision node raises microbatch
accumulation so the train_4k cell fits HBM.
"""

from repro_torch.core.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        max_position=131072,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=192,
        vocab_size=512,
        qkv_bias=True,
        rope_theta=1e6,
        family="dense",
    )
