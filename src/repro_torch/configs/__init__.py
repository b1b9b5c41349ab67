"""Architecture registry: the 10 assigned archs, as shape tables copied from
the reference's ``repro/configs`` (the paper's analytics workload config
lives in ``repro_torch/analytics``)."""

from __future__ import annotations

import importlib

from repro_torch.core.config import ModelConfig

ARCH_IDS = (
    "qwen1.5-4b",
    "mistral-nemo-12b",
    "llama3.2-3b",
    "qwen2-72b",
    "internvl2-1b",
    "xlstm-1.3b",
    "moonshot-v1-16b-a3b",
    "granite-moe-1b-a400m",
    "musicgen-medium",
    "jamba-v0.1-52b",
)

_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2-72b": "qwen2_72b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-1.3b": "xlstm_1_3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "musicgen-medium": "musicgen_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = _module(arch_id)
    return mod.smoke_config() if smoke else mod.full_config()


def all_configs(smoke: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
