"""Config registry: one module per assigned architecture (the same ten
configs as repro.configs, data only, on the port's ArchConfig)."""
import importlib

ARCH_IDS = [
    "recurrentgemma-2b", "mixtral-8x7b", "dbrx-132b", "phi4-mini-3.8b",
    "nemotron-4-340b", "qwen3-14b", "command-r-plus-104b",
    "whisper-large-v3", "rwkv6-1.6b", "pixtral-12b",
]

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-14b": "qwen3_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "pixtral-12b": "pixtral_12b",
}


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke_config if smoke else mod.config
