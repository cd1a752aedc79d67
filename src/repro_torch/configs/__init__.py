"""Config registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, Stage, cell_is_runnable  # noqa: F401

_ARCH_MODULES = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma-2b": "gemma_2b",
    "minitron-4b": "minitron_4b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-130m": "mamba2_130m",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get_config(arch: str) -> ModelConfig:
    import importlib

    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def registry() -> dict[str, ModelConfig]:
    return {arch: get_config(arch) for arch in _ARCH_MODULES}


ARCH_IDS = tuple(_ARCH_MODULES)
