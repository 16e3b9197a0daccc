"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ reduced variant)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, tuple[ModelConfig, ModelConfig]] = {}

ARCH_IDS = [
    "jamba-v0.1-52b",
    "qwen3-4b",
    "qwen2.5-14b",
    "llama3.2-1b",
    "llama3.2-3b",
    "llava-next-mistral-7b",
    "mixtral-8x22b",
    "deepseek-v3-671b",
    "rwkv6-1.6b",
    "whisper-large-v3",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def register(full: ModelConfig, reduced: ModelConfig) -> None:
    _REGISTRY[full.name] = (full, reduced)


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _REGISTRY:
        if arch not in _MODULES:
            raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
        importlib.import_module(_MODULES[arch])
    full, red = _REGISTRY[arch]
    return red if reduced else full


def all_archs() -> list[str]:
    return list(ARCH_IDS)
