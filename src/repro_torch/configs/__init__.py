"""Architecture registry: one module per architecture, the counterpart of
``repro.configs`` against the port's ``ModelConfig``.

``get_config(name)`` returns the full-size ModelConfig.  The tests build
every config at full size on the ``meta`` device (parameter counts, no
allocation) and run it at reduced size; ``chip_smoke.py`` serves
Qwen1.5-0.5B at full size on the card.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "jamba-v0.1-52b",
    "granite-moe-3b-a800m",
    "llama4-scout-17b-a16e",
    "mamba2-370m",
    "stablelm-3b",
    "llama3-405b",
    "qwen1.5-0.5b",
    "mistral-nemo-12b",
    "llama-3.2-vision-90b",
    "whisper-small",
)


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    cfg = mod.CONFIG
    cfg.validate()
    return cfg


def list_archs() -> tuple[str, ...]:
    return ARCHS
