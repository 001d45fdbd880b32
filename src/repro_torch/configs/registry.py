"""Architecture registry (port of the reference ``configs/registry.py``).

Every architecture has a module ``configs/<id>.py`` exporting ``CONFIG``
(the published numbers) and ``reduced()`` (a small config of the same
family). The reference's dry-run helpers ``all_cells``, ``input_specs``
and ``batch_pspec`` wait for the port's analysis slice (ROADMAP queue 1
item 17).
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "recurrentgemma_9b",
    "deepseek_v3_671b",
    "llama4_maverick_400b_a17b",
    "mamba2_780m",
    "hubert_xlarge",
    "qwen2_5_14b",
    "internlm2_20b",
    "phi4_mini_3_8b",
    "qwen3_1_7b",
    "qwen2_vl_2b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(name: str):
    name = _ALIASES.get(name, name).replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
