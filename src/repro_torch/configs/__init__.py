"""Config registry (counterpart of ``repro.configs``): one module per
architecture, each citing its source in its docstring.

``get_config(name)`` returns the full-size ModelConfig and
``get_reduced(name)`` the smoke-test variant, for every LM architecture
the reference has.  The CNN configs live in their own modules
(``configs/vgg16.py``, ``configs/resnet50.py``).
"""

from __future__ import annotations

import importlib
from typing import List

_ARCHS = [
    "qwen3_moe_235b_a22b",
    "llava_next_34b",
    "qwen1_5_110b",
    "xlstm_125m",
    "deepseek_moe_16b",
    "llama3_2_3b",
    "gemma3_4b",
    "zamba2_7b",
    "seamless_m4t_medium",
    "qwen1_5_4b",
]


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in _ARCHS:
        return key
    raise KeyError(f"unknown arch {name!r}; known: {list_configs()}")


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()


def list_configs() -> List[str]:
    return list(_ARCHS)
