"""Config registry (counterpart of ``repro.configs``): one module per
architecture, each citing its source in its docstring.

``get_config(name)`` returns the full-size ModelConfig and
``get_reduced(name)`` the smoke-test variant.  The registry knows every
architecture the reference has; those whose layers the port does not run
yet raise ``NotImplementedError`` saying so.  The CNN configs live in their
own modules (``configs/vgg16.py``, ``configs/resnet50.py``).
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
#: architectures whose config the port carries
PORTED = ("gemma3_4b", "llama3_2_3b", "qwen1_5_4b", "qwen1_5_110b",
          "zamba2_7b", "xlstm_125m")
#: the slice each other architecture's training and serving wait for
WAITS_FOR = {"qwen3_moe_235b_a22b": "the MoE slice (moe.py)",
             "deepseek_moe_16b": "the MoE slice (moe.py)",
             "llava_next_34b": "the VLM slice (the vision frontend)",
             "seamless_m4t_medium":
                 "the encoder-decoder slice (encdec.py)"}


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in _ARCHS:
        return key
    raise KeyError(f"unknown arch {name!r}; known: {list_configs()}")


def _module(name: str):
    key = canonical(name)
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {key!r} is not ported yet (its training and serving wait "
            f"for {WAITS_FOR.get(key, 'a later slice')}); ported LM archs: "
            f"{list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()


def list_configs() -> List[str]:
    return list(_ARCHS)
