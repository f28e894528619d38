"""Configs of the port: the twins (``hp_twin``, ``lorenz96_twin``) and the
LM architecture registry, ``get_config(name)`` / ``get_smoke(name)``
(port of ``repro/configs/__init__.py``)."""
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      active_param_count, param_count,
                                      runnable_shapes)

_MODULES = {
    "deepseek-v2-lite-16b": "lm.deepseek_v2_lite_16b",
    "deepseek-v2-236b": "lm.deepseek_v2_236b",
    "jamba-v0.1-52b": "lm.jamba_v0_1_52b",
    "llama3-8b": "lm.llama3_8b",
    "internlm2-20b": "lm.internlm2_20b",
    "qwen3-1.7b": "lm.qwen3_1_7b",
    "qwen1.5-32b": "lm.qwen1_5_32b",
    "musicgen-medium": "lm.musicgen_medium",
    "xlstm-125m": "lm.xlstm_125m",
    "chameleon-34b": "lm.chameleon_34b",
}

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "SHAPES", "ArchConfig", "ShapeConfig",
           "active_param_count", "get_config", "get_smoke", "param_count",
           "runnable_shapes"]


def _module(name: str):
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
