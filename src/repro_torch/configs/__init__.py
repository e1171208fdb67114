"""Architecture registry of the port: its own copies of the reference's
ten configs (``repro/configs``), registered in the reference's order."""

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-2b": "internvl2_2b",
    "yi-6b": "yi_6b",
    "nemotron-4-15b": "nemotron_4_15b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-370m": "mamba2_370m",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
