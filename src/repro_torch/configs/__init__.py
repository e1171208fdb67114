"""Architecture registry of the port: the archs whose families it serves.

The reference (``repro/configs``) registers ten; the port carries its own
copies of those whose model family it has ported (dense, MoE, ssm and
hybrid) and names the ROADMAP item that ports the others.
"""

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "yi-6b": "yi_6b",
    "nemotron-4-15b": "nemotron_4_15b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-370m": "mamba2_370m",
}

# the reference's other archs: the encoder-decoder and frontend (vision /
# audio prefix) families are not ported yet
_NOT_PORTED = ("seamless-m4t-medium", "internvl2-2b")
NOT_PORTED_ITEM = "ROADMAP.md queue 1 item 18"

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet ({NOT_PORTED_ITEM})")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
