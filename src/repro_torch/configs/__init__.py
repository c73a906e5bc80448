# Copied unchanged from src/repro/configs/__init__.py.
from .base import (ModelConfig, MoEConfig, SSMConfig, ShapeConfig,
                   SHAPES, SHAPES_BY_NAME, TRAIN_4K, PREFILL_32K,
                   DECODE_32K, LONG_500K, long_context_ok)
from .archs import ARCHS, smoke


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]
