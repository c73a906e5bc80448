"""A configuration's model family: the file that builds it for the port.

Each configuration's `family` key names `configs/<family>_model.py`,
found by name as the reference (`configs/<reference>.py`) is. Such a
file gives

  dims(cfg) -> {short name: size}     the sizes the metric readers use
  model_config(cfg)                   the port's `ModelConfig`
  draw_weights(cfg, seed, device)     the weights, in the port's layout
  weight_bytes(cfg) -> int            the served weights' bytes

so that a family with another parameter layout comes as files alone.
"""
from __future__ import annotations

from pathlib import Path
from types import ModuleType
from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def family(cfg: Dict[str, Any], root: Path = None) -> ModuleType:
    """The module of `cfg`'s family, from `root`/configs (default: this
    folder's)."""
    from bench.cell import BENCH, load_module
    return load_module((root or BENCH) / "configs"
                       / f"{cfg['family']}_model.py")
