"""Carry parameters over from the JAX package.

`from_jax` takes the JAX param pytree with its leaves already turned into
numpy arrays (`jax.tree.map(np.asarray, params)`, done by the caller so
that this module needs no JAX) and returns the port's param tree: the same
nested dicts, the same shapes and layout, on `device`.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: no numpy->torch path
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax(params_np: Any, device="cpu",
             dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of torch tensors
    (dtype kept unless `dtype` is given for floating leaves)."""
    if isinstance(params_np, dict):
        return {k: from_jax(v, device, dtype) for k, v in params_np.items()}
    return _tensor(params_np, device, dtype)
