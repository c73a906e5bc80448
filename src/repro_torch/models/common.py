"""Shared model-building blocks and the logical-axis sharding context
(port of `repro/models/common.py`).

Every parameter is made through `param()` with *logical* axis names and
comes back as a `Box` (value + axes); `Model.init` splits the tree into
plain tensors, `Model.param_axes` into the axes. A thread-level context
installed by a launcher (`sharding_ctx`) maps logical axes to mesh axes
with the JAX package's divisibility-aware fallback (`ShardingRules`).
With no context, or on a plain tensor, `shard` is the identity, so model
code never mentions a mesh; on a DTensor it redistributes to the
resolved placements (JAX `with_sharding_constraint`).

`param` draws from an explicit `torch.Generator` at the JAX package's
init scales; the draws differ from `jax.random`, so parity tests carry
JAX weights over with `repro_torch.weights.from_jax` instead. On the
`meta` device it allocates nothing and draws nothing (`eval_axes`).
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache leaf (JAX's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Logical-axis sharding context
# ---------------------------------------------------------------------------

_tls = threading.local()


class ShardingRules:
    """logical axis -> ordered list of candidate mesh axes (or None).

    `mesh` needs only `.shape`, a mapping of mesh-dim name to size (the
    port's meshes expose it); a `DeviceMesh` with named dims is also read
    from `.dim_names` for `shard` and `placements`."""

    def __init__(self, mesh, rules: Dict[str, Sequence[Optional[str]]]):
        self.mesh = mesh
        self.rules = rules

    def resolve(self, logical: Sequence[Optional[str]],
                shape: Sequence[int]) -> Tuple:
        """The PartitionSpec as a tuple: one entry per leading tensor dim
        (a mesh-dim name, a tuple of names, or None), trailing Nones
        dropped. The first candidate whose axes are unused in the spec and
        whose size divides the dim wins."""
        used = set()
        out = []
        for dim, name in zip(shape, logical):
            pick = None
            for cand in self.rules.get(name, (None,)) if name else (None,):
                if cand is None:
                    break
                axes = cand if isinstance(cand, tuple) else (cand,)
                if any(a in used for a in axes):
                    continue
                size = math.prod(self.mesh.shape[a] for a in axes)
                if dim % size == 0:
                    pick = cand
                    used.update(axes)
                    break
            out.append(pick)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements(self, logical, shape) -> Tuple:
        """DTensor placements of the resolved spec over `self.mesh`."""
        return spec_placements(self.resolve(logical, shape),
                               mesh_dim_names(self.mesh))


def mesh_dim_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def spec_placements(spec, dim_names) -> Tuple:
    """PartitionSpec entries -> one placement per mesh dim: each mesh dim
    named in a tensor dim's entry gets `Shard(that dim)`, every other mesh
    dim `Replicate()`. A tuple entry such as ("pod", "data") shards one
    tensor dim over several mesh dims in mesh order, which is JAX's
    major-to-minor order on a (pod, data, model) mesh."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(dim_names)
    for tdim, e in enumerate(spec):
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            out[dim_names.index(a)] = Shard(tdim)
    return tuple(out)


@contextlib.contextmanager
def sharding_ctx(rules: Optional[ShardingRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield
    finally:
        _tls.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


_DTENSOR = []


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (the class imported once, on first use)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain an activation's sharding: the identity without an active
    context or on a plain tensor; on a DTensor, a redistribute to the
    resolved placements."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, rules.placements(logical, x.shape))


# ---------------------------------------------------------------------------
# Param creation with logical axes metadata
# ---------------------------------------------------------------------------

class Box:
    """A param leaf carrying its logical axes until the tree is split."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes):
        self.value = value
        self.axes = tuple(axes)


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def param(gen: torch.Generator, shape, axes, *, device, dtype=torch.float32,
          scale: Optional[float] = None, init: str = "normal",
          stack: int = 0) -> Box:
    """One parameter (or `stack` stacked copies, leading "layers" axis)
    with its logical `axes` and the scales of
    `repro/models/common.py::param`: normal * 1/sqrt(fan_in), fan_in =
    shape[-2] (shape[-1] for vectors), unless `scale` is given.

    Drawn in f32. A stacked leaf of another `dtype` is drawn a layer at a
    time into a tensor of that dtype, so a bf16 model's peak stays near
    its bf16 size (moonshot-v1-16b-a3b's expert `wi` alone is 69 GB in
    f32)."""
    assert len(shape) == len(axes), (shape, axes)
    axes = (("layers",) if stack else ()) + tuple(axes)
    full = ((stack,) if stack else ()) + tuple(shape)
    if _is_meta(device):
        return Box(torch.empty(full, device="meta", dtype=dtype), axes)
    if init == "zeros":
        return Box(torch.zeros(full, device=device, dtype=dtype), axes)
    if init == "ones":
        return Box(torch.ones(full, device=device, dtype=dtype), axes)
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
    if stack and dtype != torch.float32:
        out = torch.empty(full, device=device, dtype=dtype)
        for l in range(stack):
            out[l] = param(gen, shape, axes[1:], device=device,
                           scale=scale).value
        return Box(out, axes)
    v = torch.randn(full, generator=gen, device=device, dtype=torch.float32)
    v.mul_(scale)       # in place: no second full-size temporary
    return Box(v if dtype == torch.float32 else v.to(dtype), axes)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts (several trees of one
    structure in step)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def split_boxes(tree) -> Tuple[Any, Any]:
    """(params, axes) from a tree with Box leaves."""
    return (tree_map(lambda b: b.value, tree),
            tree_map(lambda b: b.axes, tree))


def eval_axes(init_fn, *args, **kw) -> Any:
    """The axes tree without allocating params: `init_fn(*args, **kw,
    device="meta")` (the port's `eval_shape` of the init)."""
    return split_boxes(init_fn(*args, device="meta", **kw))[1]


def remat_layer(fn, remat: bool):
    """A layer body `fn` that keeps nothing for the backward and is run
    again there (JAX `jax.checkpoint` with `nothing_saveable`, per layer):
    `torch.utils.checkpoint.checkpoint(fn, ..., use_reentrant=False)`
    where `remat` and grad mode is on; `fn` itself otherwise."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def layer_of(tree, l: int):
    """Layer `l` of stacked params (leading layer axis; views, no copy)."""
    return {k: layer_of(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def rmsnorm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)    # gemma-style (1+w)


def layernorm(x, w, b, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(x, p, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def norm_params(gen, d, cfg, axes=("embed",), *, device, stack: int = 0,
                dtype=torch.float32):
    kw = dict(device=device, stack=stack, dtype=dtype)
    if cfg.norm_type == "layernorm":
        return {"w": param(gen, (d,), axes, init="ones", **kw),
                "b": param(gen, (d,), axes, init="zeros", **kw)}
    return {"w": param(gen, (d,), axes, init="zeros", **kw)}  # (1+w) form


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, theta, fraction=1.0, interleaved=False):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, fraction, theta, device=x.device)
    ang = positions[..., None].float() * inv            # (..., S, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    dt = x.dtype
    xr, xp = x[..., :rot].float(), x[..., rot:]
    if interleaved:
        x0, x1 = xr[..., 0::2], xr[..., 1::2]
        r0 = x0 * cos - x1 * sin
        r1 = x1 * cos + x0 * sin
        xr = torch.stack([r0, r1], dim=-1).reshape(xr.shape)
    else:
        half = rot // 2
        x0, x1 = xr[..., :half], xr[..., half:]
        xr = torch.cat([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return torch.cat([xr.to(dt), xp], dim=-1) if rot < hd else xr.to(dt)


def embed_lookup(table, tokens):
    """Embedding lookup; with the `onehot_embed` opt active (decode paths),
    a one-hot contraction, so a vocab-sharded table is reduced as (B, d)
    partials instead of gathered whole (JAX `embed_lookup`)."""
    rules = current_rules()
    if rules is not None and getattr(rules, "onehot_embed", False):
        onehot = F.one_hot(tokens, table.shape[0]).to(table.dtype)
        return onehot @ table
    return table[tokens]
