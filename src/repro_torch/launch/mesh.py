"""Mesh construction (port of `repro/launch/mesh.py`).

A `Mesh` names its dims as JAX's does (`.shape` maps name -> size, which
is all `ShardingRules` reads) and holds the `DeviceMesh` its DTensors
live on. Single pod: 16x16 = 256 ranks; multi-pod: 2 pods x 256. The
production meshes use the default process group; `fake_world` starts
torch's `fake` backend (one process standing for every rank, collectives
that move nothing) for the dry-run and the tests.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch.distributed as dist


class Mesh:
    """Named mesh dims over an optional `DeviceMesh` (none for the
    one-device debug mesh)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_mesh(shape, axes, device_type: str = "cpu") -> Mesh:
    """A mesh of `shape` named `axes` over the default process group
    (the first prod(shape) ranks); raises when the group is smaller."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks; none is "
            "initialized")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {world}")
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return Mesh(dict(zip(axes, shape)), dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(shape=(1, 1), axes=("data", "model")) -> Mesh:
    """The one-device mesh: dims of size 1, no process group."""
    assert all(s == 1 for s in shape), shape
    return Mesh(dict(zip(axes, shape)))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Run the body as `rank` of a `fake` process group of `world_size`
    ranks in this one process, and tear the group down again (also when
    the body raises)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def world_size_of(multi_pod: bool) -> int:
    return 512 if multi_pod else 256
