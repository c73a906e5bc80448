"""The port's sharding vocabulary against the JAX package's: the resolved
spec of every param, cache and batch leaf, for every arch, mode, mesh and
opts; `input_specs` of every cell; `pick_mode` / `iter_cells`; the
resolver's property; and how a spec maps to DTensor placements.

JAX's `make_rules` reads only `mesh.shape`, so both packages resolve
against a stub mesh: no devices and no process group are needed.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as JX_ARCHS, SHAPES as JX_SHAPES
from repro.configs import get_config as jx_get_config
from repro.configs import long_context_ok as jx_long_ok
from repro.configs.shapes import input_specs as jx_input_specs
from repro.launch.dryrun import iter_cells as jx_iter_cells
from repro.launch.dryrun import pick_mode as jx_pick_mode
from repro.launch.partitioning import batch_logical_axes as jx_batch_axes
from repro.launch.partitioning import make_rules as jx_make_rules
from repro.models.api import build_model as jx_build
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.shapes import ENCDEC_SRC_LEN, input_specs
from repro_torch.launch.dryrun import iter_cells, pick_mode
from repro_torch.launch.mesh import (Mesh, fake_world, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.launch.partitioning import (SERVE_2D_ARCHS,
                                             batch_logical_axes, make_rules,
                                             tree_shardings)
from repro_torch.models.api import build_model
from repro_torch.models.common import ShardingRules, spec_placements

MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}
OPTS = [(), ("decode_weight_stationary",), ("kv_seq_data_only",)]
MODES = ["train", "serve", "serve_2d"]


class StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


def _jflat(tree, is_leaf=None):
    return {"".join(f"/{p.key}" for p in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _leaves(arch):
    """{name: (shape, logical axes)} of the arch's params, decode cache
    and train/prefill inputs, from each package."""
    jcfg, tcfg = jx_get_config(arch), get_config(arch)
    jm, tm = jx_build(jcfg), build_model(tcfg)
    js, ja = jm.param_axes()
    ts, ta = tm.param_axes()
    jl = {("p" + k): (tuple(s.shape), _jflat(ja, _is_axes)[k])
          for k, s in _jflat(js).items()}
    tl = {("p" + k): (tuple(s.shape), _flat(ta)[k])
          for k, s in _flat(ts).items()}
    kw = {"src_len": ENCDEC_SRC_LEN} if jcfg.family == "encdec" else {}
    jc, tc = jm.cache_specs(128, 32768, **kw), tm.cache_specs(128, 32768,
                                                              **kw)
    jca, tca = jm.cache_logical_axes(), tm.cache_logical_axes()
    jl.update({("c" + k): (tuple(s.shape), _jflat(jca, _is_axes)[k])
               for k, s in _jflat(jc).items()})
    tl.update({("c" + k): (tuple(s.shape), _flat(tca)[k])
               for k, s in _flat(tc).items()})
    for shape in JX_SHAPES:
        if shape.kind == "decode":
            continue
        kind = "train" if shape.kind == "train" else "prefill"
        jb = jx_input_specs(jcfg, shape)["batch"]
        tb = input_specs(tcfg, shape)["batch"]
        jax_ax, t_ax = jx_batch_axes(jcfg, kind), batch_logical_axes(tcfg,
                                                                     kind)
        for k in jb:
            jl[f"b/{shape.name}/{k}"] = (tuple(jb[k].shape), jax_ax.get(
                k, (None,) * len(jb[k].shape)))
        for k in tb:
            tl[f"b/{shape.name}/{k}"] = (tuple(tb[k].shape), t_ax.get(
                k, (None,) * len(tb[k].shape)))
    return jl, tl


@pytest.mark.parametrize("arch", list(JX_ARCHS))
def test_resolved_specs_equal_jax(arch):
    """Every leaf's resolved spec, for every mode x mesh x opts."""
    jl, tl = _leaves(arch)
    assert jl == tl
    for mname, mshape in MESHES.items():
        for mode in MODES:
            for opts in OPTS:
                jr = jx_make_rules(StubMesh(mshape), mode, opts=opts)
                tr = make_rules(StubMesh(mshape), mode, opts=opts)
                for name, (shape, axes) in jl.items():
                    want = tuple(jr.resolve(axes, shape))
                    got = tr.resolve(axes, shape)
                    assert got == want, (arch, mname, mode, opts, name)
                for o in opts:
                    assert getattr(tr, o) is True


def test_input_specs_equal_jax_for_every_cell():
    """Shapes and dtypes of every cell's inputs, as JAX's
    `tests/test_system.py::test_input_specs_cover_all_cells` walks them."""
    dt = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}
    n = 0
    for name in JX_ARCHS:
        for shape in JX_SHAPES:
            if shape.name == "long_500k" and not jx_long_ok(
                    jx_get_config(name)):
                continue
            js = _jflat(jx_input_specs(jx_get_config(name), shape))
            ts = _flat(input_specs(get_config(name), shape))
            assert js.keys() == ts.keys(), (name, shape.name)
            for k in js:
                assert tuple(js[k].shape) == tuple(ts[k].shape), (name, k)
                assert dt[js[k].dtype.type] == ts[k].dtype, (name, k)
                n += 1
    assert n > 0


def test_pick_mode_and_cells_equal_jax():
    assert list(iter_cells()) == list(jx_iter_cells())
    for arch in JX_ARCHS:
        for kind in ("train", "prefill", "decode"):
            assert pick_mode(arch, kind) == jx_pick_mode(arch, kind)
    assert set(SERVE_2D_ARCHS) == {"mixtral-8x22b", "internvl2-76b"}
    assert [s.name for s in SHAPES] == [s.name for s in JX_SHAPES]


@given(st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 32, 48, 64, 100,
                                 128, 256, 1024]),
                min_size=1, max_size=4))
@settings(max_examples=60, deadline=None)
def test_partition_rules_valid_specs(dims):
    """Resolved specs never shard a non-divisible dim and never reuse a
    mesh axis within one spec (JAX `tests/test_properties.py`)."""
    mesh = StubMesh({"data": 16, "model": 16})
    rules = make_rules(mesh, "train")
    logical = ["batch", "embed", "mlp", "heads"][: len(dims)]
    spec = rules.resolve(logical, dims)
    used = []
    for entry, dim in zip(spec + (None,) * (len(dims) - len(spec)), dims):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        assert dim % math.prod(mesh.shape[a] for a in axes) == 0
        for a in axes:
            assert a not in used
            used.append(a)
    assert spec == tuple(jx_make_rules(mesh, "train").resolve(logical, dims))


def test_spec_to_placements():
    """Each mesh dim named in a tensor dim's entry shards that dim; a
    tuple entry shards one dim over several mesh dims in mesh order; the
    rest replicate."""
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert spec_placements((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_placements((None, ("data", "model")), names) == (
        Replicate(), Shard(1), Shard(1))
    assert spec_placements((), names) == (Replicate(),) * 3
    rules = make_rules(StubMesh(MESHES["pod2"]), "serve")
    shapes = {"w": torch.empty(4096, 11008), "v": torch.empty(3)}
    axes = {"w": ("embed", "mlp"), "v": ("heads",)}
    got = tree_shardings(rules, shapes, axes)
    assert got == {"w": (Replicate(), Shard(1), Shard(1)),
                   "v": (Replicate(),) * 3}


def test_param_axes_allocate_nothing_and_init_stays_plain():
    """`param_axes` runs the init on the meta device (internvl2-76b's 76 B
    params take no memory); `Model.init` still returns plain tensors."""
    shapes, axes = build_model(get_config("internvl2-76b")).param_axes()
    leaves = list(_flat(shapes).values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 70e9
    m = build_model(get_config("yi-6b").replace(
        num_layers=1, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256))
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in _flat(params).values())
    bf = m.param_axes(torch.bfloat16)[0]
    assert all(t.dtype == torch.bfloat16 for t in _flat(bf).values())


def test_meshes_on_the_fake_backend():
    """The production meshes need a process group of as many ranks (as
    `jax.make_mesh` needs devices); `fake_world` starts one and tears it
    down, also when its body raises."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError):
        make_production_mesh()
    assert make_debug_mesh().shape == {"data": 1, "model": 1}
    with fake_world(256):
        m = make_production_mesh()
        assert m.shape == {"data": 16, "model": 16} and m.size == 256
        assert m.device_mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError):
            make_production_mesh(multi_pod=True)       # 512 > 256
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_world(512):
            m = make_production_mesh(multi_pod=True)
            assert m.shape == {"pod": 2, "data": 16, "model": 16}
            raise ValueError("body fails")
    assert not dist.is_initialized()


def test_shard_is_identity_without_rules_or_on_plain_tensors():
    from repro_torch.models.common import shard, sharding_ctx
    x = torch.ones(4, 8)
    assert shard(x, "batch", "embed_act") is x
    rules = ShardingRules(Mesh({"data": 2, "model": 2}), {"batch": ["data"]})
    with sharding_ctx(rules):
        assert shard(x, "batch", "embed_act") is x
        assert rules.resolve(("batch", None), (4, 8)) == ("data",)
    np.testing.assert_equal(rules.resolve(("batch",), (3,)), ())
