"""The port's mesh dispatches of the routed experts against the JAX
package's, on the CPU with the JAX params carried over: the grouped
dispatch (`moe_apply_grouped`, G = gcd(T, pod x data) token groups, each
with its own capacity and drops) against JAX's at G = 4 on plain tensors;
both dispatches on DTensors over a real 4-rank `gloo` group, (2, 2) data
x model (`models/sharded.py::moe_shard_local`, run by
`tests/torch_sharded_worker.py`), the shard-local one against JAX's
`moe_apply_shard_map` run on 4 host devices in a subprocess, the grouped
one against JAX's at G = 2; and `moe_apply`'s choice between them from
the rules' flags. Tolerance f32 5e-5 (`tests/test_kernels.py:16`)."""
from __future__ import annotations

import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.launch.partitioning import make_rules as jx_make_rules
from repro.models import moe as jx_moe
from repro.models.common import keygen, split_boxes
from repro_torch.configs import get_config
from repro_torch.launch.partitioning import make_rules
from repro_torch.models import moe as tx_moe
from repro_torch.models.common import sharding_ctx
from repro_torch.weights import from_jax
from torch_sharded_worker import run_worker, worker_env

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
ARCH = "moonshot-v1-16b-a3b-smoke"
CF = 0.5                                  # tight capacity: tokens drop


class StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _inputs(B=2, S=64, seed=0):
    cfg = jx_get_config(ARCH)
    jp, _ = split_boxes(jx_moe.moe_params(keygen(jax.random.PRNGKey(seed)),
                                          cfg))
    jp = jax.tree.map(np.asarray, jp)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jp, x


def _routed_drops(p, x, cfg, groups):
    """Tokens past an expert's capacity, summed over `groups` groups."""
    d = x.shape[-1]
    xg = x.reshape(groups, -1, d)
    C = tx_moe.capacity(xg.shape[1], cfg, CF)
    k, E = cfg.moe.num_experts_per_tok, cfg.moe.num_experts
    drops = 0
    for g in range(groups):
        logits = xg[g] @ p["router"]
        top = np.argsort(-logits, axis=-1, kind="stable")[:, :k].reshape(-1)
        counts = np.bincount(top, minlength=E)
        drops += int(np.maximum(counts - C, 0).sum())
    return drops


def test_grouped_dispatch_equals_jax():
    """G = gcd(128 tokens, 4 batch shards) = 4 groups of 32 tokens with
    capacity max(ceil(32 * 2 / 4 * 0.5), 8) = 8: drops in every layout."""
    jp, x = _inputs()
    cfg = get_config(ARCH)
    assert _routed_drops(jp, x, cfg, 4) > 0
    shape = {"data": 4, "model": 1}
    jrules = jx_make_rules(StubMesh(shape), "train")
    jo, ja = jax.jit(lambda p, x: jx_moe.moe_apply_grouped(
        p, x, jx_get_config(ARCH), jrules, CF))(jp, x)
    to, ta = tx_moe.moe_apply_grouped(from_jax(jp), torch.from_numpy(x), cfg,
                                      make_rules(StubMesh(shape), "train"),
                                      CF)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    # the groups route on their own: not the plain dispatch's output
    po, _ = tx_moe._moe_apply_pjit(from_jax(jp), torch.from_numpy(x), cfg,
                                   CF)
    assert not torch.allclose(po, to, atol=1e-3)


_JAX_SHARD_MAP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.partitioning import make_rules
    from repro.models import moe
    d = dict(np.load(sys.argv[1]))
    cfg = get_config(%r)
    p = {k[2:]: v for k, v in d.items() if k.startswith("p_")}
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh, "train")
    with mesh:
        out, aux = jax.jit(lambda p, x: moe.moe_apply_shard_map(
            p, x, cfg, rules, %r))(p, d["x"])
    np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux))
""" % (ARCH, CF))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """JAX's shard_map on 4 host devices and the port's two dispatches on
    4 gloo ranks, both over a (2, 2) data x model mesh, run side by side
    on the same params and tokens (B=4, S=32: each data shard routes its
    64 tokens with its own capacity, drops included)."""
    tmp = tmp_path_factory.mktemp("moe4")
    jp, x = _inputs(B=4, S=32, seed=3)
    assert _routed_drops(jp, x, get_config(ARCH), 2) > 0
    np.savez(tmp / "jax_in.npz", x=x,
             **{f"p_{k}": v for k, v in jp.items()})
    np.savez(tmp / "in.npz", moe_x=x, moe_arch=np.array(ARCH),
             moe_cf=np.array(CF), **{f"moe_p_{k}": v for k, v in jp.items()})
    jx = subprocess.Popen([sys.executable, "-c", _JAX_SHARD_MAP,
                           str(tmp / "jax_in.npz"), str(tmp / "jax_out.npz")],
                          env=worker_env())
    tw = run_worker(tmp / "in.npz", tmp / "out.npz", "moe")
    assert tw.wait(timeout=600) == 0
    assert jx.wait(timeout=600) == 0
    return jp, x, dict(np.load(tmp / "jax_out.npz")), \
        dict(np.load(tmp / "out.npz"))


def test_shard_local_dispatch_equals_jax_on_four_devices(four_ranks):
    """The port's `moe_apply_shard_map` on DTensors (each rank routing its
    own batch shard through the expert weights on the "model" sub-mesh)
    against JAX's shard_map."""
    _, _, want, got = four_ranks
    np.testing.assert_allclose(got["moe_shard_map"], want["out"], **F32)
    np.testing.assert_allclose(got["moe_shard_map_aux"], want["aux"], **F32)


def test_grouped_dispatch_on_four_ranks_equals_jax(four_ranks):
    """`moe_apply_grouped` on DTensors: G = gcd(128, 2) = 2 groups, one a
    data shard, against JAX's at the same mesh shape."""
    jp, x, _, got = four_ranks
    shape = {"data": 2, "model": 2}
    jo, ja = jax.jit(lambda p, x: jx_moe.moe_apply_grouped(
        p, x, jx_get_config(ARCH), jx_make_rules(StubMesh(shape), "train"),
        CF))(jp, x)
    np.testing.assert_allclose(got["moe_grouped"], np.asarray(jo), **F32)
    np.testing.assert_allclose(got["moe_grouped_aux"], float(ja), **F32)


@pytest.mark.parametrize("flags,want", [
    ((), "pjit"), (("moe_shard_map",), "shard_map"),
    (("moe_grouped",), "grouped"), (("moe_grouped", "moe_shard_map"),
                                    "grouped")])
def test_moe_apply_picks_the_dispatch_from_the_rules(monkeypatch, flags,
                                                     want):
    """`moe_grouped` > `moe_shard_map` > the plain dispatch (JAX
    `moe_apply`); no rules: the plain dispatch."""
    seen = []
    for name, tag in (("moe_apply_grouped", "grouped"),
                      ("moe_apply_shard_map", "shard_map"),
                      ("_moe_apply_pjit", "pjit")):
        monkeypatch.setattr(tx_moe, name,
                            lambda *a, _t=tag, **k: seen.append(_t))
    rules = make_rules(StubMesh({"data": 2, "model": 2}), "serve")
    for f in flags:
        setattr(rules, f, True)
    x = torch.zeros(1, 2, 4)
    with sharding_ctx(rules):
        tx_moe.moe_apply({}, x, None)
    tx_moe.moe_apply({}, x, None)
    assert seen == [want, "pjit"]
