"""The port's dry-run tools against the JAX package's: `cost_corrected.
dot_flops` of small train, prefill and decode cells against JAX's
`jaxpr_costs` (integer for integer), the committed full-width figures of
`tests/torch_dryrun_jax_flops.json` regenerated from JAX, the probe on a
crafted sharded product, the record and the CLI, the collectives report,
`diagnose --serve-metrics` against JAX's metric names and counts, and the
train launcher on the production mesh.

Each fake process group is torn down in `fake_world`'s `finally`, so an
xdist worker that runs several of these tests reuses a clean process.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs import get_shape as jx_get_shape
from repro.configs.archs import smoke as jx_smoke
from repro.configs.base import ShapeConfig as JxShape
from repro.configs.shapes import input_specs as jx_input_specs
from repro.launch.costs import jaxpr_costs
from repro.launch.dryrun import lower_cell as jx_lower_cell
from repro.models.api import build_model as jx_build
from repro.training.optimizer import AdamWConfig as JxAdamW
from repro.training.optimizer import adamw_init as jx_adamw_init
from repro.training.train_step import make_train_step as jx_train_step
from repro_torch.configs import get_config
from repro_torch.configs.archs import smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.costs import StepProbe
from repro_torch.launch.diagnose import collectives_report, serve_metrics
from repro_torch.launch.mesh import fake_world, make_production_mesh

FLOPS_FILE = os.path.join(os.path.dirname(__file__),
                          "torch_dryrun_jax_flops.json")
SMOKE_ARCHS = ["yi-6b", "gemma3-1b", "mamba2-2.7b", "moonshot-v1-16b-a3b"]
BLOCKS = (16, 16)


def jax_cell_costs(cfg, shape, attn_blocks=(512, 512)):
    """JAX's `jaxpr_costs` of a cell's step with no mesh, as
    `repro/launch/dryrun.py::lower_cell` builds it."""
    model = jx_build(cfg)
    ps, _ = model.param_axes()
    specs = jx_input_specs(cfg, shape)
    if shape.kind == "train":
        step = jx_train_step(model, JxAdamW(), attn_blocks=attn_blocks)
        opt = jax.eval_shape(jx_adamw_init, ps)
        return jaxpr_costs(step, ps, opt, specs["batch"])
    ps = jax.eval_shape(lambda p: model.cast(p, jnp.bfloat16), ps)
    if shape.kind == "prefill":
        return jaxpr_costs(
            lambda p, b: model.prefill(p, b, max_len=shape.seq_len,
                                       attn_blocks=attn_blocks),
            ps, specs["batch"])
    return jaxpr_costs(lambda p, c, t: model.decode_step(p, c, t), ps,
                       specs["cache"], specs["tokens"])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_dot_flops_equal_jaxpr_costs(arch, kind):
    """One layer of each smoke arch (two for moonshot: a dense layer and
    a MoE one), 32 x 64 tokens, 16-row attention tiles: the port's count
    on the fake 16 x 16 mesh equals JAX's global count, and so do the
    argument bytes. The MoE prefill takes the plain dispatch (`moe_pjit`)
    JAX's no-mesh count runs."""
    n = 2 if arch.startswith("moonshot") else 1
    jcfg = jx_smoke(jx_get_config(arch)).replace(num_layers=n)
    tcfg = smoke(get_config(arch)).replace(num_layers=n)
    jc = jax_cell_costs(jcfg, JxShape("x", 64, 32, kind), BLOCKS)
    rec = dryrun.lower_cell(arch, "x", multi_pod=False, attn_blocks=BLOCKS,
                            opts=("moe_pjit",), cfg=tcfg,
                            shape=ShapeConfig("x", 64, 32, kind))
    assert rec["status"] == "ok"
    assert rec["cost_corrected"]["dot_flops"] == int(jc["flops"])
    assert rec["cost_corrected"]["arg_bytes"] == jc["arg_bytes"]
    assert rec["collectives_corrected"] == rec["collectives"]


def test_committed_jax_flops_are_current():
    """`tests/torch_dryrun_jax_flops.json` (what `chip_smoke.py` holds the
    full-width cells to) equals JAX's `jaxpr_costs` recomputed now."""
    with open(FLOPS_FILE) as f:
        committed = json.load(f)["dot_flops"]
    assert {"yi-6b/train_4k", "yi-6b/prefill_32k", "yi-6b/decode_32k",
            "mamba2-2.7b/long_500k", "zamba2-7b/train_4k",
            "seamless-m4t-large-v2/train_4k"} <= set(committed)
    for cell, want in committed.items():
        arch, shape = cell.split("/")
        got = jax_cell_costs(jx_get_config(arch), jx_get_shape(shape))
        assert int(got["flops"]) == want, cell


def test_probe_counts_a_sharded_product_once():
    """A product sharded on both mesh dims counts 2*M*K*N flops (its
    global shape, not also the local one), and its FSDP operand's one
    all-gather over the data dim: 512 x 16 f32 gathered, 15/16 on the
    wire."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, \
        distribute_tensor
    with fake_world(256):
        dm = make_production_mesh().device_mesh
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(1024, 512), dm,
                                  [Shard(0), Replicate()])
            b = distribute_tensor(torch.empty(512, 256), dm,
                                  [Shard(0), Shard(1)])
            with StepProbe() as probe:
                c = a @ b
    assert tuple(c.placements) == (Shard(0), Shard(1))
    assert probe.flops == 2 * 1024 * 512 * 256
    assert [(o["kind"], o["bytes"], o["group"], o["wire"])
            for o in probe.ops] == [("all-gather", 512 * 16 * 4, 16,
                                     512 * 16 * 4 * 15 / 16)]


def test_record_keys_skip_and_cli(tmp_path):
    """The record keeps JAX's keys; a pure full-attention arch skips
    long_500k with JAX's record; the CLI exits 0 without errors and 1
    with one."""
    rec = dryrun.lower_cell("yi-6b", "x", multi_pod=True, attn_blocks=BLOCKS,
                            cfg=smoke(get_config("yi-6b")).replace(
                                num_layers=1),
                            shape=ShapeConfig("x", 32, 32, "decode"))
    for k in ("arch", "shape", "multi_pod", "mode", "status", "lower_s",
              "compile_s", "memory", "cost", "cost_corrected",
              "collectives", "collectives_corrected", "n_devices"):
        assert k in rec, k
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes_accessed",
                                "transcendentals"}
    assert set(rec["cost_corrected"]) == {"dot_flops", "struct_bytes",
                                          "arg_bytes"}
    assert rec["n_devices"] == 512 and rec["mode"] == "serve"
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert collectives_report(rec, 3) == sorted(collectives_report(rec, 3),
                                                reverse=True)
    skip = dryrun.lower_cell("yi-6b", "long_500k", multi_pod=False)
    assert skip == jx_lower_cell("yi-6b", "long_500k", multi_pod=False)
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                     "--out", str(out)])
    assert e.value.code == 0 and json.loads(out.read_text())["status"] \
        == "skipped"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", str(out)])
    assert e.value.code == 1


def _prometheus(text):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^([a-zA-Z_][\w]*(?:\{[^}]*\})?) ([-0-9.e+infa]+)$", text, re.M)}


def test_serve_metrics_equal_jax_names_and_counts():
    """`diagnose --serve-metrics` on yi-6b-smoke: the same metric names as
    JAX's and consistent request counts (finished + shed = the 10-request
    burst); times, sheds and the per-replica split depend on the clock."""
    from repro.launch.diagnose import serve_metrics as jx_serve_metrics
    outs, texts = [], ""
    for fn, kw in ((jx_serve_metrics, {}), (serve_metrics,
                                            {"device": "cpu"})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn("yi-6b-smoke", **kw)
        outs.append(_prometheus(buf.getvalue()))
        texts += buf.getvalue()
    jm, tm = outs

    def names(m):
        # which replica serves a request depends on the clock, and one that
        # served none has no latency histograms: compare without its number
        return {re.sub(r"replica\d+", "replicaN", k) for k in m}
    # a counter is exported once it counts (the router's sheds depend on
    # the clock too): one only one side exports read zero on the other
    counters = names(re.findall(r"^# TYPE (\S+) counter$", texts, re.M))
    assert not ((names(jm) ^ names(tm)) - counters) and len(jm) > 50
    # the router sheds by the wall clock, so how many of the 10 finish
    # differs from run to run; in each, every request is finished or shed
    # and the counts agree with each other
    for m in (jm, tm):
        fin = m["repro_requests_finished"]
        assert fin + m.get("repro_requests_shed", 0) == 10
        assert m["repro_e2e_s_count"] == fin
        assert m["repro_fleet_requests_finished"] == fin


def test_train_launcher_on_the_production_mesh():
    """`--mesh pod1` places params and AdamW state by the train rules and
    steps on DTensors (the fake backend's collectives move nothing, so
    the losses are not the model's); `--mesh debug` is unchanged."""
    from torch.distributed.tensor import Shard
    from repro_torch.launch import train
    seen = {}
    real = train._sharded_step

    def spy(step_fn, rules, params, opt_state, batch):
        seen["embed"] = params["embed"].placements
        seen["m"] = opt_state["m"]["embed"].placements
        seen["tokens"] = batch["tokens"].placements
        return real(step_fn, rules, params, opt_state, batch)

    train._sharded_step = spy
    try:
        with fake_world(256):
            losses = train.run("yi-6b-smoke", 1, 32, 16, None, 0, "pod1",
                               device="cpu")
    finally:
        train._sharded_step = real
    assert len(losses) == 1
    # embed (vocab 256, d 64): vocab over "model", d over "data" (FSDP)
    assert tuple(seen["embed"]) == (Shard(1), Shard(0))
    assert tuple(seen["m"]) == tuple(seen["embed"])
    assert tuple(seen["tokens"])[0] == Shard(0)
