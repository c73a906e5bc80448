"""Multi-pod dry-run (port of `repro/launch/dryrun.py`): run every (arch x
shape x mesh) cell's step once on a fake 256- or 512-rank mesh with fake
tensors (nothing allocated, no collective moves a byte), and report its
dot flops, collectives and per-rank bytes (`launch/costs.py`).

Where JAX lowers and compiles with ShapeDtypeStruct inputs on 512 host
devices, the port starts torch's `fake` process group (one process
standing for rank 0 of the mesh), places params, optimizer state and
inputs as DTensors by the cell's sharding rules
(`launch/partitioning.py`), and runs the step eagerly under
`FakeTensorMode`: the train step with AdamW state, the prefill, or one
decode step. Fake tensors live on the CPU, so every op takes its plain
path; the attention and scan run shard-local (`models/sharded.py`).
`lower_s` is that run's wall time; nothing is compiled (`compile_s` 0).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
      --shape train_4k [--multi-pod] [--mode serve|serve_2d|train] \
      [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

import torch

from ..configs import ARCHS, SHAPES, get_config, get_shape, long_context_ok
from ..configs.shapes import input_specs
from ..models.api import build_model
from ..models.common import sharding_ctx, tree_map
from ..training.optimizer import AdamWConfig, adamw_init
from ..training.train_step import make_train_step
from .costs import StepProbe, local_bytes, spec_bytes, tree_bytes
from .mesh import fake_world, make_production_mesh, world_size_of
from .partitioning import (SERVE_2D_ARCHS, batch_logical_axes, make_rules,
                           place_tree)


def pick_mode(arch: str, shape_kind: str) -> str:
    if shape_kind == "train":
        return "train"
    # 2D weight sharding only where weights exceed HBM/16 AND the step
    # amortizes the per-layer weight gathers (prefill); decode runs pure TP
    # with the KV cache sharded over (data x model) instead.
    if arch in SERVE_2D_ARCHS and shape_kind == "prefill":
        return "serve_2d"
    return "serve"


def _pad_axes(specs_tree, axes_map):
    """Match axes dict to the spec tree (some entries optional)."""
    return {k: axes_map.get(k, tuple(None for _ in v.shape))
            for k, v in specs_tree.items()}


def _fake(spec_tree):
    """Fake tensors (under the active FakeTensorMode) for a spec tree."""
    return tree_map(lambda s: torch.empty(tuple(s.shape), dtype=s.dtype),
                    spec_tree)


def _run_step(model, shape, specs, rules, p_fake, p_axes, attn_blocks,
              probe):
    """Place the cell's arguments and run its step under `probe`.
    Returns (argument bytes of rank 0, output bytes of rank 0)."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = model.cfg
    params = place_tree(rules, p_fake, p_axes)
    if shape.kind == "decode":
        cache = place_tree(rules, _fake(specs["cache"]),
                           model.cache_logical_axes())
        tokens = place_tree(rules, {"t": _fake(specs["tokens"])},
                            {"t": ("batch",)})["t"]
        args = (params, cache, tokens)
    else:
        kind = "train" if shape.kind == "train" else "prefill"
        b_axes = _pad_axes(specs["batch"], batch_logical_axes(cfg, kind))
        batch = place_tree(rules, _fake(specs["batch"]), b_axes)
        args = (params, batch)
    if shape.kind == "train":
        opt = adamw_init(params)
        args = (params, opt, batch)
    arg_bytes = tree_bytes(args, local_bytes)
    probe.add_resident(arg_bytes)
    with probe, sharding_ctx(rules), implicit_replication():
        if shape.kind == "train":
            step = make_train_step(model, AdamWConfig(),
                                   attn_blocks=attn_blocks)
            out = step(*args)
        elif shape.kind == "prefill":
            with torch.no_grad():
                out = model.prefill(params, batch, max_len=shape.seq_len,
                                    attn_blocks=attn_blocks)
        else:
            with torch.no_grad():
                out = model.decode_step(*args)
    return arg_bytes, tree_bytes(out, local_bytes)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               mode: str | None = None, attn_blocks=(512, 512),
               opts: tuple = (), extras: Dict[str, Any] | None = None,
               cfg=None, shape=None):
    """One cell's record. `cfg` / `shape` (a `ModelConfig` /
    `ShapeConfig`) replace the registry's, for reduced cells."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    if shape_name == "long_500k" and not long_context_ok(cfg):
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": "pure full-attention arch; long_500k requires "
                          "sub-quadratic attention (see DESIGN.md)"}
    mode = mode or pick_mode(arch, shape.kind)
    model = build_model(cfg)
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    p_shapes, p_axes = model.param_axes(dtype)
    specs = input_specs(cfg, shape)
    with fake_world(world_size_of(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = make_rules(mesh, mode, opts=opts)
        # MoE dispatch: shard-local for PREFILL (per-layer weight gathers
        # amortize over 32k tokens); decode and training keep the plain
        # dispatch (JAX `dryrun.py`).
        if shape.kind == "prefill" and "moe_pjit" not in opts:
            rules.moe_shard_map = True
        probe = StepProbe()
        t0 = time.time()
        with FakeTensorMode():
            arg_b, out_b = _run_step(model, shape, specs, rules,
                                     _fake(p_shapes), p_axes, attn_blocks,
                                     probe)
        t_lower = time.time() - t0
        n_dev = mesh.size
    rec_c = probe.record()
    arg_global = spec_bytes(p_shapes)
    if shape.kind == "train":
        arg_global = 3 * arg_global + 4 + spec_bytes(specs["batch"])
    elif shape.kind == "prefill":
        arg_global += spec_bytes(specs["batch"])
    else:
        arg_global += spec_bytes(specs["cache"]) + spec_bytes(
            {"t": specs["tokens"]})
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mode": mode, "status": "ok",
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "memory": {                # rank 0, eager plain path
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": rec_c["peak_bytes"] - arg_b,
            "peak_bytes": rec_c["peak_bytes"],
        },
        "cost": {                  # per rank: global counts / ranks
            "flops": rec_c["dot_flops"] / n_dev,
            "bytes_accessed": rec_c["struct_bytes"] / n_dev,
            "transcendentals": None,
        },
        "cost_corrected": {        # global, every loop unrolled
            "dot_flops": rec_c["dot_flops"],
            "struct_bytes": rec_c["struct_bytes"],
            "arg_bytes": float(arg_global),
        },
        "collectives": rec_c["collectives"],
        "collectives_corrected": rec_c["collectives"],
        "n_devices": n_dev,
        "fallbacks": rec_c["fallbacks"],
        "collective_ops": probe.ops,
    }
    if extras:
        rec.update(extras)
    return rec


def iter_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default=None)
    ap.add_argument("--attn-block", type=int, default=512)
    ap.add_argument("--opt", default="",
                    help="comma list of optimization flags set on the rules "
                         "(e.g. moe_shard_map)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, mp) for a, s in iter_cells() for mp in (False, True)]
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]

    results = []
    for arch, shape, mp in cells:
        tag = f"{arch} x {shape} {'pod2' if mp else 'pod1'}"
        try:
            opts = tuple(o for o in args.opt.split(",") if o)
            rec = lower_cell(arch, shape, multi_pod=mp, mode=args.mode,
                             attn_blocks=(args.attn_block, args.attn_block),
                             opts=opts,
                             extras={"opts": list(opts)} if opts else None)
            rec.pop("collective_ops", None)   # per op: diagnose reads it
            print(f"[dryrun] {tag}: {rec['status']} "
                  f"(lower {rec.get('lower_s', '-')}s, "
                  f"compile {rec.get('compile_s', '-')}s)", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            print(f"[dryrun] {tag}: ERROR {rec['error'][:500]}", flush=True)
        results.append(rec)

    out = args.out or "experiments/dryrun.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results if len(results) > 1 else results[0], f, indent=1)
    print(f"[dryrun] wrote {out}")
    bad = [r for r in results if r["status"] == "error"]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
