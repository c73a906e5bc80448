"""Training launcher (port of `repro/launch/train.py`): a real loop with
checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b-smoke \
        --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ck --ckpt-every 10

It trains on the card unless `--device` names another device (the CPU
runs every kernel's plain version); with no CUDA device and no `--device`
it raises. It resumes from the latest checkpoint under `--ckpt-dir`, and
logs in the JAX launcher's format. `--mesh debug` is the one device.
`--mesh pod1|pod2` builds the production mesh over the default process
group (16 x 16 or 2 x 16 x 16 ranks, each started with its rank, e.g. by
`torchrun`) and places params, AdamW state and each batch as DTensors
by `make_rules(mesh, "train")`; the step runs under those rules and
`models/sharded.py::ShardedExec`, which runs an op DTensor refuses to
shard on replicated inputs and logs it once by name.
Checkpoints save gathered; a sharded run does not resume
(`training/checkpoint.py`).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models.api import build_model
from ..serving.engine import resolve_device
from ..training import checkpoint as ckpt
from ..training.data import DataConfig, SyntheticTokens
from ..training.optimizer import AdamWConfig, adamw_init
from ..training.train_step import make_train_step
from .mesh import make_production_mesh
from .partitioning import (batch_logical_axes, make_rules, place_tree,
                           tree_shardings)


def _gathered(tree):
    from ..models.common import is_dtensor, tree_map
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


_LOGGED: set = set()


def _log_fallback(name: str) -> None:
    """Log, once a process, an op that ran on replicated inputs."""
    if name not in _LOGGED:
        _LOGGED.add(name)
        print(f"[train] DTensor refuses to shard {name}: it runs on "
              f"replicated inputs", flush=True)


def _sharded_step(step_fn, rules, params, opt_state, batch):
    """One step on DTensors under the rules (JAX's pjit of the step)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from ..models.common import sharding_ctx
    from ..models.sharded import ShardedExec
    with ShardedExec(_log_fallback), sharding_ctx(rules), \
            implicit_replication():
        return step_fn(params, opt_state, batch)


def run(arch: str, steps: int, batch: int, seq: int, ckpt_dir: str | None,
        ckpt_every: int, mesh_kind: str = "debug", lr: float = 3e-4,
        remat: bool = False, resume: bool = True, log_every: int = 1,
        device=None):
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = build_model(cfg)
    rules = None
    if mesh_kind != "debug":
        mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"),
                                    device_type=dev.type)
        rules = make_rules(mesh, "train")
    opt_cfg = AdamWConfig(lr=lr)
    step_fn = make_train_step(model, opt_cfg, remat=remat,
                              attn_blocks=(min(64, seq), min(64, seq)))

    gen = torch.Generator(device=dev).manual_seed(0)
    params, axes = model.init_with_axes(gen, dev)
    if rules is not None:
        params = place_tree(rules, params, axes)
    opt_state = adamw_init(params)
    start = 0
    if ckpt_dir and resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            shardings = None if rules is None else \
                tree_shardings(rules, params, axes)
            start, params, opt_state, _ = ckpt.restore(
                f"{ckpt_dir}/step_{last}", params, opt_state,
                shardings=shardings, device=dev)
            print(f"[train] resumed from step {start}")

    data = SyntheticTokens(DataConfig(cfg.vocab_size, batch, seq))
    b_axes = batch_logical_axes(cfg, "train")
    losses = []
    for step in range(start, steps):
        np_batch = data.batch_at(step)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
        t0 = time.perf_counter()
        if rules is None:
            params, opt_state, metrics = step_fn(params, opt_state, tb)
        else:
            params, opt_state, metrics = _sharded_step(
                step_fn, rules, params, opt_state,
                place_tree(rules, tb, {k: b_axes[k] for k in tb}))
        loss = float(metrics["loss"])            # waits for the step
        dt = time.perf_counter() - t0
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt*1e3:.0f} ms)",
                  flush=True)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            if rules is None:
                ckpt.save(f"{ckpt_dir}/step_{step + 1}", step + 1, params,
                          opt_state)
            else:       # every rank gathers, rank 0 writes
                whole = [_gathered(t) for t in (params, opt_state)]
                if torch.distributed.get_rank() == 0:
                    ckpt.save(f"{ckpt_dir}/step_{step + 1}", step + 1,
                              *whole)
            print(f"[train] checkpointed step {step + 1}", flush=True)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--mesh", default="debug", choices=["debug", "pod1", "pod2"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card)")
    args = ap.parse_args()
    run(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
        args.ckpt_every, args.mesh, args.lr, args.remat, device=args.device)


if __name__ == "__main__":
    main()
