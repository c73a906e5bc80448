"""Cost accounting of a step run on DTensors over a fake mesh (port of
`repro/launch/costs.py`).

JAX lowers a cell to HLO and reads XLA's analyses; the port has no HLO.
It runs the step eagerly, on fake tensors, under `StepProbe`, which
counts what it sees:

  * dot flops (`flops`): every matmul-family op whose operands are
    DTensors, at their global shapes, so a sharded product counts once
    (its local product runs inside DTensor's dispatch, which the probe
    does not look into). The shard-local cores (`models/sharded.py`)
    report their JAX oracle's flops themselves. These are GLOBAL numbers,
    comparable with JAX's `jaxpr_costs(...)["flops"]` integer for
    integer. A remat layer's second run in the backward stops, in torch,
    just after the op that saves the last needed tensor, so the last
    product of a residual branch runs although nothing reads it; JAX's
    partial evaluation drops it. The probe therefore discounts a product
    of a recompute (run under `torch.utils.checkpoint`'s `recompute_fn`)
    whose result no later op reads.
  * structural bytes (`bytes`): operands and results of those products
    (JAX's `dot_general` term of its structural-byte model).
  * collectives: every functional collective DTensor (or a core) issues,
    per rank, with JAX's ring wire model (`parse_collectives`): all-gather
    result x (g-1)/g, all-reduce 2 x bytes x (g-1)/g, reduce-scatter
    result x (g-1), all-to-all the bytes. A group whose ranks span more
    than one pod (256 ranks) is dcn, otherwise ici. Python loops unroll,
    so every collective is counted as often as it runs:
    `collectives_corrected` (JAX's trip-count correction of its while
    loops) is the same record.
  * per-rank bytes: the live local storage of rank 0 (each fake tensor
    counted from its creation until it is freed, views not again), whose
    high-water mark is `peak_bytes`. It is the plain path's footprint
    (a dense S x S score block where the card runs a kernel).
  * fallbacks: the step runs under `models/sharded.py::ShardedExec`, so
    an op DTensor refuses to shard runs on replicated inputs
    (all-gathered first); each such op is counted by name in
    `fallbacks`.

The HLO parsers of the JAX module are not copied: the port produces no
HLO text for them to read.
"""
from __future__ import annotations

import math
import sys
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..models.common import is_dtensor
from ..models.sharded import ShardedExec, cost_probe

aten = torch.ops.aten


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _mm_flops(func, args) -> int:
    """Dot flops of a matmul-family aten op at the shapes of `args`."""
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func is aten.mm.default else \
            (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in (aten.bmm.default, aten.baddbmm.default):
        a, b = (args[0], args[1]) if func is aten.bmm.default else \
            (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func is aten.dot.default:
        return 2 * args[0].shape[0]
    if func in (aten.mv.default,):
        return 2 * args[0].shape[0] * args[0].shape[1]
    return 0


_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _group_ranks(group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


class _Collector(TorchDispatchMode):
    """Sees the local ops DTensor issues (it declines DTensor-level ops,
    so DTensor desugars them first): records collectives and tracks live
    local storage."""

    def __init__(self, probe: "StepProbe"):
        super().__init__()
        self.probe = probe

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor(a) for a in tree_flatten((args, kwargs))[0]):
            return NotImplemented
        out = func(*args, **kwargs)
        name = getattr(func, "_overloadpacket", func).__name__
        ns = getattr(func, "namespace", "")
        if ns in ("_c10d_functional", "c10d_functional") and \
                name in _COLLECTIVE_KINDS:
            self.probe.add_collective(_COLLECTIVE_KINDS[name], func, args,
                                      out)
        if not _untracked():
            self.probe.track(out)
        return out


def _source_line(depth: int = 96) -> str:
    """file:line (function) of the nearest frame in the port's models,
    training or kernel ops: what issued a collective."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            break
        fn = f.f_code.co_filename.replace("\\", "/")
        if "repro_torch/" in fn and "/launch/" not in fn:
            rel = fn[fn.index("repro_torch/"):]
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "?"


def _untracked(depth: int = 64) -> bool:
    """Whether the op's result is no per-rank memory of the step: a
    global-shape fake tensor DTensor's sharding propagation makes for
    metadata, or a temporary of a kernel's plain version (`kernels/*/
    ref.py`: the dense score block of attention, the scan's chunk
    tensors), which the card's kernel keeps on chip. The cores in
    `models/sharded.py` count their outputs themselves."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        fn = f.f_code.co_filename
        if fn.endswith("ref.py") and "kernels" in fn:
            return True
        f = f.f_back
    return False


def recomputing(depth: int = 128) -> bool:
    """Whether the op runs inside a remat layer's second run in the
    backward (`torch.utils.checkpoint`'s `recompute_fn`)."""
    f = sys._getframe(1)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name == "recompute_fn" and \
                f.f_code.co_filename.endswith("checkpoint.py"):
            return True
        f = f.f_back
    return False


class _Count(TorchDispatchMode):
    """Sees the step's own ops (DTensor level), above `ShardedExec`:
    counts their dot flops and names the op that issues a collective."""

    def __init__(self, probe: "StepProbe"):
        super().__init__()
        self.probe = probe

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if not any(is_dtensor(a) for a in flat):
            return func(*args, **kwargs)
        self.probe.mark_used(flat)
        prev_op, self.probe.cur_op = self.probe.cur_op, str(func)
        try:
            out = func(*args, **kwargs)
        finally:
            self.probe.cur_op = prev_op
        f = _mm_flops(func, args)
        if f:
            self.probe.add_dot(f, args, out)
        return out


class StepProbe:
    """Context manager: counts flops, bytes, collectives and rank-0 live
    bytes of the step run inside it (see the module docstring)."""

    def __init__(self, n_pod_boundary: int = 256):
        self.n_pod_boundary = n_pod_boundary
        self.flops = 0
        self.bytes = 0
        self.exec = ShardedExec()
        self.cur_op = None
        self.ops = []
        self.live = 0
        self.peak = 0
        self._pending: Dict[int, Any] = {}
        self._seen_storage = set()

    # -- flops -----------------------------------------------------------
    def add_flops(self, n: int) -> None:
        self.flops += int(n)

    def add_dot(self, f: int, args, out) -> None:
        # a product on a sub-mesh (a shard-local body's "auto" dims) runs
        # once here for each shard of the other dims: count them all
        import torch.distributed as dist
        mesh = next(a.device_mesh for a in args if is_dtensor(a))
        f *= dist.get_world_size() // mesh.size()
        self.flops += f
        self.bytes += sum(_nbytes(a) for a in args
                          if isinstance(a, torch.Tensor)) + _nbytes(out)
        if recomputing():
            self._pending[id(out)] = (weakref.ref(out), f, _nbytes(out))

    def mark_used(self, flat) -> None:
        if not self._pending:
            return
        for a in flat:
            ent = self._pending.get(id(a))
            if ent is not None and ent[0]() is a:
                del self._pending[id(a)]

    def unread_recompute_flops(self) -> int:
        return sum(f for _, f, _ in self._pending.values())

    # -- collectives -----------------------------------------------------
    def add_collective(self, kind, func, args, out) -> None:
        group = next((a for a in reversed(args) if isinstance(a, str)),
                     None)
        ranks = _group_ranks(group) if group is not None else [0]
        g = max(len(ranks), 1)
        res = out[0] if isinstance(out, (list, tuple)) else out
        nbytes = _nbytes(res)
        if kind == "all-reduce":
            wire = 2.0 * nbytes * max(g - 1, 1) / g
        elif kind == "reduce-scatter":
            wire = float(nbytes * max(g - 1, 1))
        elif kind == "all-gather":
            wire = nbytes * max(g - 1, 1) / g
        else:
            wire = float(nbytes)
        nb = self.n_pod_boundary
        dcn = (max(ranks) // nb) != (min(ranks) // nb)
        self.ops.append({"kind": kind, "bytes": nbytes, "group": g,
                         "dcn": dcn, "wire": wire, "op": str(func),
                         "issued_by": self.cur_op or "redistribute",
                         "source": _source_line()})

    def collectives(self) -> Dict[str, Any]:
        out = {"ici_bytes": 0.0, "dcn_bytes": 0.0, "by_kind": {},
               "n_ops": len(self.ops)}
        for op in self.ops:
            out["dcn_bytes" if op["dcn"] else "ici_bytes"] += op["wire"]
            out["by_kind"][op["kind"]] = \
                out["by_kind"].get(op["kind"], 0.0) + op["wire"]
        return out

    # -- live bytes ------------------------------------------------------
    def track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t._base is not None:
                continue
            try:
                key = id(t.untyped_storage())
            except Exception:  # noqa: BLE001
                continue
            n = _nbytes(t)
            if n == 0 or key in self._seen_storage:
                continue
            self._seen_storage.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def add_resident(self, n: int) -> None:
        """Bytes already live when the step starts (its arguments)."""
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n):
        self.live -= n

    # -- context ---------------------------------------------------------
    def __enter__(self):
        self._ctx = cost_probe(self)
        self._ctx.__enter__()
        self._collector = _Collector(self)
        self._collector.__enter__()
        self.exec.__enter__()
        self._count = _Count(self)
        self._count.__enter__()
        return self

    def __exit__(self, *exc):
        self._count.__exit__(*exc)
        self.exec.__exit__(*exc)
        self._collector.__exit__(*exc)
        self._ctx.__exit__(*exc)
        # products of a recompute that no later op read (JAX drops them)
        f = self.unread_recompute_flops()
        self.flops -= f
        self._pending.clear()
        return False

    def record(self) -> Dict[str, Any]:
        c = self.collectives()
        return {"dot_flops": self.flops, "struct_bytes": self.bytes,
                "collectives": c, "peak_bytes": self.peak,
                "fallbacks": dict(self.exec.fallbacks)}


def local_bytes(t) -> int:
    """Bytes of the shard rank 0 holds of `t` (a DTensor or a tensor)."""
    if is_dtensor(t):
        return _nbytes(t.to_local())
    return _nbytes(t)


def tree_bytes(tree, fn=_nbytes) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v, fn) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else 0


def spec_bytes(tree) -> int:
    """Global bytes of a tree of `TensorSpec`s or tensors."""
    if isinstance(tree, dict):
        return sum(spec_bytes(v) for v in tree.values())
    return math.prod(tree.shape) * torch.empty((), dtype=tree.dtype) \
        .element_size()
