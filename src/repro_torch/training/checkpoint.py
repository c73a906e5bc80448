"""Checkpoints in the JAX package's on-disk format (port of
`repro/training/checkpoint.py`), read and written byte for byte alike:
`index.msgpack` (JSON where msgpack is missing) holds the step, the extra
dict, the codec and each leaf's file, shape and numpy dtype name; each
leaf is one file `{tree}__{key}.zst` of its raw bytes, zstd-compressed
(zlib where zstandard is missing). A bf16 leaf is its raw bytes under
"bfloat16", read back through an int16 view (no `ml_dtypes` needed).
A checkpoint either package writes restores in the other.

`save` gathers a sharded leaf (a DTensor) whole, as JAX's `device_get`
does. JAX's `shardings`/`opt_shardings` place restored leaves on a mesh;
the port's restore refuses them (`launch/train.py --mesh pod1|pod2`
does not resume).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

try:                                    # optional deps: fall back to stdlib
    import msgpack
except ImportError:                     # pragma: no cover - env dependent
    msgpack = None
try:
    import zstandard as zstd
except ImportError:                     # pragma: no cover - env dependent
    zstd = None


class _ZlibCodec:
    """Stdlib stand-in with the zstd compressor/decompressor interface."""

    def __init__(self, level: int = 6):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


def _compressor(level: int):
    if zstd is not None:
        return zstd.ZstdCompressor(level=level), "zstd"
    return _ZlibCodec(min(level * 2, 9)), "zlib"


def _decompressor(codec: str):
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError("checkpoint was written with zstd, which is "
                               "not installed")
        return zstd.ZstdDecompressor()
    return _ZlibCodec()


def _pack_index(index: Dict) -> bytes:
    if msgpack is not None:
        return msgpack.packb(index)
    return json.dumps(index).encode()


def _unpack_index(raw: bytes) -> Dict:
    if raw[:1] == b"{":                 # JSON fallback index
        return json.loads(raw.decode())
    if msgpack is None:
        raise RuntimeError("checkpoint index is msgpack but msgpack is not "
                           "installed")
    return msgpack.unpackb(raw)


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node
    rec("", tree)
    return flat


def _unflatten(flat: Dict[str, Any], like) -> Any:
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [rec(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(vals)
        return flat[prefix]
    return rec("", like)


def _to_bytes(leaf) -> Tuple[bytes, list, str]:
    """A leaf's raw bytes, shape and numpy dtype name."""
    if hasattr(leaf, "full_tensor"):            # a DTensor: gather it
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes(), list(t.shape), \
            "bfloat16"
    arr = t.numpy()
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _from_bytes(raw: bytes, meta: Dict, device) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=meta["dtype"]).copy())
    return t.reshape(meta["shape"]).to(device)


def save(path: str, step: int, params, opt_state=None,
         extra: Optional[Dict] = None, level: int = 3):
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    cctx, codec = _compressor(level)
    index = {"step": int(step), "extra": extra or {}, "codec": codec,
             "leaves": {}}
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = opt_state
    for tname, tree in trees.items():
        for key, leaf in _flatten(tree).items():
            raw, shape, dtype = _to_bytes(leaf)
            fname = f"{tname}__{key.replace('/', '__')}.zst"
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(cctx.compress(raw))
            index["leaves"][f"{tname}/{key}"] = {
                "file": fname, "shape": shape, "dtype": dtype}
    with open(os.path.join(tmp, "index.msgpack"), "wb") as f:
        f.write(_pack_index(index))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, like_params, like_opt=None, shardings=None,
            opt_shardings=None, device=None) -> Tuple[int, Any, Any, Dict]:
    """Restore into fresh tensors with the structure of `like_*` (tensors,
    or any leaves: only the tree is read). Each leaf goes to `device`,
    default the device of its `like` leaf where that is a tensor, else
    the CPU. Returns (step, params, opt_state, extra)."""
    if shardings is not None or opt_shardings is not None:
        raise NotImplementedError(
            "restore: placing restored leaves on a mesh (JAX's shardings, "
            "ROADMAP A15) is not ported; restore on one device")
    with open(os.path.join(path, "index.msgpack"), "rb") as f:
        index = _unpack_index(f.read())
    dctx = _decompressor(index.get("codec", "zstd"))

    def load_tree(tname, like):
        out_flat = {}
        for key, leaf in _flatten(like).items():
            meta = index["leaves"][f"{tname}/{key}"]
            with open(os.path.join(path, meta["file"]), "rb") as f:
                raw = dctx.decompress(f.read())
            dev = device if device is not None else (
                leaf.device if torch.is_tensor(leaf) else "cpu")
            out_flat[key] = _from_bytes(raw, meta, dev)
        return _unflatten(out_flat, like)

    params = load_tree("params", like_params)
    opt = None
    if like_opt is not None:
        opt = load_tree("opt", like_opt)
    return index["step"], params, opt, index.get("extra", {})
