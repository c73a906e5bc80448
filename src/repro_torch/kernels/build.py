"""Build and load the port's CUDA kernels.

The sources in `src/repro_torch/csrc/*.cu` have a plain C interface. On
first use they are compiled for Hopper, one `nvcc` per source started
together, linked into `build/kernels/libreprokernels.so` at the repo root,
and loaded with `ctypes`. A library newer than every source is reused.
Nothing here runs at import time: the CPU tests import every module and
this host has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libreprokernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; pointers and the stream are c_void_p so that
# ctypes never truncates them to 32 bits
SIGNATURES = {
    "flash_prefill": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _F, _F, _I, _P],
    "prefix_prefill": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _I, _I, _I, _I, _F, _F, _P],
    "paged_decode": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _F, _F, _P],
    "paged_insert": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "paged_insert_decode": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "ssd_scan": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                 _I, _I, _I, _I, _I, _I, _P, _P],
}


class KernelError(RuntimeError):
    """A kernel launch (or the build) failed."""


class _Library:
    """The loaded shared library plus how long it took to get it."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds = 0.0


_STATE = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelError("nvcc not found: the CUDA kernels are built on a "
                          "host with the CUDA toolkit")
    return found


def _stale(lib_path: Path, sources: List[Path]) -> bool:
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    deps = sources + list(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build() -> Path:
    """Compile csrc/*.cu in parallel and link the shared library, unless a
    library newer than every source is there."""
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = BUILD_DIR / LIB_NAME
    if not _stale(lib_path, sources):
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise KernelError(f"link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)     # atomic: a reader never sees half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    if _STATE.lib is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _STATE.lib = lib
        _STATE.build_seconds = time.perf_counter() - t0
    return _STATE.lib


def build_seconds() -> float:
    return _STATE.build_seconds


def check(code: int, name: str):
    """Raise if a launch returned a non-zero cudaError_t."""
    if code != 0:
        raise KernelError(f"{name}: CUDA error {code}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims of the attention kernels' compiled instances (csrc/attn_common.cuh)
HD_INSTANCES = (16, 32, 64, 128, 256)


def head_dim_instance(name: str, hd: int) -> int:
    """The compiled instance that runs head dim `hd` in the attention
    kernels: the smallest of `HD_INSTANCES` at least `hd`, with the columns
    past `hd` zero-filled on load and masked on store. `hd` must be a
    multiple of 16 (whole 16-byte chunks of bf16) and at most 256; raise
    ValueError otherwise."""
    if hd % 16 or not HD_INSTANCES[0] <= hd <= HD_INSTANCES[-1]:
        raise ValueError(f"{name}: head dim {hd} is not a multiple of 16 "
                         f"in 16..256")
    return next(i for i in HD_INSTANCES if hd <= i)


def padded_head_dim(name: str, hd: int) -> int:
    """The head dim the attention kernels run `hd` at: `hd` itself where it
    is a multiple of 16 (`head_dim_instance` takes it as is), else the next
    multiple of 16, to which the wrappers zero-pad q, k and v (zero columns
    add nothing to q.k, and the output's padding columns are sliced off).
    Head dims above 256 raise ValueError: no instance is compiled for them
    and no config of either package has one."""
    if not 1 <= hd <= HD_INSTANCES[-1]:
        raise ValueError(f"{name}: head dim {hd} is outside 1..256 (no "
                         f"compiled instance)")
    return -(-hd // 16) * 16


def pad_head_dim(t: torch.Tensor, hdp: int) -> torch.Tensor:
    """`t` with its last dim zero-padded to `hdp` (a copy), or `t`."""
    n = t.shape[-1]
    return t if n == hdp else torch.nn.functional.pad(t, (0, hdp - n))


def require_cuda(name: str, *tensors: torch.Tensor):
    """The checks every launch wrapper makes before handing pointers over."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: tensors on {dev} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")


def require_aligned(name: str, *tensors: torch.Tensor):
    """The 16-byte vector copies of the kernels need every tensor to start
    on 16 bytes and every stride of a dim longer than 1 to be a whole
    number of 16-byte chunks (the last dim stays contiguous). Raise
    otherwise: the kernels have no scalar path."""
    for t in tensors:
        chunk = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                s % chunk for s, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(f"{name}: tensors must start on 16 bytes with "
                             f"strides in 16-byte units, got offset "
                             f"{t.data_ptr() % 16} and strides {t.stride()}")


def bhs_strides(*tensors):
    """(batch, head, seq) element strides of each (B, heads, S, hd) view.

    The stride of a dim of size 1, never stepped over, is given as hd: a
    TMA tensor map wants every stride in 16-byte units, and PyTorch leaves
    such strides free."""
    out = []
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError("the head dim must be contiguous")
        out += [t.shape[3] if t.shape[i] == 1 else t.stride(i)
                for i in range(3)]
    return (ctypes.c_longlong * len(out))(*out)
