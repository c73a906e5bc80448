"""Model step: the whole decode step's roofline share, in %: per step
max(flops / bf16 peak, bytes / HBM bandwidth), summed, over the steps'
host seconds, outside the profiled stretch. Bytes are every weight read
once (the embedding at the members' rows) plus the attention's; flops
the layer products and the head on each member's row plus attention."""
from pathlib import Path

from bench.cell import load_module
from bench.reduce import (PEAK_BF16_FLOPS, PEAK_HBM_BYTES_S, decode_steps,
                          matmul_params)

attention = load_module(Path(__file__).with_name(
    "paged_decode_roofline.py")).work


def step_work(n, ctxs, dtype_bytes=2):
    """(flops, bytes) of one decode step over len(ctxs) members."""
    B = len(ctxs)
    w = matmul_params(n) + n["d"] * n["V"]
    af, ab = attention(n, ctxs, dtype_bytes)
    return 2 * B * w + af, (w + B * n["d"]) * dtype_bytes + ab


def read(run):
    xs = [(d, c) for d, c in decode_steps(run) if c]
    secs = sum(d for d, _ in xs)
    if not xs or secs <= 0:
        return None
    least = 0.0
    for _, ctxs in xs:
        f, b = step_work(run.dims, ctxs)
        least += max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES_S)
    return 100.0 * least / secs
