"""Kernels (csrc/paged_decode.cu): the fused insert + decode launch's
share of its roofline over the profiled stretch, in %: the work of the
decode steps that ran there, at each member's real context (idle batch
slots do no useful work), over the device seconds of the split and
combine kernels."""
import re

from bench.reduce import decode_steps, roofline_share

KERNELS = re.compile(r"paged_decode_(split|combine)_kernel")


def work(n, ctxs, dtype_bytes=2):
    """(flops, bytes) of one step's attention, all layers: per member of
    context c, QK^T and PV over c keys; its keys' and values' pages read
    once, q read, the new row's k and v and the output written once."""
    L, H, Hkv, hd = n["L"], n["H"], n["Hkv"], n["hd"]
    flops = sum(4 * H * hd * c for c in ctxs) * L
    per = sum(2 * Hkv * hd * c + 2 * H * hd + 2 * Hkv * hd for c in ctxs)
    return flops, per * L * dtype_bytes


def read(run):
    if run.profile is None:
        return None
    steps = decode_steps(run, profiled=True)
    secs = run.profile.kernel_seconds(KERNELS)
    if not steps or secs <= 0:
        return None
    f = b = 0
    for _, ctxs in steps:
        sf, sb = work(run.dims, ctxs)
        f, b = f + sf, b + sb
    return roofline_share(f, b, secs)
