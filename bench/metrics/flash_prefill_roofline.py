"""Kernels (csrc/flash_prefill.cu): `flash_prefill`'s share of its
roofline over the profiled stretch, in %: the causal attention of the
prefills that ran there, at each prompt's real length, over the device
seconds of the forward kernels (the backward's are not on this path)."""
import re

from bench.reduce import causal_attn_flops, prefills, roofline_share

KERNELS = re.compile(r"flash_prefill_(wgmma|mma|simt)_kernel")


def work(n, S, dtype_bytes=2):
    """(flops, bytes) over a prompt of S tokens, all layers: causal QK^T
    and PV; q, k, v read once and o written once."""
    L, H, Hkv, hd = n["L"], n["H"], n["Hkv"], n["hd"]
    byts = (2 * S * H * hd + 2 * S * Hkv * hd) * dtype_bytes * L
    return causal_attn_flops(n, S), byts


def read(run):
    if run.profile is None:
        return None
    xs = prefills(run, profiled=True)
    secs = run.profile.kernel_seconds(KERNELS)
    if not xs or secs <= 0:
        return None
    f = b = 0
    for _, S in xs:
        sf, sb = work(run.dims, S)
        f, b = f + sf, b + sb
    return roofline_share(f, b, secs)
