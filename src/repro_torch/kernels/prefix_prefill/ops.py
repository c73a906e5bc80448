"""Public fused suffix-prefill op (port of
`repro/kernels/prefix_prefill/ops.py`).

Takes the model layout, q/k/v as (B, S, heads, hd), and hands the kernel
transposed views (no copy). A CUDA tensor goes to the hand-written kernel,
a CPU tensor to the plain version; `plain=True` forces the plain version
for the whole-model check of `chip_smoke.py`. The kernel has no
backward: on the card the op raises where autograd would need one
(`build.require_no_grad`).
"""
from __future__ import annotations

from ..build import require_no_grad
from . import kernel
from .ref import prefix_prefill_ref


def prefix_prefill_op(q, k_suf, v_suf, k_pages, v_pages, prefix_table,
                      prefix_lens, suffix_lens=None, *, scale: float = None,
                      softcap: float = 0.0, block_q: int = 128,
                      block_kv: int = 256, dbuf: bool = False,
                      plain: bool = False):
    """q: (B, S, H, hd); k/v_suf: (B, S, Hkv, hd); k/v_pages: (num_pages,
    page, Hkv, hd); prefix_table: (B, npp) i32; prefix_lens: (B,) i32;
    suffix_lens: (B,) i32 or None -> (B, S, H, hd).

    `block_q`/`block_kv` size the TPU kernel's tiles and `dbuf` picks its
    double-buffered DMA schedule; the CUDA kernel has fixed 64-row tiles
    and one schedule, so all three are kept for signature parity only."""
    del block_q, block_kv, dbuf
    qt = q.transpose(1, 2)
    kt = k_suf.transpose(1, 2)
    vt = v_suf.transpose(1, 2)
    if plain or not q.is_cuda:
        out = prefix_prefill_ref(qt, kt, vt, k_pages, v_pages, prefix_table,
                                 prefix_lens, suffix_lens, scale=scale,
                                 softcap=softcap)
    else:
        require_no_grad("prefix_prefill_op", q, k_suf, v_suf, k_pages,
                        v_pages)
        out = kernel.prefix_prefill(qt, kt, vt, k_pages, v_pages,
                                    prefix_table, prefix_lens, suffix_lens,
                                    scale=scale, softcap=softcap)
    return out.transpose(1, 2)
