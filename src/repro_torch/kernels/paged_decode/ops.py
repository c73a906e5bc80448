"""Public paged decode ops (port of `repro/kernels/paged_decode/ops.py`).

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version. There is no fallback from one to the other: a launch that
fails raises. `plain=True` runs the plain version on any device; only
the whole-model check of `chip_smoke.py` asks for it, as the reference
the kernels are held against.
"""
from __future__ import annotations

from . import kernel
from .ref import paged_decode_ref, paged_insert_ref


def paged_decode_op(q, k_pages, v_pages, block_table, lens, *,
                    scale: float = None, softcap: float = 0.0,
                    dbuf: bool = False, plain: bool = False):
    """q: (B, H, hd); k/v_pages: (num_pages, page, Hkv, hd); block_table:
    (B, pps) i32; lens: (B,) i32 -> (B, H, hd).

    `dbuf` is kept for signature parity with the JAX op: on the TPU it
    picks a double-buffered DMA schedule of the same function; here both
    values run the same kernel."""
    del dbuf
    if plain or not q.is_cuda:
        return paged_decode_ref(q, k_pages, v_pages, block_table, lens,
                                scale=scale, softcap=softcap)
    return kernel.paged_decode(q, k_pages, v_pages, block_table, lens,
                               scale=scale, softcap=softcap)


def paged_insert_op(k_pages, v_pages, k_new, v_new, page_idx, offset, *,
                    plain: bool = False):
    """Write one new token per sequence into the pools, in place (the JAX
    op aliases the pools; here they are updated where they lie). Returns
    the pools."""
    if plain or not k_pages.is_cuda:
        return paged_insert_ref(k_pages, v_pages, k_new, v_new, page_idx,
                                offset)
    return kernel.paged_insert(k_pages, v_pages, k_new, v_new, page_idx,
                               offset)
