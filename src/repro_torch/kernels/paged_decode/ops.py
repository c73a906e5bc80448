"""Public paged decode ops (port of `repro/kernels/paged_decode/ops.py`).

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version. There is no fallback from one to the other: a launch that
fails raises. `plain=True` runs the plain version on any device; only
the whole-model check of `chip_smoke.py` asks for it, as the reference
the kernels are held against. The kernels have no backward: on the card
each op raises where autograd would need one (`build.require_no_grad`).
"""
from __future__ import annotations

from ..build import require_no_grad
from . import kernel
from .ref import paged_decode_ref, paged_insert_decode_ref, paged_insert_ref


def paged_decode_op(q, k_pages, v_pages, block_table, lens, *,
                    scale: float = None, softcap: float = 0.0,
                    dbuf: bool = False, plain: bool = False,
                    return_lse: bool = False):
    """q: (B, H, hd); k/v_pages: (num_pages, page, Hkv, hd); block_table:
    (B, pps) i32; lens: (B,) i32 -> (B, H, hd), and with `return_lse`
    also each row's (B, H) f32 log-sum-exp of its scaled (and capped) live
    scores, by which partial outputs over disjoint keys combine.

    `dbuf` is kept for signature parity with the JAX op: on the TPU it
    picks a double-buffered DMA schedule of the same function; here both
    values run the same kernel."""
    del dbuf
    if plain or not q.is_cuda:
        return paged_decode_ref(q, k_pages, v_pages, block_table, lens,
                                scale=scale, softcap=softcap,
                                return_lse=return_lse)
    require_no_grad("paged_decode_op", q, k_pages, v_pages)
    return kernel.paged_decode(q, k_pages, v_pages, block_table, lens,
                               scale=scale, softcap=softcap,
                               return_lse=return_lse)


def paged_insert_op(k_pages, v_pages, k_new, v_new, page_idx, offset, *,
                    plain: bool = False):
    """Write one new token per sequence into the pools, in place (the JAX
    op aliases the pools; here they are updated where they lie). Returns
    the pools."""
    if plain or not k_pages.is_cuda:
        return paged_insert_ref(k_pages, v_pages, k_new, v_new, page_idx,
                                offset)
    require_no_grad("paged_insert_op", k_pages, v_pages, k_new, v_new)
    return kernel.paged_insert(k_pages, v_pages, k_new, v_new, page_idx,
                               offset)


def paged_insert_decode_op(q, k_new, v_new, k_pages, v_pages, block_table,
                           lens, *, scale: float = None,
                           softcap: float = 0.0, plain: bool = False):
    """The decode step's attention in one op: `paged_insert_op` of k/v_new
    (B, Hkv, hd) at page `block_table[b, (lens[b]-1) // page]`, row
    `(lens[b]-1) % page` (nothing where lens[b] = 0), in place, followed by
    `paged_decode_op`. On the card both run in the split kernel of
    `paged_decode` (no launch of its own for the insert). -> (B, H, hd)."""
    if plain or not q.is_cuda:
        return paged_insert_decode_ref(q, k_new, v_new, k_pages, v_pages,
                                       block_table, lens, scale=scale,
                                       softcap=softcap)
    require_no_grad("paged_insert_decode_op", q, k_new, v_new, k_pages,
                    v_pages)
    return kernel.paged_insert_decode(q, k_new, v_new, k_pages, v_pages,
                                      block_table, lens, scale=scale,
                                      softcap=softcap)
