"""Model step (models/transformer.py, models/attention.py): the prefill
steps' model flops over their host seconds and the bf16 peak, in %. The
flops are counted at each prompt's real length (the program pads to a
length bucket), outside the profiled stretch."""
from bench.reduce import (PEAK_BF16_FLOPS, causal_attn_flops,
                          matmul_params, prefills)


def prefill_flops(n, S):
    """A prefill of S tokens: every layer product on S rows, causal
    attention, and the head on the one row whose logits are sampled."""
    return (2 * S * matmul_params(n) + causal_attn_flops(n, S)
            + 2 * n["d"] * n["V"])


def read(run):
    xs = prefills(run)
    secs = sum(d for d, _ in xs)
    if not xs or secs <= 0:
        return None
    flops = sum(prefill_flops(run.dims, S) for _, S in xs)
    return 100.0 * flops / (secs * PEAK_BF16_FLOPS)
