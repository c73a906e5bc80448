"""From a run's requests, spans and trace to the numbers the metric
readers report. Times are virtual seconds since the first arrival
unless said otherwise; "the window" is the requests that arrived in it,
or the spans that started in it."""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

# the chip's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile (numpy's default), as the repo's
    `serving/api.py::percentile`; q in [0, 1]."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] * (1.0 - (pos - lo)) + xs[hi] * (pos - lo)


def ttft(run, r) -> float:
    """Virtual TTFT; a request with no first token by the drain's end
    counts as waiting until then (a lower bound, and a miss)."""
    if r.first >= 0:
        return r.first - r.arrive
    return run.w1 + run.cell.traffic["drain_cap_s"] - r.arrive


def tpot(r) -> Optional[float]:
    """Per-request TPOT, (finish - first token) / (out - 1), of a finished
    request of two or more tokens."""
    if not r.finished or len(r.times) < 2:
        return None
    return (r.times[-1] - r.times[0]) / (len(r.times) - 1)


def attained(run, r) -> bool:
    lim = run.cell.traffic["limits"]
    if not r.finished or len(r.times) != r.out_len:
        return False
    t = tpot(r)
    return ttft(run, r) <= lim["ttft_s"] and (t is None or t <= lim["tpot_s"])


def tokens_in_window(run) -> Tuple[int, int]:
    """(prompt tokens prefilled, output tokens generated) in the window,
    by when each landed: a prompt when its first token came."""
    pre = out = 0
    for r in run.requests:
        for i, t in enumerate(r.times):
            if run.w0 < t <= run.w1:
                out += 1
                if i == 0:
                    pre += r.in_len
    return pre, out


# -- spans ----------------------------------------------------------------

def _spans(run, name: str, profiled: bool):
    """Spans `name` that started in the window: with `profiled`, those
    recorded while the profiler ran; else the others (the profiler's cost
    stays out of step times)."""
    if run.spans is None:
        return []
    i0, i1 = run.profiled
    idx = range(i0, i1) if profiled else (
        i for i in range(len(run.spans)) if not i0 <= i < i1)
    out = []
    for i in idx:
        s = run.spans[i]
        if s.name == name and run.w0 < s.t0 - run.span_t0 <= run.w1:
            out.append(s)
    return out


def prefills(run, profiled: bool = False):
    """(seconds, prompt tokens) of each prefill step."""
    return [(s.dur, int(s.args["tokens"]))
            for s in _spans(run, "prefill_batch", profiled)]


def decode_steps(run, profiled: bool = False
                 ) -> List[Tuple[float, List[int]]]:
    """(seconds, contexts) of each decode step: the KV length each member
    attended (prompt + tokens so far), found from the tokens the step
    emitted at its end."""
    at: Dict[float, List[int]] = collections.defaultdict(list)
    for r in run.requests:
        for i, t in enumerate(r.times[1:], start=1):
            at[t].append(r.in_len + i)
    return [(s.dur, at.get(s.t1 - run.span_t0, []))
            for s in _spans(run, "decode_step", profiled)]


def queue_waits(run) -> List[float]:
    """Seconds each window request spent in the prefill queue."""
    rids = {r.rid for r in run.window}
    return [s.dur for s in (run.spans or ())
            if s.name == "queued" and s.rid in rids and s.t1 is not None]


# -- work (operations and bytes, at the real lengths) -----------------------

def matmul_params(n: Dict[str, int]) -> int:
    """Weights of one token's layer products, all layers (no head)."""
    return n["L"] * (n["d"] * (n["H"] + 2 * n["Hkv"]) * n["hd"]
                     + n["H"] * n["hd"] * n["d"] + 3 * n["d"] * n["ff"])


def causal_attn_flops(n: Dict[str, int], S: int) -> int:
    """QK^T and PV over the S (S + 1) / 2 causal pairs, all layers."""
    return 2 * 2 * n["L"] * n["H"] * n["hd"] * (S * (S + 1) // 2)


def roofline_share(flops: float, byts: float, seconds: float
                   ) -> Optional[float]:
    """The least time the chip could take (the larger of flops over the
    bf16 peak and bytes over HBM bandwidth) over `seconds`, in %."""
    if seconds <= 0 or (flops <= 0 and byts <= 0):
        return None
    return 100.0 * max(flops / PEAK_BF16_FLOPS,
                       byts / PEAK_HBM_BYTES_S) / seconds
