"""90th percentile of per-request TPOT, (finish - first token) / (out -
1), over the window's finished requests of two or more tokens."""
from bench.reduce import percentile, tpot


def read(run):
    xs = [t for t in (tpot(r) for r in run.window) if t is not None]
    return percentile(xs, 0.9) if xs else None
