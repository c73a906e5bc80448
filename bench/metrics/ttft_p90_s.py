"""90th percentile of TTFT (virtual seconds) over every request that
arrived in the window; one with no first token by the drain's cap counts
as waiting until the cap."""
from bench.reduce import percentile, ttft


def read(run):
    xs = [ttft(run, r) for r in run.window]
    return percentile(xs, 0.9) if xs else None
