"""Share of the requests sent in the window that met both limits of the
traffic file; a failed or unfinished request misses."""
from bench.reduce import attained


def read(run):
    w = run.window
    return sum(attained(run, r) for r in w) / len(w) if w else None
