"""Engine, prefill side (serving/engine.py): mean `prefill_batch` span,
the host time of one whole-prompt prefill after a device synchronise,
outside the profiled stretch."""
from bench.reduce import prefills


def read(run):
    xs = prefills(run)
    return 1e3 * sum(d for d, _ in xs) / len(xs) if xs else None
