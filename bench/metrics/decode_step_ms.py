"""Engine, decode side (serving/engine.py): mean `decode_step` span, the
host time of one decode iteration after a device synchronise, outside
the profiled stretch."""
from bench.reduce import decode_steps


def read(run):
    xs = decode_steps(run)
    return 1e3 * sum(d for d, _ in xs) / len(xs) if xs else None
