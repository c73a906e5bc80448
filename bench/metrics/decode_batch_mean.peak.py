"""Engine, decode side: decode tokens over decode steps in the window
(the mean batch a step served)."""
from bench.reduce import decode_steps


def read(run):
    xs = decode_steps(run) + decode_steps(run, profiled=True)
    return sum(len(c) for _, c in xs) / len(xs) if xs else None
