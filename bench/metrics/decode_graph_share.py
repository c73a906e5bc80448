"""Engine, decode side (serving/engine.py): the share, in %, of the
window's `decode_step` spans outside the profiled stretch that replayed
the decode engine's CUDA graph (arg `graph` 1) instead of launching each
operation from the host; None where the spans carry no `graph` (a
program without the graph)."""
from bench.reduce import _spans


def read(run):
    xs = _spans(run, "decode_step", False)
    if not xs or any("graph" not in s.args for s in xs):
        return None
    return 100.0 * sum(1 for s in xs if s.args["graph"]) / len(xs)
