"""Engine, decode side (serving/engine.py): mean `decode.launch` span, the
host's enqueue of one decode step (from the step's start until the
model's call returns), over the window's decode steps outside the
profiled stretch, as `decode_step_ms` reads them. With `decode_sync_ms`
it sums to the step's charged seconds."""
from bench.reduce import _spans


def phase_ms(run, step: str, phase: str):
    """Mean, in ms, of the `host` spans `phase` whose parent (arg `step`,
    its index in the spans) is one of the window's `step` spans outside
    the profiled stretch; None where there are none."""
    if run.spans is None:
        return None
    steps = {id(s) for s in _spans(run, step, False)}
    xs = [s.dur for s in run.spans if s.cat == "host" and s.name == phase
          and id(run.spans[s.args["step"]]) in steps]
    return 1e3 * sum(xs) / len(xs) if xs else None


def read(run):
    return phase_ms(run, "decode_step", "decode.launch")
