"""Engine, decode side (serving/engine.py): mean `decode.sync` span, the
host's wait for the device after a decode step's enqueue, over the same
steps as `decode_launch_ms`."""
from pathlib import Path

from bench.cell import load_module

_phase_ms = load_module(
    Path(__file__).with_name("decode_launch_ms.py")).phase_ms


def read(run):
    return _phase_ms(run, "decode_step", "decode.sync")
