"""Device, inside the prefill steps, in the cell above the knee: as
`decode_step_idle_share`, over the profiled `prefill_batch` ranges (a
whole prompt's prefill, from the call to the end of its synchronise),
where the prefill engine's idle time bounds the tokens completed per
second."""
from pathlib import Path

from bench.cell import load_module

_idle_share = load_module(
    Path(__file__).with_name("decode_step_idle_share.py")).idle_share


def read(run):
    return _idle_share(run.profile, "prefill_batch")
