"""Cluster, the migration's page write (serving/cluster.py `_splice`,
inside the program's `admit` range): mean device time of one admission's
`materialize_wire` + `insert_kv` over the profiled stretch's admissions,
in ms: the busy time of the operations launched in each `admit` range
(`decode_step_idle_share`'s `launched_ops`, by launch and not by time).
The virtual clock charges it to no one: its operations run before the
next decode step's."""
from pathlib import Path

from bench.cell import load_module

_idle = load_module(Path(__file__).with_name("decode_step_idle_share.py"))


def read(run):
    pairs = _idle.launched_ops(run.profile)
    admits = [(a, b) for n, a, b in run.profile.host if n == "admit"] \
        if pairs else []
    if not admits:
        return None
    return 1e-3 * _idle.own_busy(pairs, admits) / len(admits)
