"""Cluster (serving/cluster.py): 90th percentile of the virtual seconds
the window's requests spent in the prefill queue (the tracer's `queued`
phase spans)."""
from bench.reduce import percentile, queue_waits


def read(run):
    xs = queue_waits(run)
    return percentile(xs, 0.9) if xs else None
