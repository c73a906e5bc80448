"""Set-up seconds: process start to the window's start (imports, the
kernels' build on a checkout's first run, weights, the cluster, warm-up
and the ramp to a steady decode batch)."""


def read(run):
    return run.setup_s
