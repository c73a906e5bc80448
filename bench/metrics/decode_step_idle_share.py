"""Device, inside the decode steps: the share of the profiled stretch's
`decode_step` ranges (the engine's umbrella `record_function`, from the
step's call to the end of its synchronise: the interval the virtual
clock charges) in which none of the step's own operations ran on the
card, in %.

A step's own operations are those whose launch call lies in its range.
They are found by launch, not by time, because the profiler's device
clock drifts from its host clock on an H100 host: by 12 ms to
213 ms over a 3 s stretch, where a decode step lasts ~50 ms and an
admission's page write ~1 ms."""
import bisect

from bench.devtrace import _merge

# host calls that queue one device operation each
LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
    "cudaMemsetAsync", "cudaMemset"))


def launched_ops(profile):
    """(launch time on the host's clock, (start, end) on the device's) of
    each device operation, in us; None without operations, or with more
    operations than launch calls.

    One stream runs the operations in the order the host launched them.
    The pairs are counted from the end, since the profile's stop waits for
    the device: a launch call whose operation the trace lacks (one or two
    a stretch, at its start) shifts only the pairs before it."""
    if profile is None or not profile.ops:
        return None
    launches = sorted(a for n, a, _ in profile.host if n in LAUNCHES)
    ops = sorted((a, b) for _, a, b in profile.ops)
    if len(ops) > len(launches):
        return None
    return list(zip(launches[len(launches) - len(ops):], ops))


def own_busy(pairs, ranges) -> float:
    """Device-busy us of the operations launched in each range, summed
    over the ranges."""
    at = [t for t, _ in pairs]
    busy = 0.0
    for a, b in ranges:
        own = pairs[bisect.bisect_left(at, a):bisect.bisect_right(at, b)]
        busy += sum(y - x for x, y in _merge([op for _, op in own]))
    return busy


def idle_share(profile, name: str):
    """100 x (1 - own device-busy time of the host ranges `name` / their
    time); None without paired operations or without such ranges."""
    pairs = launched_ops(profile)
    ranges = [(a, b) for n, a, b in profile.host if n == name and b > a] \
        if pairs else []
    if not ranges:
        return None
    return 100.0 * (1.0 - own_busy(pairs, ranges)
                    / sum(b - a for a, b in ranges))


def read(run):
    return idle_share(run.profile, "decode_step")
