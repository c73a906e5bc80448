"""`torch.profiler` over a short steady part of a traced run's window.

The trace is exported to a temporary file, read once and deleted; what
stays is each device operation (name, start, end) and each host event of
the thread that launches them. From these: the busy seconds (the union
of device operations), the idle gaps between them, each labelled by the
innermost host event under its midpoint ("python" where none is), and
the breakdown that the result line carries.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Profile:
    def __init__(self, device):
        self.device = torch.device(device)
        self.started = self.stopped = False
        self.window_s = 0.0
        self.busy_s = 0.0
        self.ops: List[Tuple[str, float, float]] = []     # device, us
        self.host: List[Tuple[str, float, float]] = []    # host, us
        self.gaps: List[Tuple[float, str]] = []           # (s, label)
        self._p = None
        self.t_start = 0.0

    def warm(self):
        """Start and stop once: the first start initialises the device
        tracer (seconds), which would otherwise eat into the window."""
        self.start()
        self.stop()
        self._p = None
        self.started = self.stopped = False

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._p = profile(activities=acts)
        self._p.start()
        self.started = True
        self.t_start = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t_start
        self._p.stop()
        self.stopped = True

    def read(self):
        """Parse the trace (once); without a profiled stretch, nothing."""
        if not self.stopped or self._p is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._p.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        self._p = None
        evs = doc["traceEvents"] if isinstance(doc, dict) else doc
        host_by_tid = collections.defaultdict(list)
        lo = hi = None
        for e in evs:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.ops.append((e.get("name", "?"), a, b))
            elif cat in HOST_CATS:
                host_by_tid[e.get("tid")].append((e.get("name", "?"), a, b))
        if host_by_tid:
            self.host = max(host_by_tid.values(), key=len)
        busy = _merge([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        # idle gaps: before the first device op, between ops, after the last
        if lo is not None:
            edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
            spans = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges) - 1, 2)
                     if edges[i + 1] > edges[i]]
            self.gaps = list(zip([(b - a) * 1e-6 for a, b in spans],
                                 self._labels([(a + b) / 2
                                               for a, b in spans])))

    def _labels(self, mids: List[float]) -> List[str]:
        """The innermost host event around each midpoint (sorted input
        not needed); host events of one thread nest."""
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        starts = [h[1] for h in host]
        order = sorted(range(len(mids)), key=lambda i: mids[i])
        out = ["python"] * len(mids)
        stack: List[Tuple[str, float, float]] = []
        j = 0
        for i in order:
            m = mids[i]
            k = bisect.bisect_right(starts, m)
            while j < k:
                h = host[j]
                while stack and stack[-1][2] < h[1]:
                    stack.pop()
                stack.append(h)
                j += 1
            while stack and stack[-1][2] < m:
                stack.pop()
            if stack:
                out[i] = stack[-1][0]
        return out

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of the operations whose name matches `pattern`
        (a compiled regular expression)."""
        return sum(b - a for n, a, b in self.ops if pattern.search(n)) * 1e-6

    def breakdown(self) -> Dict[str, list]:
        by_op: Dict[str, float] = collections.defaultdict(float)
        for n, a, b in self.ops:
            by_op[n[:160]] += (b - a) * 1e-6
        by_gap: Dict[str, float] = collections.defaultdict(float)
        for s, label in self.gaps:
            by_gap[label[:160]] += s
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
