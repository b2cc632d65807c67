"""Reduction of a `torch.profiler` trace of a steady sub-window.

`Profile` traces the CPU and the CUDA device; `reduce_trace(path)`
reads the exported Chrome trace and returns a `TraceSummary`: the window's
length, the seconds in which some operation ran on the device (the union of
kernel, copy and set intervals), device seconds by operation name, and the
idle gaps between device operations by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
LONG_US = 10_000.0  # host events longer than this (µs) are few


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)  # name -> device seconds
    idle_by_host: dict = field(default_factory=dict)  # host activity -> idle seconds
    device_events: int = 0

    def top_ops(self, n=10):
        return [[k, v] for k, v in sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n=10):
        return [[k, v] for k, v in sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]]


class Profile:
    """`torch.profiler` over the CPU and the CUDA device between `start()`
    and `stop()`; `export(path)` writes the Chrome trace afterwards, so
    that writing it falls outside the traced window."""

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.prof.start()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def export(self, path: str):
        self.prof.export_chrome_trace(path)
        self.prof = None


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(path: str) -> TraceSummary:
    """The summary of a Chrome trace over the span of its events."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        item = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("name", "?"))
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat in HOST_CATS:
            host.append(item)
    spans = device + host
    if not spans:
        return TraceSummary(0.0, 0.0)
    w0, w1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    ops = defaultdict(float)
    for s, e, name in device:
        ops[name] += (e - s) * 1e-6
    merged = _merge([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in merged)
    gaps, last = [], w0
    for s, e in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    idle = defaultdict(float)
    # short host events are found by their start; the few long ones are all scanned
    short = sorted(h for h in host if h[1] - h[0] <= LONG_US)
    long_ = [h for h in host if h[1] - h[0] > LONG_US]
    starts = [s for s, _, _ in short]
    for g0, g1 in gaps:
        best, best_key = None, None
        lo = bisect.bisect_left(starts, g0 - LONG_US)
        hi = bisect.bisect_right(starts, g1)
        for s, e, name in short[lo:hi] + long_:
            overlap = min(e, g1) - max(s, g0)
            if overlap <= 0:
                continue
            key = (overlap, -(e - s))  # the most overlap, then the innermost
            if best_key is None or key > best_key:
                best, best_key = name, key
        idle[best or "host: no traced activity"] += (g1 - g0) * 1e-6
    return TraceSummary((w1 - w0) * 1e-6, busy * 1e-6, dict(ops), dict(idle), len(device))
