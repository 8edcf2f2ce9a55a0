"""The traced window: ``torch.profiler`` over a few units of work, reduced
to the device's busy time, its idle gaps named by the harness's host spans,
and the kernels' times by name.

The harness marks its own host spans with ``record_function("bench.<name>")``
("submit", "copy", "wait rows", "step", "prefetch wait") and the analysed
window with "bench.window".  Busy time is the length of the union of the
device's kernel, copy and set intervals inside the window: kernels that
overlap count once.  An idle gap is a stretch of the window covered by no
device interval; it is named by the host span that overlaps it most.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."


def span(torch):
    """``span(name)``: a host span the trace sees."""
    def make(name):
        return torch.profiler.record_function(PREFIX + name)
    return make


def profile(torch, body):
    """Run ``body(span)`` under the profiler; return the trace's events
    (the Chrome trace's "X" events)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        body(span(torch))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [e for e in events if e.get("ph") == "X"]


def union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def reduce(events):
    """The window's reduction (times in seconds): window_s, busy_s, the
    device intervals, kernels [(name, start, end)], the longest idle gaps
    [(host span, s)], the top device operations [(name, s)]."""
    win = [e for e in events if e.get("name") == PREFIX + "window"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], defaultdict(float)
    for e in events:
        if e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        s, t = max(s, w0), min(t, w1)
        if t > s:
            dev.append((s, t, e.get("name", "")))
            by_name[e.get("name", "")] += (t - s) * 1e-6
    merged = union([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged) * 1e-6
    gaps, at = [], w0
    for s, t in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][len(PREFIX):]) for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)
            and e["name"] != PREFIX + "window"]
    named = []
    for s, t in gaps:
        best, label = 0.0, "other"
        for hs, ht, name in host:
            o = min(t, ht) - max(s, hs)
            if o > best:
                best, label = o, name
        named.append((label, (t - s) * 1e-6))
    named.sort(key=lambda x: -x[1])
    top = sorted(by_name.items(), key=lambda x: -x[1])
    kernels = [(n, s * 1e-6, t * 1e-6) for s, t, n in dev]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy, "kernels": kernels,
            "idle_gaps": [list(x) for x in named[:10]],
            "device_ops": [list(x) for x in top[:10]]}
