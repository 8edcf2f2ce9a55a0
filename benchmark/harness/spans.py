"""The traced window's events reduced by the program's spans.

The port marks its layer boundaries with ``record_function("gnms.<name>")``
(``groomed_nms_torch/utils/spans.py``), the harness its own with
"bench.<name>" (``trace.py``), and each CUDA API call on the host carries
the correlation id of the kernel, copy or set it enqueues.  ``reduce``
rebuilds each thread's span tree from the same "X" events that
``trace.profile`` returns and puts down to a span:

- each device interval of the window (clipped to it, as ``trace.reduce``
  clips): to the innermost open "gnms." span, on its thread, of the host
  call that shares its correlation id.  A call on a thread with no open
  program span (autograd's in the backward, a prefetch worker's) goes to
  the main thread's innermost span at that moment: a "gnms." span, else a
  "bench." span other than the window, else none.  The main thread is the
  one that opened "bench.window".  A device interval whose correlation id
  matches no host call is unattributed;
- each host call of the window whose name holds "Synchronize" (a sync), and
  each launch call ("Launch" in its name) longer than ``LAUNCH_WAIT_US`` (a
  launch that waited on a full launch queue), by the same rule;
- each idle stretch of the window (no device interval), split over time by
  the main thread's innermost span at each moment, by the same order.

A span's device time is the union of its intervals' and its descendants';
its self time the union of its own.  Its launches are its kernels.  Nothing
here imports the port: on a program without spans every device interval
goes to a "bench." span or none, and ``metrics`` finds nothing.
"""

from __future__ import annotations

import bisect
import math
import statistics
from collections import defaultdict

from .trace import DEVICE_CATS, PREFIX as BENCH, union

PROGRAM = "gnms."
HOST_CATS = ("cuda_runtime", "cuda_driver")
TRANSPOSES = ("nhwcToNchw", "nchwToNhwc")
CONV_MARKS = ("conv", "xmma", "gemm", "fprop", "dgrad", "wgrad", "winograd")
# A launch call that took longer than this waited for room in the launch
# queue (chosen from the card's own distribution of launch-call times:
# see PERF.md, section 5).
LAUNCH_WAIT_US = 100.0


class Span:
    """One instance of a span on one thread; times in microseconds."""

    __slots__ = ("name", "tid", "start", "end", "parent", "children", "dev",
                 "syncs", "waits", "idle")

    def __init__(self, name, tid, start, end):
        self.name, self.tid, self.start, self.end = name, tid, start, end
        self.parent, self.children = None, []
        self.dev = []            # (start, end, kernel name, is a kernel)
        self.syncs = 0
        self.waits = []          # (start, end) of syncs and waiting launches
        self.idle = 0.0

    def subtree(self):
        yield self
        for c in self.children:
            yield from c.subtree()

    def path(self):
        names, sp = [], self
        while sp is not None:
            names.append(sp.name)
            sp = sp.parent
        return tuple(reversed(names))


def _nest(spans):
    """Set each span's parent and children (spans of one thread)."""
    stack = []
    for sp in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= sp.start:
            stack.pop()
        if stack:
            sp.parent = stack[-1]
            stack[-1].children.append(sp)
        stack.append(sp)


class _Timeline:
    """The innermost open span of a set of spans of one thread, by time."""

    def __init__(self, spans):
        segs, stack, at = [], [], -math.inf

        def close(limit):
            nonlocal at
            while stack and stack[-1][0] <= limit:
                end, sp = stack.pop()
                if end > at:
                    segs.append((at, end, sp))
                    at = end

        for sp in sorted(spans, key=lambda s: (s.start, -s.end)):
            close(sp.start)
            if stack and sp.start > at:
                segs.append((at, sp.start, stack[-1][1]))
            at = sp.start
            stack.append((min(sp.end, stack[-1][0]) if stack else sp.end,
                          sp))
        close(math.inf)
        self.segs = segs
        self.starts = [s for s, _, _ in segs]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None

    def bounds(self):
        return [x for s, e, _ in self.segs for x in (s, e)]


def reduce(events):
    """The window's events by span: {"window": (start, end), "spans": every
    ``Span`` (its device intervals, syncs, waits and idle its own),
    "none": a ``Span`` holding what no span took, "unattributed": device
    intervals with no host call, "busy_us", "attributed_us" (device time
    put down to a span), "idle_us", "launch_us": the window's launch calls'
    durations}."""
    win = [e for e in events if e.get("name") == BENCH + "window"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main = win[0].get("tid")

    spans, by_tid = [], defaultdict(list)
    calls, host = [], {}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name != BENCH + "window" and \
                name.startswith((PROGRAM, BENCH)):
            s = float(e["ts"])
            sp = Span(name, e.get("tid"), s, s + float(e.get("dur", 0.0)))
            spans.append(sp)
            by_tid[sp.tid].append(sp)
        elif cat in HOST_CATS:
            calls.append(e)
            if "correlation" in e.get("args", {}):
                host[e["args"]["correlation"]] = e
    for group in by_tid.values():
        _nest(group)
    program = {tid: _Timeline([s for s in group
                               if s.name.startswith(PROGRAM)])
               for tid, group in by_tid.items()}
    harness = _Timeline([s for s in by_tid.get(main, ())
                         if s.name.startswith(BENCH)])
    empty = _Timeline([])
    none = Span("none", main, w0, w1)

    def on_main(t):
        return program.get(main, empty).at(t) or harness.at(t) or none

    def owner(tid, t):
        return program.get(tid, empty).at(t) or on_main(t)

    unattributed, attributed, device = [], [], []
    for e in events:
        if e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        device.append((s, t))
        call = host.get(e.get("args", {}).get("correlation"))
        if call is None:
            unattributed.append((s, t, e.get("name", "")))
            continue
        sp = owner(call.get("tid"), float(call["ts"]))
        sp.dev.append((s, t, e.get("name", ""),
                       e.get("cat", "").lower() == "kernel"))
        if sp is not none:
            attributed.append((s, t))

    launch_us = []
    for call in calls:
        s = float(call["ts"])
        if not w0 <= s <= w1:
            continue
        d = float(call.get("dur", 0.0))
        name = call.get("name", "")
        sync = "Synchronize" in name
        if "Launch" in name:
            launch_us.append(d)
        if sync or ("Launch" in name and d > LAUNCH_WAIT_US):
            sp = owner(call.get("tid"), s)
            sp.syncs += sync
            sp.waits.append((s, s + d))

    merged = union(device)
    cuts = sorted(set(program.get(main, empty).bounds() + harness.bounds()))
    at = w0
    for s, t in merged + [(w1, w1)]:
        if s > at:
            _split_idle(at, s, cuts, on_main)
        at = max(at, t)
    return {"window": (w0, w1), "spans": spans, "none": none,
            "unattributed": unattributed,
            "busy_us": _length(merged), "attributed_us": _length(
                union(attributed)),
            "idle_us": (w1 - w0) - _length(merged), "launch_us": launch_us}


def _split_idle(a, b, cuts, on_main):
    i = bisect.bisect_right(cuts, a)
    j = bisect.bisect_left(cuts, b)
    points = [a] + cuts[i:j] + [b]
    for s, t in zip(points, points[1:]):
        if t > s:
            on_main((s + t) / 2).idle += t - s


def _length(merged):
    return sum(t - s for s, t in merged)


def totals(sp):
    """A span's inclusive figures: {"host_us", "dev_us" (union), "self_us",
    "launches", "syncs", "idle_us", "waits" [(start, end)], "dev"}."""
    dev, launches, syncs, idle, waits = [], 0, 0, 0.0, []
    for x in sp.subtree():
        dev += x.dev
        launches += sum(k for *_, k in x.dev)
        syncs += x.syncs
        idle += x.idle
        waits += x.waits
    return {"host_us": sp.end - sp.start,
            "dev_us": _length(union([(s, t) for s, t, *_ in dev])),
            "self_us": _length(union([(s, t) for s, t, *_ in sp.dev])),
            "launches": launches, "syncs": syncs, "idle_us": idle,
            "waits": waits, "dev": dev}


def in_window(red):
    w0, w1 = red["window"]
    return [sp for sp in red["spans"] if w0 <= sp.start <= w1]


def _unit_of(sp):
    """The harness span a program span runs in (bench.submit, bench.step),
    or the span itself."""
    up = sp.parent
    while up is not None and not up.name.startswith(BENCH):
        up = up.parent
    return up or sp


def groups(red, names, need):
    """The window's instances of the spans ``names``, summed by the unit
    they run in, of the units that ran a span ``need``: [{"host_us",
    "dev_us", "launches", "syncs", "idle_us", "wait_us"}], one a unit."""
    by_unit = defaultdict(list)
    for sp in in_window(red):
        if sp.name in names:
            by_unit[id(_unit_of(sp))].append(sp)
    out = []
    for members in by_unit.values():
        if not any(sp.name == need for sp in members):
            continue
        tot = [totals(sp) for sp in members]
        waits = union([(max(s, sp.start), min(t, sp.end))
                       for sp, x in zip(members, tot) for s, t in x["waits"]
                       if min(t, sp.end) > max(s, sp.start)])
        out.append({"host_us": sum(x["host_us"] for x in tot),
                    "dev_us": _length(union([(s, t) for x in tot
                                             for s, t, *_ in x["dev"]])),
                    "launches": sum(x["launches"] for x in tot),
                    "syncs": sum(x["syncs"] for x in tot),
                    "idle_us": sum(x["idle_us"] for x in tot),
                    "wait_us": _length(waits)})
    return out


def _median(gs, f):
    return statistics.median(f(g) for g in gs) if gs else None


def _mean(gs, f):
    return statistics.fmean(f(g) for g in gs) if gs else None


def metrics(red):
    """The per-layer metrics the program's spans give, per unit of the
    window (medians of times, means of counts); None where the trace has
    no such span."""
    infer = groups(red, {PROGRAM + "infer"}, PROGRAM + "infer")
    detect = groups(red, {PROGRAM + "detect"}, PROGRAM + "detect")
    step = groups(red, {PROGRAM + "preprocess", PROGRAM + "step"},
                  PROGRAM + "step")
    return {
        "infer_host_ms.serve": _median(infer, lambda g: g["host_us"] / 1e3),
        "infer_syncs.serve": _mean(infer, lambda g: g["syncs"]),
        "infer_launches.serve": _mean(infer, lambda g: g["launches"]),
        "infer_idle_ms.serve": _median(infer, lambda g: g["idle_us"] / 1e3),
        "detect_ms.serve": _median(detect, lambda g: g["dev_us"] / 1e3),
        "step_host_ms.train": _median(
            step, lambda g: (g["host_us"] - g["wait_us"]) / 1e3),
        "step_syncs.train": _mean(step, lambda g: g["syncs"]),
        "step_launches.train": _mean(step, lambda g: g["launches"]),
        "step_idle_ms.train": _median(step, lambda g: g["idle_us"] / 1e3),
    }


def attribution(red):
    """The checks of completeness: the share of busy time put down to a
    span, the unattributed device intervals, and the idle time put down to
    program spans, harness spans and none against the window's."""
    prog = sum(sp.idle for sp in red["spans"]
               if sp.name.startswith(PROGRAM))
    bench = sum(sp.idle for sp in red["spans"] if sp.name.startswith(BENCH))
    return {"attributed_share": (red["attributed_us"] / red["busy_us"]
                                 if red["busy_us"] else None),
            "unattributed": len(red["unattributed"]),
            "unattributed_ms": _length(union(
                [(s, t) for s, t, _ in red["unattributed"]])) / 1e3,
            "idle_ms": {"program": prog / 1e3, "harness": bench / 1e3,
                        "none": red["none"].idle / 1e3,
                        "window": red["idle_us"] / 1e3}}


def table(red, units):
    """The per-span table, one row a span path, figures a unit (``units``
    units in the window): calls, host ms, device ms (inclusive, self),
    launches, syncs, idle ms; under each trunk stage its layout transposes'
    device ms and its convolution kernels."""
    rows = defaultdict(list)           # in the order of first appearance
    for sp in sorted(in_window(red), key=lambda s: s.start):
        rows[sp.path()].append(sp)
    n = max(units, 1)
    head = (f"{'span':44s} {'calls':>6s} {'host ms':>9s} {'dev ms':>9s} "
            f"{'self ms':>9s} {'launch':>8s} {'syncs':>6s} {'idle ms':>8s}")
    lines = [f"per-span table, figures a unit over {units} units", head]
    for p in list(rows) + [("none",)]:
        members = rows[p] if p != ("none",) else [red["none"]]
        tot = [totals(sp) for sp in members]
        label = "  " * (len(p) - 1) + p[-1]
        calls = len(members) / n if p != ("none",) else 0.0
        host = sum(x["host_us"] for x in tot) / n / 1e3 \
            if p != ("none",) else 0.0
        lines.append(
            f"{label[:44]:44s} {calls:6.2f} {host:9.3f} "
            f"{sum(x['dev_us'] for x in tot) / n / 1e3:9.3f} "
            f"{sum(x['self_us'] for x in tot) / n / 1e3:9.3f} "
            f"{sum(x['launches'] for x in tot) / n:8.1f} "
            f"{sum(x['syncs'] for x in tot) / n:6.2f} "
            f"{sum(x['idle_us'] for x in tot) / n / 1e3:8.3f}")
        if p[-1].startswith(PROGRAM + "trunk."):
            dev = [d for x in tot for d in x["dev"]]
            trans = _length(union([(s, t) for s, t, name, _ in dev
                                   if any(m in name for m in TRANSPOSES)]))
            convs = defaultdict(lambda: [0, 0.0])
            for s, t, name, _ in dev:
                if any(m in name.lower() for m in CONV_MARKS) and \
                        not any(m in name for m in TRANSPOSES):
                    convs[name][0] += 1
                    convs[name][1] += t - s
            lines.append(f"{'':{2 * len(p)}s}transposes {trans / n / 1e3:.3f}"
                         " ms a unit")
            for name, (k, us) in sorted(convs.items(), key=lambda x: -x[1][1]):
                lines.append(f"{'':{2 * len(p)}s}conv {k / n:5.1f} x "
                             f"{us / n / 1e3:8.3f} ms  {name[:90]}")
    return "\n".join(lines)
