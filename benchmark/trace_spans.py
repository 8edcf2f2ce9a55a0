"""One run of a benchmark cell with the program's spans on, reduced by span.

    python3 benchmark/trace_spans.py --workload <cell> --seed <n> --seconds <s>

It runs the cell as ``run.py --trace 1`` does (set-up, the window, the
traced units, the check) with the program's spans
(``groomed_nms_torch/utils/spans.py``) switched on around the profiled
units only, and also reduces the profiler's events by span
(``harness/spans.py``): the per-span table goes to standard error, and the
last line of standard output is ``run.py``'s result line with a "spans"
key: the span metrics (``spans.metrics``), the checks of completeness
(``spans.attribution``) and the distribution of the window's launch-call
times.  On a program without spans the run is the plain one and "spans"
finds nothing.  It exits with 4 if the cell's ``harness/<kind>.py`` never
called ``harness.trace.profile`` (so nothing was reduced), or if the
program has spans and the window holds none of them.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import run
from harness import common, spans, trace


def launch_times(us):
    """Quartiles, 90th and 99th percentile and maximum of launch-call
    durations (us), and how many exceed 50, 100, 200 and 500 us."""
    if len(us) < 2:
        return None
    q = statistics.quantiles(us, n=100, method="inclusive")
    return {"n": len(us), "q1": q[24], "median": q[49], "q3": q[74],
            "p90": q[89], "p99": q[98], "max": max(us),
            "over": {str(t): sum(u > t for u in us) for t in (50, 100, 200,
                                                               500)}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    common.set_environment()
    entry, _, traffic, *_ = common.cell_plan(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        from groomed_nms_torch.utils import spans as program
    except ImportError:              # a program without spans
        program = None
    kept = []
    profile = trace.profile

    def profile_with_spans(torch, body):
        def spanned(sp):
            program.enable(True)
            try:
                body(sp)
            finally:
                program.enable(False)

        events = profile(torch, spanned if program else body)
        kept.append(events)
        return events

    # harness/<kind>.py looks trace.profile up when its window is traced
    trace.profile = profile_with_spans
    result, checks = run.run_cell(torch, args.workload, args.seed,
                                  args.seconds, True, torch.device("cuda"))
    bad = common.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    if not kept:
        print(f"harness/{traffic['kind']}.py did not call "
              "harness.trace.profile: no events to reduce", file=sys.stderr)
        return 4
    red = spans.reduce(kept[-1])
    if program and not any(sp.name.startswith(program.PREFIX)
                           for sp in red["spans"]):
        print(f"no {program.PREFIX}* span in the traced window",
              file=sys.stderr)
        return 4
    print(spans.table(red, traffic["trace_units"]), file=sys.stderr)
    result["spans"] = {"metrics": spans.metrics(red),
                       **spans.attribution(red),
                       "launch_us": launch_times(red["launch_us"])}
    result["device"] = {**common.device_info(torch, entry["chips"]),
                        **result["device"]}
    del result["numbers"], result["details"]
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
