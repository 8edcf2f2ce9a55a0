"""Readings for the limits of ``correct``: a cell run on many seeds in one
process, with the configuration's precision or a control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control tf32|bf16] [--fault NAME] [--seconds 3] [--look f64]

Prints one JSON line a seed with each number the check computes; the
limits in ``cells/<cell>.json`` are set from the program's largest reading
and the smallest reading of the control or of a planted fault
(``harness/faults.py``).  ``--look f64`` (training cells) also runs the
reference's first step in f64 and reads, against it, the program's first
change and the f32 reference's, by the median leaf as
``change1_gap_median`` does, and both first losses.  Not run by the
benchmark itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as bench  # noqa: E402
from harness.faults import FAULTS, plant  # noqa: E402


def f64_look(torch, workload, seed, details):
    """The program's and the f32 reference's first step against the
    reference's first step in f64, on the same batch and weights."""
    from harness.checks import leaf_gaps
    from harness.train import reference_steps

    _, cfg, _, cell, _, _ = bench.common.cell_plan(workload)
    ref = bench.common.load_module("reference", cell["reference"])
    bench.common.reference_numerics(torch)
    r64 = reference_steps(torch, cfg, ref, seed, torch.device("cuda"),
                          details["pool"][:1], torch.float64)
    r32, first = details["reference"], details["first"]
    p0, p1 = first["params"][0], first["params"][1]
    skip = details["skip"]

    def median(g):
        return sorted(g.values())[len(g) // 2]

    return {"program_vs_f64": median(leaf_gaps(
                {n: p1[n] - p0[n] for n in r64["change1"]}, r64["change1"],
                skip)),
            "f32_vs_f64": median(leaf_gaps(r32["change1"], r64["change1"],
                                           skip)),
            "loss_program": first["losses"][0],
            "loss_f32": r32["losses"][0], "loss_f64": r64["losses"][0]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=bench.common.CONTROLS)
    p.add_argument("--fault", choices=FAULTS)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--look", choices=("f64",))
    args = p.parse_args(argv)
    bench.common.set_environment()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        with plant(args.fault):
            res, checks = bench.run_cell(
                torch, args.workload, seed, args.seconds, False,
                torch.device("cuda"), control=args.control,
                t_start=time.perf_counter())
        look = f64_look(torch, args.workload, seed, res["details"]) \
            if args.look else None
        print(json.dumps({"seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": res["correct"],
                          "values": res["numbers"], "look": look,
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
