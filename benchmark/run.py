"""One run of one benchmark cell of the PyTorch port (``groomed_nms_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and its files by name under
``benchmark/``: ``cells/<cell>.json`` (the limits of ``correct`` and the
plain reference, ``reference/<name>.py``), ``configs/``, ``traffic/`` (whose
``kind`` names the driver, ``harness/<kind>.py``), ``metrics/`` and
``work/``.  The driver builds the program's path for the cell from the
seed, warms up the shapes the cell uses (set-up), measures for
``--seconds`` and then decides ``correct`` with the plain reference.  The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit.  Exits non-zero, with
no result, without enough CUDA cards, when the port is missing, or when a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402


def run_cell(torch, workload, seed, seconds, trace, device, control=None,
             t_start=None):
    """Run the cell once on ``device``; return (result, checks).  The
    result's ``device`` holds the memory peak and, traced, the busy and
    window seconds; ``numbers`` every number the check computed, and
    ``details`` what the driver keeps for a look after the run."""
    from harness import peaks

    entry, cfg, traffic, cell, e2e, per_layer = common.cell_plan(workload)
    drive = common.driver(traffic["kind"]).drive
    ref = common.load_module("reference", cell["reference"])
    num = common.numerics(torch, cfg, control)
    readings = {"work": lambda name: common.load_module("work", name),
                "peaks": peaks}
    out = drive(torch, cfg, traffic, ref, seed, seconds, trace, device, num,
                T_START if t_start is None else t_start, readings)
    checks = {name: {"value": out["checked"][name], "limit": limit}
              for name, limit in cell["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics, device_extra, breakdown = {}, {}, None
    if trace:
        for m in per_layer:
            v = common.load_module("metrics", m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t = readings.get("trace")
        if t:
            device_extra = {"busy_s": t["busy_s"], "window_s": t["window_s"]}
            breakdown = {"device_ops": t["device_ops"],
                         "idle_gaps": t["idle_gaps"]}
    else:
        for m in e2e:
            if m["name"] in out["values"]:
                metrics[m["name"]] = {"value": out["values"][m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["peak"], **device_extra}}
    if breakdown:
        result["breakdown"] = breakdown
    result["numbers"] = out["checked"]
    result["details"] = out.get("details")
    return result, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    common.set_environment()
    entry = common.cell_plan(args.workload)[0]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(torch, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda"))
    bad = common.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    dev = common.device_info(torch, entry["chips"])
    result["device"] = {**dev, **result["device"]}
    del result["numbers"], result["details"]
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
