"""What every cell shares: finding a cell's files by name, the run's
environment and precision, the device line, the percentile, and the result
line.

Everything a cell, a configuration, a traffic mix, a per-layer metric, a
kernel's work, a plain reference or a driver needs is found by its name
under ``benchmark/``: the cell's file names its reference
(``reference/<name>.py``) and the traffic's ``kind`` its driver
(``harness/<kind>.py``), so a later cell, also one of a configuration
already here, is new files and new entries only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = BENCH.parent                                   # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "groomed_nms_tpu")
CONTROLS = ("tf32", "bf16")


def set_environment():
    """Caches at fixed paths inside the checkout, set before anything
    imports triton; no library may load JAX behind the port's back."""
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def numerics(torch, cfg, control=None):
    """Set the configuration's precision (or a control's one below it) and
    return {"dtype": autocast dtype or None}."""
    n = cfg["numerics"]
    torch.backends.cudnn.allow_tf32 = n["cudnn_allow_tf32"] or control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = (n["matmul_allow_tf32"]
                                             or control == "tf32")
    torch.backends.cudnn.benchmark = n["cudnn_benchmark"]
    dtype = {"float32": None, "bfloat16": torch.bfloat16}[n["compute_dtype"]]
    return {"dtype": torch.bfloat16 if control == "bf16" else dtype}


def reference_numerics(torch):
    """The plain reference's precision: f32 products, and cuDNN's heuristic
    choice of algorithm, so that the check autotunes nothing."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def load_json(kind, name):
    """``benchmark/<kind>/<name>.json``."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark_spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module; references load inside
    the ``reference`` package so that they may import its shared pieces."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(path)
    safe = re.sub(r"\W", "_", name)
    mod_name = f"{kind}.{safe}" if kind == "reference" \
        else f"_bench_{kind}_{safe}"
    if kind == "reference":
        importlib.import_module("reference")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(kind):
    """The driver of a traffic ``kind``: ``harness/<kind>.py``, whose
    ``drive`` runs one cell's set-up, window and check."""
    if not re.fullmatch(r"[A-Za-z]\w*", kind) or \
            not (BENCH / "harness" / f"{kind}.py").exists():
        raise SystemExit(f"no driver harness/{kind}.py for traffic kind "
                         f"{kind!r}")
    mod = importlib.import_module(f"harness.{kind}")
    if not hasattr(mod, "drive"):
        raise SystemExit(f"harness/{kind}.py has no drive()")
    return mod


def cell_plan(workload):
    """The cell's entry of BENCHMARK.json, its configuration, traffic and
    cell files, and the metrics it reports: (workload entry, config,
    traffic, cell, end-to-end metric entries, per-layer metric entries)."""
    spec = benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return (entry, load_json("configs", entry["config"]),
            load_json("traffic", entry["traffic"]),
            load_json("cells", workload),
            [m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def percentile(values, q):
    """The ``q``-th percentile (0-100) of all values, linear between the
    two closest ranks."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(torch, chips):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def emit(result, checks):
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line, with ``checks`` as its last key,
    as the last line of standard output."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
