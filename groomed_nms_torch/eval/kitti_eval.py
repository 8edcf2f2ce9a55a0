"""Python wrapper around the parameterized KITTI C++ evaluator
(``eval/kitti_eval.cpp``, shared with the JAX package).

The port's copy of ``groomed_nms_tpu/eval/kitti_eval.py``: runs the binary,
parses the stats files into AP|R40 / AP|R11 per class x difficulty x
metric, and sweeps the distance x IoU grid (4 distances x 7 IoU thresholds)
unless ``fast_eval``.  ``save_kitti_roc`` (matplotlib) is not ported.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import shutil
import subprocess

import numpy as np

from ..ops import _build

# the repository's one evaluator, shared with the JAX package
_EVAL_DIR = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir, "eval"))
_BINARY = os.path.join(_EVAL_DIR, "kitti_eval")
_SOURCE = os.path.join(_EVAL_DIR, "kitti_eval.cpp")
# eval/Makefile's defaults, for a machine without make
_CXXFLAGS = ["-O3", "-std=c++17", "-Wall"]

CLASSES = ("car", "pedestrian", "cyclist")
METRICS = ("detection", "orientation", "detection_ground", "detection_3d")
DIFFICULTIES = ("easy", "moderate", "hard")


def ensure_binary():
    """Compile eval/kitti_eval through eval/Makefile (a no-op when fresh),
    so an edit to kitti_eval.cpp never evaluates with a stale binary.
    Without ``make``, the host compiler runs with the Makefile's flags when
    the binary is missing or older than its source.  Callers in this
    package build one at a time (a lock file in the build directory)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_build.BUILD_DIR / "kitti_eval.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if shutil.which("make"):
            subprocess.check_call(["make", "-C", _EVAL_DIR, "kitti_eval"],
                                  stdout=subprocess.DEVNULL)
        elif (not os.path.exists(_BINARY) or os.path.getmtime(_BINARY)
              < os.path.getmtime(_SOURCE)):
            cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
            subprocess.check_call([cxx, *_CXXFLAGS, "-o", _BINARY, _SOURCE])
    return _BINARY


def ap_from_precision(values, protocol="R40"):
    """AP from 41 interpolated precision points.

    Reference parse_kitti_result (lib/rpn_util.py:2031-2038): R40 = mean of
    points 1..40; R11 = mean of every 4th point of all 41 (incl. point 0).
    """
    values = np.asarray(values, np.float64)
    if protocol == "R40":
        return float(values[1:41].mean() * 100.0)
    if protocol == "R11":
        return float(values[0:41:4].mean() * 100.0)
    raise ValueError(protocol)


def parse_stats_file(path, protocol="R40"):
    """[easy, moderate, hard] AP from one stats txt (3 rows x 41 values)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) >= 41:
                rows.append(ap_from_precision(vals, protocol))
    return rows


def run_kitti_eval(results_dir, gt_dir, overlaps=(0.7, 0.5, 0.5),
                   max_dist=None, protocol="R40"):
    """Run the binary once; returns {(cls, metric): [easy, mod, hard]}.

    ``results_dir`` must contain ``data/*.txt`` detections.
    """
    binary = ensure_binary()
    # the binary only writes stats files for class/metric pairs enabled by
    # the CURRENT detections; clear leftovers from a previous eval so they
    # cannot be reported as this run's results
    for cls in CLASSES:
        for metric in METRICS:
            stale = os.path.join(results_dir, f"stats_{cls}_{metric}.txt")
            if os.path.exists(stale):
                os.remove(stale)
    cmd = [binary, os.path.abspath(results_dir), os.path.abspath(gt_dir),
           "--overlap", str(overlaps[0]), str(overlaps[1]), str(overlaps[2])]
    if max_dist is not None and max_dist > 0:
        cmd += ["--max_dist", str(max_dist)]
    subprocess.check_output(cmd)

    results = {}
    for cls in CLASSES:
        for metric in METRICS:
            path = os.path.join(results_dir, f"stats_{cls}_{metric}.txt")
            if os.path.exists(path):
                results[(cls, metric)] = parse_stats_file(path, protocol)
    return results


def evaluate_kitti_results_verbose(results_dir, gt_dir, fast_eval=True,
                                   protocol="R40", log_fn=print):
    """The reference's full evaluation sweep (lib/rpn_util.py:2076-2200).

    Main pass at (0.7, 0.5, 0.5), side pass at (0.5, 0.3, 0.3), and --
    unless ``fast_eval`` -- the 4x7 distance x IoU grid, pickled as
    ``ap_vs_iou_vs_dist.pkl`` for the plot suite.
    """
    out = {"main": run_kitti_eval(results_dir, gt_dir, (0.7, 0.5, 0.5),
                                  protocol=protocol)}
    for (cls, metric), aps in sorted(out["main"].items()):
        log_fn(f"{cls} {metric} AP|{protocol}: "
               + " / ".join(f"{a:.2f}" for a in aps))

    out["side"] = run_kitti_eval(results_dir, gt_dir, (0.5, 0.3, 0.3),
                                 protocol=protocol)

    if not fast_eval:
        grid = {}
        for dist in (15, 30, 45, 60):
            for iou10 in range(1, 8):
                ov = iou10 / 10.0
                key = f"{dist}m_0_{iou10}"
                grid[key] = run_kitti_eval(results_dir, gt_dir, (ov, ov, ov),
                                           max_dist=dist, protocol=protocol)
        out["grid"] = grid
        with open(os.path.join(results_dir, "ap_vs_iou_vs_dist.pkl"),
                  "wb") as f:
            pickle.dump(grid, f)
    return out


def kitti_roc_table(results_dir, gt_dir, cls="car", metric="detection_3d",
                    ious=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7), protocol="R40",
                    log_fn=print):
    """AP-vs-IoU-threshold ROC table (reference print_kitti_ROC,
    lib/rpn_util.py:2203-2224). Returns {iou: [easy, mod, hard]}."""
    table = {}
    for ov in ious:
        res = run_kitti_eval(results_dir, gt_dir, (ov, ov, ov),
                             protocol=protocol)
        table[ov] = res.get((cls, metric), [0.0, 0.0, 0.0])
    header = "IoU   " + "  ".join(f"{d:>8}" for d in DIFFICULTIES)
    log_fn(header)
    for ov, aps in table.items():
        log_fn(f"{ov:.2f}  " + "  ".join(f"{a:8.2f}" for a in aps))
    return table
