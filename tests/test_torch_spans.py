"""The program's spans (``groomed_nms_torch/utils/spans.py``) and their
reduction by the benchmark (``benchmark/harness/spans.py``), on the CPU.

- Off, ``span`` hands out one shared no-op and never calls the profiler;
  on, it opens ``record_function("gnms.<name>")``.
- Under the CPU profiler the serving entry and a fused train step emit
  their span trees, in order; with the spans off neither emits a "gnms."
  event.
- The reduction of a hand-made trace: overlapping kernels counted once,
  launches and copies from threads without a span put down to the main
  thread's span, syncs and launches that waited, idle split by span, a
  kernel with no host call unattributed, and the metrics.
- ``card_measure.trace_kernel_ms`` counts overlapping kernels once.
"""

import contextlib
import json
import sys
from pathlib import Path

import pytest
import torch

from groomed_nms_torch.flagship import build_flagship, build_flagship_train
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.utils import spans

sys.path.append(str(Path(__file__).resolve().parents[1] / "benchmark"))
import card_measure  # noqa: E402
from harness import spans as bench_spans  # noqa: E402

TRUNK = ["trunk.stem", "trunk.block1", "trunk.transition1", "trunk.block2",
         "trunk.transition2", "trunk.block3", "trunk.transition3",
         "trunk.block4", "trunk.norm5"]
MODEL = ("model", [(n, []) for n in TRUNK] + [("head", [])])
TREES = {
    "infer": [("infer", [("preprocess", []), MODEL,
                         ("detect", [("detect.select", []),
                                     ("detect.decode", []),
                                     ("detect.nms", [])])])],
    # the flagship's step runs GrooMeD-NMS in its loss
    "train": [("preprocess", []),
              ("step", [MODEL,
                        ("loss", [("loss.targets", []),
                                  ("loss.sampling", []),
                                  ("loss.terms", [("loss.groomed", [])])]),
                        ("backward", []), ("optimizer", [])])]}


@pytest.fixture
def spans_on():
    spans.enable(True)
    try:
        yield
    finally:
        spans.enable(False)


def test_spans_off_hand_out_one_noop_and_on_open_a_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name)
                        or contextlib.nullcontext())
    assert not spans.enabled()
    off = spans.span("infer")
    assert off is spans.span("trunk.block1")
    with off:
        pass
    assert opened == []
    spans.enable(True)
    try:
        with spans.span("infer"):
            pass
    finally:
        spans.enable(False)
    assert opened == ["gnms.infer"]


@pytest.fixture(scope="module")
def entries():
    cpu = dict(batch=2, height=64, width=128, device="cpu",
               compute_dtype=None, src_hw=(48, 96))
    infer, args, _ = build_flagship(**cpu)
    step, state, raw = build_flagship_train(
        backbone=tiny_densenet_config(), **cpu)
    return {"infer": lambda: infer(*args), "train": lambda: step(state, raw)}


def _program_tree(prof, path):
    """The "gnms." ranges of a profile as [(name, children)], by nesting
    and in order."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"][len(spans.PREFIX):]) for e in events
                     if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e["name"].startswith(spans.PREFIX)),
                    key=lambda r: (r[0], -r[1]))
    root = ("", [])
    stack = [(float("inf"), root)]
    for s, e, name in ranges:
        while stack[-1][0] <= s:
            stack.pop()
        node = (name, [])
        stack[-1][1][1].append(node)
        stack.append((e, node))
    return root[1]


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("kind", ["infer", "train"])
def test_entry_points_emit_their_span_tree(entries, kind, on, tmp_path):
    spans.enable(on)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            entries[kind]()
    finally:
        spans.enable(False)
    assert _program_tree(prof, tmp_path / "t.json") == \
        (TREES[kind] if on else [])


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# main thread 1, autograd's thread 2, a prefetch worker 3; times in us
EVENTS = [
    _x("user_annotation", "bench.window", 0, 1000),
    _x("user_annotation", "bench.step", 0, 900),
    _x("user_annotation", "gnms.step", 10, 790),
    _x("user_annotation", "gnms.model", 10, 190),
    _x("user_annotation", "gnms.backward", 300, 400),
    _x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    _x("kernel", "k_a", 50, 100, tid=7, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=2),
    _x("kernel", "k_b", 100, 80, tid=8, corr=2),         # overlaps k_a
    _x("cuda_runtime", "cudaStreamSynchronize", 210, 80, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 400, 5, tid=2, corr=3),
    _x("kernel", "k_bwd", 420, 180, tid=7, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 505, 3, tid=3, corr=8),
    _x("gpu_memcpy", "Memcpy HtoD", 530, 10, tid=9, corr=8),
    # a launch that waited 150 us for room in the queue
    _x("cuda_runtime", "cudaLaunchKernel", 720, 150, corr=5),
    _x("cuda_runtime", "cudaMemcpyAsync", 850, 3, corr=7),
    _x("gpu_memcpy", "Memcpy DtoH", 860, 10, tid=9, corr=7),
    _x("kernel", "k_late", 880, 70, tid=7, corr=5),
    _x("kernel", "k_orphan", 960, 30, tid=7, corr=99),    # no host call
    _x("gpu_user_annotation", "gnms.step", 50, 900, tid=7),
]


def _by_name(red):
    return {sp.name: sp for sp in red["spans"]}


def _overlapping_kernels_count_once(red):
    model = bench_spans.totals(_by_name(red)["gnms.model"])
    assert model["dev_us"] == 130 and model["launches"] == 2


def _autograd_thread_goes_to_the_main_threads_span(red):
    bwd = _by_name(red)["gnms.backward"]
    assert [d[2] for d in bwd.dev][0] == "k_bwd"


def _a_workers_copy_goes_to_the_main_threads_span(red):
    bwd = _by_name(red)["gnms.backward"]
    assert [d[2] for d in bwd.dev] == ["k_bwd", "Memcpy HtoD"]


def _syncs_and_waiting_launches(red):
    step = _by_name(red)["gnms.step"]
    assert step.syncs == 1
    assert step.waits == [(210.0, 290.0), (720.0, 870.0)]
    assert bench_spans.totals(step)["launches"] == 4


def _unattributed_kernel(red):
    a = bench_spans.attribution(red)
    assert a["unattributed"] == 1 and a["unattributed_ms"] == 0.03
    assert a["attributed_share"] == pytest.approx(390 / 420)
    assert _by_name(red)["bench.step"].dev[0][2] == "Memcpy DtoH"


def _idle_split_by_span(red):
    spans_ = _by_name(red)
    assert {n: sp.idle for n, sp in spans_.items()} == {
        "bench.step": 80, "gnms.step": 200, "gnms.model": 60,
        "gnms.backward": 220}
    a = bench_spans.attribution(red)["idle_ms"]
    assert a["none"] == pytest.approx(0.02)
    assert a["program"] + a["harness"] + a["none"] == \
        pytest.approx(a["window"]) == pytest.approx(0.58)


def _metrics_and_table(red):
    m = bench_spans.metrics(red)
    assert m["step_host_ms.train"] == pytest.approx((790 - 160) / 1e3)
    assert m["step_syncs.train"] == 1 and m["step_launches.train"] == 4
    assert m["step_idle_ms.train"] == pytest.approx(0.48)
    assert m["infer_host_ms.serve"] is None and m["detect_ms.serve"] is None
    text = bench_spans.table(red, 1)
    assert "    gnms.backward" in text and text.splitlines()[-1].startswith(
        "none")


@pytest.mark.parametrize("check", [
    _overlapping_kernels_count_once,
    _autograd_thread_goes_to_the_main_threads_span,
    _a_workers_copy_goes_to_the_main_threads_span, _syncs_and_waiting_launches,
    _unattributed_kernel, _idle_split_by_span, _metrics_and_table],
    ids=lambda f: f.__name__.strip("_"))
def test_reduction_by_span(check):
    check(bench_spans.reduce(EVENTS))


def test_trace_kernel_ms_counts_overlapping_kernels_once(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 20, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 100}]}))
    assert card_measure.trace_kernel_ms(str(path)) == pytest.approx(0.02)
