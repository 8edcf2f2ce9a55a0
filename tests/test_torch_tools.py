"""The port's tool twins (``scripts/*_torch.py``, ``analysis/*_torch.py``)
against the JAX tools, on the CPU at small sizes.

- ``compare_video_training_schemes_torch.run(iters=2, batch=2, n_eval=2)``
  against the JAX tool's ``run`` from JAX's initial weights (carried across
  by ``from_flax``), both in f64 (``PoseNet`` computes in f32 in both): the
  per-step losses and the three metrics of each scheme and of the untrained
  model within 1e-6 relative.
- The GrooMeD micro-bench's operator at N = 64 against JAX's
  ``differentiable_nms`` over JAX's ``pairwise_iou`` (keep and leaders
  identical, rescored within 1e-6), K3's plain version against JAX's Pallas
  kernel in interpret mode (IoU and prune within 1e-6), and its ``main()``
  on the CPU.
- The synthetic tree, still and ``--video``, 4 + 2 frames of 64x192: the
  same files, labels and calibration byte for byte, images pixel for pixel.
- ``determine_seqs`` and ``detection_stats``: the same stdout as the JAX
  scripts (the mapping files of the video tree; the GT and detection lines
  of ``test_analysis_tools.py``).
- The roofline's counts: the analytic FLOPs and bytes of a small conv
  stack, and its guard tripping on a forged time; its ``main()`` in both
  modes.
- The profile (a Chrome trace written), the latency table and the loader
  bench (its JSON line) through their ``main()`` on the CPU.
"""

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from groomed_nms_tpu.models import video as jv
from groomed_nms_tpu.models import densenet as jdensenet
from groomed_nms_tpu.ops.groomed_nms import differentiable_nms as jax_dnms
from groomed_nms_tpu.ops.iou import pairwise_iou as jax_pairwise_iou
from groomed_nms_tpu.ops.pallas_kernels import fused_iou_prune as jax_k3

from groomed_nms_torch.data.png import read_png
from groomed_nms_torch.ops import kernels
from groomed_nms_torch.utils.weights import from_flax
from test_analysis_tools import DET_LINE, GT_LINE, _write

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6
OPERATOR_ATOL, K3_ATOL = 1e-6, 1e-6


def _load(relpath):
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(mod, argv, monkeypatch):
    """A JAX script's ``main()`` (it parses sys.argv) and its stdout."""
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def _torch_main(mod, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the video-scheme comparison
# ---------------------------------------------------------------------------

def test_video_schemes_match_jax(monkeypatch):
    jtool = _load("analysis/compare_video_training_schemes.py")
    ttool = _load("analysis/compare_video_training_schemes_torch.py")
    f64 = jdensenet.tiny_densenet_config(jnp.float64)
    monkeypatch.setattr(jdensenet, "tiny_densenet_config", lambda: f64)
    init = {}

    class Video64(jv.VideoRPN3D):
        """JAX's model with its variables cast to f64 as initialised."""

        def init(self, *args, **kwargs):
            v = jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float64)
                if np.issubdtype(np.asarray(x).dtype, np.floating)
                else np.asarray(x), super().init(*args, **kwargs))
            init.update(v)
            return v

    monkeypatch.setattr(jv, "VideoRPN3D", Video64)
    jlosses = []
    real_vag = jax.value_and_grad

    def value_and_grad(fn, *a, **k):
        g = real_vag(fn, *a, **k)

        def wrapped(*args, **kw):
            val, grads = g(*args, **kw)
            jax.debug.callback(lambda v: jlosses.append(float(v)), val,
                               ordered=True)
            return val, grads
        return wrapped

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    with jax.enable_x64(True):
        want = jtool.run(iters=2, batch=2, n_eval=2, log=lambda s: None)
        jax.effects_barrier()
    tlosses = {}
    got = ttool.run(iters=2, batch=2, n_eval=2, log=lambda s: None,
                    device="cpu", dtype=torch.float64,
                    state_dict=from_flax(init["params"],
                                         init.get("batch_stats")),
                    step_losses=tlosses)
    np.testing.assert_allclose(tlosses["direct"] + tlosses["fused"],
                               jlosses, rtol=REL)
    assert set(got) == set(want) == {"direct", "fused", "untrained"}
    for scheme, metrics in want.items():
        assert set(got[scheme]) == set(metrics)
        for k, v in metrics.items():
            assert (got[scheme][k] is None) == (v is None), (scheme, k)
            if v is not None:
                np.testing.assert_allclose(got[scheme][k], v, rtol=REL,
                                           err_msg=f"{scheme} {k}")
    # the two schemes trained different weights
    assert got["direct"] != got["fused"]


def test_video_schemes_main_writes_its_own_file(tmp_path):
    tool = _load("analysis/compare_video_training_schemes_torch.py")
    assert tool.parse_args([]).out.endswith(
        os.path.join("analysis", "video_scheme_comparison_torch.json"))
    out = str(tmp_path / "v.json")
    tool.main(["--iters", "1", "--batch", "1", "--n-eval", "1",
               "--device", "cpu", "--out", out])
    with open(out) as f:
        res = json.load(f)
    assert set(res) == {"direct", "fused", "untrained"}
    assert all(v is None or np.isfinite(v) for m in res.values()
               for v in m.values())


# ---------------------------------------------------------------------------
# the GrooMeD micro-bench
# ---------------------------------------------------------------------------

def test_groomed_bench_matches_jax():
    tool = _load("analysis/bench_groomed_nms_torch.py")
    jtool = _load("analysis/bench_groomed_nms.py")
    boxes, scores = tool.inputs(64)
    got = tool.operator(torch.from_numpy(scores), torch.from_numpy(boxes))
    jb = jnp.asarray(boxes)
    want = jax_dnms(jnp.asarray(scores), jax_pairwise_iou(jb, jb))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_array_equal(got.leader.numpy(),
                                  np.asarray(want.leader))
    np.testing.assert_allclose(got.rescored.numpy(),
                               np.asarray(want.rescored), rtol=0,
                               atol=OPERATOR_ATOL)
    assert got.keep.any() and (got.leader >= 0).any()
    # the JAX tool draws the same boxes (its main() builds them inline)
    assert "default_rng(0)" in open(jtool.__file__).read()
    iou, prune = kernels.fused_iou_prune_plain(
        torch.from_numpy(boxes)[None], torch.ones((1, 64), dtype=torch.bool))
    jiou, jprune = jax_k3(jb, interpret=True)
    np.testing.assert_allclose(iou[0].numpy(), np.asarray(jiou), rtol=0,
                               atol=K3_ATOL)
    np.testing.assert_allclose(prune[0].numpy(), np.asarray(jprune), rtol=0,
                               atol=K3_ATOL)


def test_groomed_bench_main_on_the_cpu():
    tool = _load("analysis/bench_groomed_nms_torch.py")
    out = tool.main(["64", "2", "--device", "cpu"])
    assert out["rescored_err"] == 0.0
    assert out["operator_ms"] > 0 and out["k3_ms"] > 0
    # the plain versions ran: no kernel was launched
    assert not any(out["launches_per_call"].values())


def test_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path, argv in (("analysis/bench_groomed_nms_torch.py", ["8", "1"]),
                       ("analysis/bench_latency_torch.py", ["--batches", "1"]),
                       ("analysis/roofline_train_torch.py", []),
                       ("scripts/profile_torch.py", [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(path).main(argv)


# ---------------------------------------------------------------------------
# the synthetic tree, determine_seqs, detection_stats
# ---------------------------------------------------------------------------

def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


@pytest.mark.parametrize("video", [False, True])
def test_synthetic_tree_matches_jax(tmp_path, monkeypatch, video):
    argv = ["--train", "4", "--val", "2", "--im-h", "64", "--im-w", "192"] + \
        (["--video", "--n-prev", "2"] if video else [])
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    _jax_main(_load("scripts/make_synthetic_kitti.py"),
              ["--root", jroot, *argv], monkeypatch)
    _torch_main(_load("scripts/make_synthetic_kitti_torch.py"),
                ["--root", troot, *argv])
    files = _files(jroot)
    assert files == _files(troot) and len(files) > 12
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(troot, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(a), read_png(b),
                                          err_msg=rel)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_determine_seqs_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "video")
    _torch_main(_load("scripts/make_synthetic_kitti_torch.py"),
                ["--root", root, "--video", "--train", "4", "--val", "3",
                 "--n-prev", "1", "--im-h", "32", "--im-w", "96"])
    with open(os.path.join(root, "devkit", "mapping",
                           "train_mapping.txt")) as f:
        seqs = sorted({line.split()[1] for line in f if line.strip()})
    ids = str(tmp_path / "ids.txt")
    with open(ids, "w") as f:
        f.write("\n".join(str(i) for i in (5, 0, 3, 1, 6)) + "\n")
    tracklets = str(tmp_path / "tracklets.txt")
    with open(tracklets, "w") as f:
        f.write(seqs[0] + "\n")
    for extra in ([], ["--tracklets", tracklets]):
        argv = ["--root", root, "--ids", ids, *extra]
        want = _jax_main(_load("scripts/determine_seqs.py"), argv,
                         monkeypatch)
        got = _torch_main(_load("scripts/determine_seqs_torch.py"), argv)
        assert got == want and "seqs used" in got


def test_detection_stats_matches_jax(tmp_path, monkeypatch):
    gt, res = tmp_path / "label_2", tmp_path / "data"
    rs = np.random.default_rng(3)
    for i in range(3):
        xs, zs = rs.uniform(-5, 5, 3), rs.uniform(10, 40, 3)
        _write(str(gt / f"{i:06d}.txt"),
               [GT_LINE.format(occ=0, x=f"{x:.2f}", z=f"{z:.2f}")
                for x, z in zip(xs, zs)])
        _write(str(res / f"{i:06d}.txt"),
               [DET_LINE.format(x=f"{x + dx:.2f}", z=f"{z + dz:.2f}",
                                score=f"{s:.2f}")
                for x, z, dx, dz, s in zip(
                    xs, zs, rs.normal(0, 0.3, 3), rs.normal(0, 1.0, 3),
                    rs.uniform(0.2, 1.0, 3))])
    argv = ["--results", str(res), "--gt", str(gt)]
    want = _jax_main(_load("analysis/detection_stats.py"), argv, monkeypatch)
    got = _torch_main(_load("analysis/detection_stats_torch.py"), argv)
    assert got == want and "correlation" in got and "z error" in got


# ---------------------------------------------------------------------------
# the roofline, the profile, the latency table, the loader bench
# ---------------------------------------------------------------------------

def test_roofline_counts_a_conv_stack():
    tool = _load("analysis/roofline_train_torch.py")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, 20, generator=g)
    w1 = torch.randn(8, 3, 3, 3, generator=g)
    w2 = torch.randn(4, 8, 1, 1, generator=g)

    def stack():
        return F.conv2d(F.conv2d(x, w1, padding=1), w2)

    flops, nbytes, kbytes = tool.count(stack)
    hw = 16 * 20
    assert flops == 2 * 2 * hw * (8 * 3 * 9 + 4 * 8)
    mid, out = 2 * 8 * hw, 2 * 4 * hw
    assert nbytes == 4 * ((x.numel() + w1.numel() + mid)
                          + (mid + w2.numel() + out))
    assert kbytes == 0


def test_roofline_guard_trips_on_a_forged_time():
    tool = _load("analysis/roofline_train_torch.py")
    ok = tool.roofline("train", 8, 1e12, 1e9, 0, 0.1)      # 10 TFLOP/s
    assert ok["pct_of_tensor_peak"] == pytest.approx(100 * 10 / 989,
                                                     abs=0.01)
    with pytest.raises(SystemExit, match="exceeds"):
        tool.roofline("train", 8, 1e12, 1e9, 0, 1e-4)      # 10 PFLOP/s


@pytest.mark.parametrize("argv", [
    ["--mode", "train", "--remat", "layer"], ["--mode", "infer"]])
def test_roofline_main_on_the_cpu(argv):
    tool = _load("analysis/roofline_train_torch.py")
    out = tool.main([*argv, "--device", "cpu", "--batch", "2", "--iters",
                     "1", "--crop", "64", "128", "--src", "48", "96"])
    assert out["logical_tflop_per_call"] > 0
    assert out["kernel_traffic_gb_per_call"] > 0     # the custom ops seen
    assert out["logical_traffic_gb_per_call"] > \
        out["kernel_traffic_gb_per_call"]


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_profile_main_writes_a_trace(tmp_path, mode):
    tool = _load("scripts/profile_torch.py")
    out = tool.main(["--mode", mode, "--out", str(tmp_path), "--batch", "2",
                     "--iters", "1", "--device", "cpu", "--crop", "64",
                     "128", "--src", "48", "96"])
    with open(out["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert set(out["trace_kernels"]) == set(out["launches_per_call"]) == {
        "fused_head_scores", "greedy_nms", "fused_iou_prune",
        "group_leaders"}


def test_latency_main_on_the_cpu():
    tool = _load("analysis/bench_latency_torch.py")
    rows = tool.main(["--batches", "1", "2", "--iters", "2", "--queue", "2",
                      "--device", "cpu", "--crop", "64", "128", "--src",
                      "48", "96"])
    assert [r["batch"] for r in rows] == [1, 2]
    assert all(r["blocking_ms"] > 0 and r["img_per_s"] > 0 for r in rows)


def test_loader_bench_prints_its_json_line(capsys):
    tool = _load("analysis/bench_loader_torch.py")
    tool.main(["--synthetic", "3", "--batch-size", "2", "--iters", "2",
               "--warmup", "1", "--workers", "2", "--cache",
               "--config", "tiny_synthetic"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "train_loader_throughput"
    assert last["unit"] == "img/s" and last["value"] > 0
    assert last["cache"] is True and last["batch_size"] == 2
    assert set(last) == {"metric", "value", "unit", "batch_size", "workers",
                         "cache", "ms_per_batch"}
