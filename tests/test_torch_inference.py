"""The whole still-image slice, JAX vs the PyTorch port, on one seed.

The same flax variables and the same uint8 batch go through the JAX serving
function (``eval/tester.py::_make_infer``: preprocess + ``model.apply`` +
``im_detect_3d``) and through the port's ``make_infer``.  The source size
48x96 resizes to exactly the 64x128 crop, so no zero-padded columns (whose
exact score ties ``test_torch_kernels.py`` covers) enter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groomed_nms_tpu import inference as jax_inf
from groomed_nms_tpu.anchors import locate_anchors as jax_locate
from groomed_nms_tpu.config import load_config as jax_load_config
from groomed_nms_tpu.eval.tester import _make_infer as jax_make_infer

from groomed_nms_torch import inference
from groomed_nms_torch.anchors import locate_anchors
from groomed_nms_torch.config import load_config
from groomed_nms_torch.eval.tester import make_infer
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.rpn_3d import RPN3D, RPNConfig
from groomed_nms_torch.utils.weights import init_weights
from torch_port_common import TINY, tiny_models

CLASSES = ["Car", "Pedestrian", "Cyclist"]
SRC_HW, CROP_HW = (48, 96), (64, 128)


def _slice_inputs(rs, b, num_anchors=6):
    templates = np.abs(rs.normal(size=(num_anchors, 4))).astype(np.float32)
    templates[:, 2:] += templates[:, :2] + 16.0 * rs.uniform(
        1, 3, (num_anchors, 2)).astype(np.float32)
    priors = np.concatenate(
        [templates,
         np.abs(rs.normal(size=(num_anchors, 7))).astype(np.float32) + 1.0],
        axis=1)
    priors[:, 4] = 30.0
    rois = locate_anchors(priors, (CROP_HW[0] // 16, CROP_HW[1] // 16), 16)
    np.testing.assert_array_equal(
        rois, np.asarray(jax_locate(priors, (4, 8), 16)))
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    p2[:, 0, 0] = p2[:, 1, 1] = 700.0
    p2[:, 0, 2], p2[:, 1, 2] = 60.0, 25.0
    p2[:, 0, 3] = 45.0
    return dict(
        images_u8=rs.integers(0, 256, (b, *SRC_HW, 3)).astype(np.uint8),
        means_img=np.asarray([0.485, 0.456, 0.406], np.float32),
        stds_img=np.asarray([0.229, 0.224, 0.225], np.float32),
        rois=rois, rois_3d=rois_3d, p2=p2,
        p2_inv=np.linalg.inv(p2).astype(np.float32),
        scale=np.full((b,), CROP_HW[0] / SRC_HW[0], np.float32),
        bbox_means=rs.normal(0, 0.1, 13).astype(np.float32),
        bbox_stds=rs.uniform(0.5, 1.5, 13).astype(np.float32))


def _run_slice(variant, dcfg_jax, dcfg_torch, seed=0, b=2):
    jmodel, variables, tmodel = tiny_models(seed=seed, **variant)
    inputs = _slice_inputs(np.random.default_rng(seed), b)
    jinfer = jax_make_infer(jmodel, dcfg_jax, *CROP_HW)
    jdets, jvalid = jinfer(variables, jnp.asarray(inputs["images_u8"]), None,
                           *(jnp.asarray(v) for k, v in inputs.items()
                             if k != "images_u8"))
    tinfer = make_infer(tmodel, dcfg_torch, *CROP_HW)
    tdets, tvalid = tinfer(*(torch.from_numpy(v) for v in inputs.values()))
    return (np.asarray(jdets), np.asarray(jvalid), tdets.numpy(),
            tvalid.numpy())


@pytest.mark.parametrize("variant", [
    dict(predict_acceptance_prob=True),                   # groomed_nms
    dict(predict_uncertainty=True),                       # the _un model
])
def test_slice_matches_jax(variant):
    dcfg_j = jax_load_config("groomed_nms").detect_config()
    dcfg_t = load_config("groomed_nms").detect_config()
    jdets, jvalid, tdets, tvalid = _run_slice(variant, dcfg_j, dcfg_t)
    assert tdets.shape == jdets.shape == (2, 40, inference.NUM_DET_COLS)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert jvalid.sum() >= 20
    np.testing.assert_allclose(tdets[tvalid], jdets[jvalid], rtol=1e-4,
                               atol=1e-3)


def _parse(path):
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            rows.append((parts[0], parts[1:3], np.asarray(parts[3:], float)))
    return rows


def test_kitti_writers_agree(tmp_path):
    dcfg_j = jax_load_config("groomed_nms").detect_config()
    dcfg_t = load_config("groomed_nms").detect_config()
    jdets, jvalid, tdets, tvalid = _run_slice(
        dict(predict_acceptance_prob=True), dcfg_j, dcfg_t, seed=3, b=1)
    jpath, tpath = tmp_path / "jax.txt", tmp_path / "torch.txt"
    jax_inf.write_kitti_detections(jpath, jdets[0], jvalid[0], CLASSES,
                                   score_thres=0.0)
    inference.write_kitti_detections(tpath, tdets[0], tvalid[0], CLASSES,
                                     score_thres=0.0)
    jrows, trows = _parse(jpath), _parse(tpath)
    assert len(trows) == len(jrows) == int(jvalid[0].sum()) > 0
    for (jc, jmid, jnum), (tc, tmid, tnum) in zip(jrows, trows):
        assert tc == jc and tmid == jmid == ["-1", "-1"]
        np.testing.assert_allclose(tnum, jnum, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("decomp_alpha", [True, False])
def test_decode_and_nms_match_jax(decomp_alpha):
    """decode_detections on every anchor, then nms_and_topk with its own
    top-k (the path that is not presorted)."""
    rs = np.random.default_rng(4)
    b, r, c = 2, 400, 4
    logits = rs.normal(0, 2, (b, r, c)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    b3 = rs.normal(0, 0.5, (b, r, 10)).astype(np.float32)
    b3[..., 8:10] = rs.uniform(0, 1, (b, r, 2))
    outs = {"prob": prob.astype(np.float32),
            "bbox_2d": rs.normal(0, 0.3, (b, r, 4)).astype(np.float32),
            "bbox_3d": b3,
            "accept_prob": rs.uniform(0.2, 1, (b, r)).astype(np.float32)}
    inputs = _slice_inputs(rs, b)
    rois = np.concatenate([rs.uniform(0, 100, (r, 2)), np.zeros((r, 3))], 1)
    rois[:, 2:4] = rois[:, :2] + rs.uniform(8, 60, (r, 2))
    rois = rois.astype(np.float32)
    rois_3d = (np.abs(rs.normal(size=(r, 7))) + 1).astype(np.float32)
    args = [rois, rois_3d] + [inputs[k] for k in (
        "p2", "p2_inv", "scale", "bbox_means", "bbox_stds")]
    jcfg = jax_inf.DetectConfig(decomp_alpha=decomp_alpha, nms_topN_pre=300)
    tcfg = inference.DetectConfig(decomp_alpha=decomp_alpha, nms_topN_pre=300)
    jd, js = jax_inf.decode_detections(
        {k: jnp.asarray(v) for k, v in outs.items()},
        *(jnp.asarray(a) for a in args), jcfg)
    td, ts = inference.decode_detections(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        *(torch.from_numpy(a) for a in args), tcfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jout, jvalid = jax_inf.nms_and_topk(jd, js, jcfg)
    tout, tvalid = inference.nms_and_topk(td, ts, tcfg)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-3)


def test_differentiable_nms_at_test_is_refused():
    """GrooMeD-NMS at test time is ported; it refuses a pruning method it
    does not know."""
    cfg = inference.DetectConfig(use_differentiable_nms=True,
                                 diff_nms_pruning_method="no_such_method")
    with pytest.raises(ValueError, match="pruning_method"):
        inference.nms_and_topk(torch.zeros(1, 5, 17), torch.ones(1, 5), cfg)


def _decode_case(rs, b, r, per_image):
    """decode_detections' arguments at [b, r]: the head's outputs, rois
    shared [r, *] or per image [b, r, *], and _slice_inputs' cameras and
    target statistics."""
    logits = rs.normal(0, 2, (b, r, 4)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    b3 = rs.normal(0, 0.5, (b, r, 10)).astype(np.float32)
    b3[..., 8:10] = rs.uniform(0, 1, (b, r, 2))
    outs = {"prob": prob.astype(np.float32),
            "bbox_2d": rs.normal(0, 0.3, (b, r, 4)).astype(np.float32),
            "bbox_3d": b3,
            "accept_prob": rs.uniform(0.2, 1, (b, r)).astype(np.float32)}
    lead = (b, r) if per_image else (r,)
    rois = np.concatenate([rs.uniform(0, 100, lead + (2,)),
                           np.zeros(lead + (3,))], -1)
    rois[..., 2:4] = rois[..., :2] + rs.uniform(8, 60, lead + (2,))
    rois_3d = np.abs(rs.normal(size=lead + (7,))) + 1
    inputs = _slice_inputs(rs, b)
    args = [rois.astype(np.float32), rois_3d.astype(np.float32)] + [
        inputs[k] for k in ("p2", "p2_inv", "scale", "bbox_means",
                            "bbox_stds")]
    return ({k: torch.from_numpy(v) for k, v in outs.items()},
            [torch.from_numpy(a) for a in args])


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("decomp_alpha", [True, False])
def test_decode_rows_equal_the_list_indexed_form(monkeypatch, decomp_alpha,
                                                 per_image):
    """The target statistics picked by slices give the rows, bit for bit,
    that indexing them with the Python list of their columns gives."""
    outs, args = _decode_case(np.random.default_rng(7), 2, 300, per_image)
    cfg = inference.DetectConfig(decomp_alpha=decomp_alpha)
    cols = [4, 5, 6, 7, 8, 9, 11, 12] if decomp_alpha else \
        [4, 5, 6, 7, 8, 9, 10]
    stats = args[-1]
    assert torch.equal(inference.stat_cols_3d(stats, decomp_alpha),
                       stats[cols])
    dets, scores = inference.decode_detections(outs, *args, cfg)
    monkeypatch.setattr(inference, "stat_cols_3d", lambda v, _: v[cols])
    ref_dets, ref_scores = inference.decode_detections(outs, *args, cfg)
    assert dets.shape == (2, 300, inference.NUM_DET_COLS)
    assert torch.equal(dets, ref_dets) and torch.equal(scores, ref_scores)


class _HostRoundTrips(TorchDispatchMode):
    """Records each op that, on a CUDA card, takes a round trip through
    the host: a tensor built from Python data while the call runs
    (``lift_fresh``: on the card a copy from pageable host memory, which
    waits for the stream), a read of a tensor's value (``.item()``,
    ``bool()``) and an op whose output's shape depends on the data."""

    OPS = ("lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "nonzero",
           "masked_select", "_unique2", "unique_consecutive", "unique_dim")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("decomp_alpha", [True, False])
def test_serving_entry_takes_no_host_round_trip(decomp_alpha):
    """The CPU's stand-in for the card's ``set_sync_debug_mode("error")``
    (``test_torch_cuda.py::test_serving_entry_does_not_synchronise``): the
    whole ``make_infer`` of a tiny RPN3D (preprocess, model, K1's and K2's
    ops, the decode) runs under a dispatch mode that records every op that
    would make the host wait for the card, and none is recorded.  A list
    index into the target statistics is one (``lift_fresh``)."""
    model = init_weights(
        RPN3D(RPNConfig(backbone=tiny_densenet_config(),
                        predict_acceptance_prob=True, **TINY)),
        torch.Generator().manual_seed(0)).eval()
    dcfg = inference.DetectConfig(decomp_alpha=decomp_alpha)
    infer = make_infer(model, dcfg, *CROP_HW)
    args = [torch.from_numpy(v)
            for v in _slice_inputs(np.random.default_rng(2), 2).values()]
    with _HostRoundTrips() as mode:
        dets, valid = infer(*args)
    assert dets.shape == (2, dcfg.nms_topN_post, inference.NUM_DET_COLS)
    assert mode.found == []
