"""The data half of the training slice, JAX vs the PyTorch port, on the CPU.

Both packages read the same synthetic KITTI trees (written by the port's
``make_synthetic_kitti``, some frames cropped to a second size).  Held
exactly: ``scale_labels`` / ``mirror_labels``, ``determine_ignores``,
``balance_samples``, ``pad_gt_batch``, ``learn_anchor_priors``, the anchors
of ``prepare_anchors`` and the first 5 ``TrainLoader`` batches for one seed.
The bbox stds of ``prepare_anchors`` at rtol 1e-6 and the means at 1e-6 of
(|mean| + std): both sum f32 target rows in f64, the port's rows from its
own ``compute_targets``, whose ``log`` columns may lie one f32 rounding from
XLA's; a mean that cancels to 1e-3 of its column's spread carries those
roundings at 1e-3 of its own size, so it is held to its column's scale.
"""

import dataclasses
import os

import numpy as np
import pytest

from groomed_nms_tpu import anchors as jax_anchors
from groomed_nms_tpu import config as jax_config
from groomed_nms_tpu.data import augment as jax_augment
from groomed_nms_tpu.data import imdb as jax_imdb
from groomed_nms_tpu.data import pipeline as jax_pipeline

from groomed_nms_torch import anchors, config
from groomed_nms_torch.data import augment, imdb, pipeline
from groomed_nms_torch.data.synthetic import crop_to_sizes, \
    make_synthetic_kitti

STATS_RTOL = 1e-6
SIZES = [(96, 320), (72, 240)]
CLASSES = ("Car", "Pedestrian", "Cyclist")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 12-frame training split, frames alternately 96x320 and 72x240."""
    root = str(tmp_path_factory.mktemp("kitti") / "kitti_split1")
    make_synthetic_kitti(root, "training", 12, im_h=96, im_w=320, seed=4,
                         classes=CLASSES)
    crop_to_sizes(root, "training", SIZES)
    return root


@pytest.fixture(scope="module")
def big_tree(tmp_path_factory):
    """8 frames at 375x1242, where objects are clipped at the borders."""
    root = str(tmp_path_factory.mktemp("kitti_big") / "kitti_split1")
    make_synthetic_kitti(root, "training", 8, seed=9, classes=CLASSES)
    return root


def _imdbs(root):
    return (imdb.build_imdb(root, "training"),
            jax_imdb.build_imdb(root, "training"))


def _cfgs(name="tiny_synthetic", **kw):
    return (dataclasses.replace(config.load_config(name), **kw),
            jax_config.load_config(name).replace(**kw))


def _assert_gts_equal(got, want):
    if not want:
        assert not got
        return
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_scale_and_mirror_labels_match_jax(big_tree):
    ours, theirs = _imdbs(big_tree)
    n = 0
    for r, j in zip(ours, theirs):
        _assert_gts_equal(r.gts, j.gts)
        for scale in (512 / 375, 0.5):
            _assert_gts_equal(augment.scale_labels(r.gts, scale),
                              jax_augment.scale_labels(j.gts, scale))
        mirrored = augment.mirror_labels(r.gts, r.p2_inv, r.im_w)
        _assert_gts_equal(mirrored,
                          jax_augment.mirror_labels(j.gts, j.p2_inv, j.im_w))
        n += len(r.gts.get("cls", []))
    assert n > 8
    assert augment.scale_labels({}, 2.0) == {}
    assert augment.mirror_labels({}, np.eye(4), 10) == {}


@pytest.mark.parametrize("kw", [
    dict(), dict(use_trunc=True), dict(scale_factor=512 / 375, min_gt_h=30),
    dict(min_gt_vis=0.65, use_trunc=True, max_gt_h=120)])
def test_determine_ignores_matches_jax(big_tree, kw):
    ours, theirs = _imdbs(big_tree)
    lbls, ilbls = ["Car", "Pedestrian"], ["Van", "ignore"]
    seen = np.zeros(2, int)
    for r, j in zip(ours, theirs):
        got = imdb.determine_ignores(r.gts, lbls, ilbls, **kw)
        want = jax_imdb.determine_ignores(j.gts, lbls, ilbls, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        seen += [got[0].sum(), got[1].sum()]
        np.testing.assert_array_equal(imdb.class_indices(r.gts, lbls),
                                      jax_imdb.class_indices(j.gts, lbls))
    assert seen.all(), "no ignored or removed GT: the rules are not tested"


@pytest.mark.parametrize("ratio", [-1.0, 1.0, 0.5, 2.0])
@pytest.mark.parametrize("empty", [False, True])
def test_balance_samples_matches_jax(tree, ratio, empty):
    """``empty``: two frames without a valid GT, so both groups exist;
    otherwise every frame has one (the empty-group rule)."""
    ours, theirs = _imdbs(tree)
    if empty:
        for recs in (ours, theirs):
            recs[1].gts = {}
            recs[4].gts = {k: v[:0] for k, v in recs[4].gts.items()}
    args = (["Car", "Pedestrian", "Cyclist"], ["Van", "ignore"], 0.0, 5.0,
            ratio)
    got = imdb.balance_samples(ours, *args, max_gt_h=72, test_scale=96)
    want = jax_imdb.balance_samples(theirs, *args, max_gt_h=72,
                                    test_scale=96)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == pytest.approx(1.0)
    assert (got[[1, 4]] == 0).all() if empty and ratio in (1.0, 2.0) else True


@pytest.mark.parametrize("n3d_cols", [None, 17])
def test_pad_gt_batch_matches_jax(big_tree, n3d_cols):
    """Scaled records, one empty, one with a 17-column bbox_3d (velocity)
    beside 16-column ones: the narrower rows pad with -inf; max_gts 3
    truncates."""
    ours, _ = _imdbs(big_tree)
    gts = [augment.scale_labels(r.gts, 512 / 375) for r in ours[:4]]
    gts[1] = {}
    v = dict(gts[2])
    v["bbox_3d"] = np.concatenate([v["bbox_3d"], np.full(
        (len(v["cls"]), 1), 0.5)], axis=1)
    gts[2] = v
    p2s = [r.p2 for r in ours[:4]]
    args = (gts, p2s, [1.3] * 4, ["Car", "Pedestrian", "Cyclist"],
            ["Van", "ignore"], 0.65, 10.0)
    got = imdb.pad_gt_batch(*args, max_gts=3, max_igns=2, n3d_cols=n3d_cols)
    want = jax_imdb.pad_gt_batch(*args, max_gts=3, max_igns=2,
                                 n3d_cols=n3d_cols)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.gts_3d.shape[2] == 17
    assert np.isneginf(got.gts_3d[0, :, 16][got.gt_valid[0]]).all()


@pytest.mark.parametrize("decomp_alpha,has_vel", [(True, False),
                                                  (False, False),
                                                  (True, True)])
def test_learn_anchor_priors_matches_jax(decomp_alpha, has_vel):
    rs = np.random.default_rng(3)
    cfg, _ = _cfgs("groomed_nms")
    templates = anchors.generate_anchor_templates(cfg.anchor_scales,
                                                  cfg.anchor_ratios, 16)
    g = 300
    wh = np.exp(rs.uniform(np.log(12), np.log(300), (g, 2)))
    c = 7.5
    gts2d = np.stack([c - wh[:, 0] / 2, c - wh[:, 1] / 2, c + wh[:, 0] / 2,
                      c + wh[:, 1] / 2], 1).astype(np.float32)
    gts3d = rs.normal(size=(g, 17 if has_vel else 16))
    got = anchors.learn_anchor_priors(templates, gts2d, gts3d,
                                      decomp_alpha=decomp_alpha,
                                      has_vel=has_vel)
    want = jax_anchors.learn_anchor_priors(templates, gts2d, gts3d,
                                           decomp_alpha=decomp_alpha,
                                           has_vel=has_vel)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0 < got.shape[0] < templates.shape[0]      # unused ones dropped
    empty = anchors.learn_anchor_priors(templates, gts2d[:0], gts3d[:0])
    np.testing.assert_array_equal(empty, jax_anchors.learn_anchor_priors(
        templates, gts2d[:0], gts3d[:0]))


def test_compute_bbox_stats_matches_jax():
    rs = np.random.default_rng(2)
    rows = [rs.normal(size=(n, 6)).astype(np.float32) for n in (3, 0, 7, 1)]
    rows[2][1, 5] = -np.inf
    rows.append(np.full((1, 6), np.inf, np.float32))
    for got, want in zip(anchors.compute_bbox_stats(iter(rows), 6),
                         jax_anchors.compute_bbox_stats(iter(rows), 6)):
        np.testing.assert_array_equal(got, want)


def _prepare_both(root, tmp_path, **kw):
    (ours, theirs), (tcfg, jcfg) = _imdbs(root), _cfgs(**kw)
    got = pipeline.prepare_anchors(tcfg, ours, cache_dir=str(tmp_path / "t"),
                                   device="cpu")
    want = jax_pipeline.prepare_anchors(jcfg, theirs,
                                        cache_dir=str(tmp_path / "j"))
    np.testing.assert_array_equal(got[0], want[0])
    assert_stats_close(got[1:], want[1:])
    return got, ours, tcfg


def assert_stats_close(got, want, rtol=STATS_RTOL):
    """(means, stds) against a reference: stds at ``rtol``, means at
    ``rtol`` of |mean| + std."""
    (gm, gs), (wm, ws) = got, want
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=0)
    err = np.abs(gm - wm)
    assert (err <= rtol * (np.abs(wm) + ws)).all(), (err, wm, ws)


def test_prepare_anchors_matches_jax(tree, tmp_path):
    (a, m, s), _, _ = _prepare_both(tree, tmp_path)
    assert a.shape[1] == 11 and m.shape == (13,) and (s > 0).all()
    assert np.abs(m).max() > 0


def test_prepare_anchors_truncation_two_pass_matches_jax(big_tree, tmp_path):
    """min_gt_vis 0.65: GTs truncated beyond 0.35 are left out of the mean
    pass only, so the two passes see different rows (and the std divides
    by the mean pass's counts)."""
    (_, m, s), ours, cfg = _prepare_both(big_tree, tmp_path, min_gt_vis=0.65,
                                         test_scale=512,
                                         crop_size=(512, 1760))
    trunc = np.concatenate([r.gts["trunc"][np.isin(r.gts["cls"], CLASSES)]
                            for r in ours])
    assert (trunc > 0.35).any() and (trunc <= 0.35).any()
    # the one-pass statistic over all rows differs: the rule is exercised
    (_, m1, _), _, _ = _prepare_both(big_tree, tmp_path / "one",
                                     min_gt_vis=0.0, test_scale=512,
                                     crop_size=(512, 1760))
    assert not np.allclose(m, m1)


def test_prepare_anchors_cache_rules(tree, tmp_path):
    """A cache of this layout is returned as it is; one of other widths is
    learned again from an imdb and refused with an empty one; an empty imdb
    and no cache is refused."""
    ours, _ = _imdbs(tree)
    cfg = config.load_config("tiny_synthetic")
    d = str(tmp_path / "run")
    with pytest.raises(ValueError, match="imdb is empty.*train_torch"):
        pipeline.prepare_anchors(cfg, [], cache_dir=d, device="cpu")
    with pytest.raises(ValueError, match="train_torch"):
        pipeline.load_anchors(cfg, d)
    a, m, s = pipeline.prepare_anchors(cfg, ours, cache_dir=d, device="cpu")
    z = np.load(os.path.join(d, "anchors.npz"))
    np.testing.assert_array_equal(z["anchors"], a)
    # a cache hit needs no imdb and no device work
    a2, m2, s2 = pipeline.prepare_anchors(cfg, [], cache_dir=d, device="meta")
    np.testing.assert_array_equal(a2, a)
    np.testing.assert_array_equal(pipeline.load_anchors(cfg, d)[1], m)
    np.savez(os.path.join(d, "anchors.npz"), anchors=a[:, :9],
             bbox_means=m[:11], bbox_stds=s[:11])
    with pytest.raises(ValueError, match="widths 9/11, expected 11/13"):
        pipeline.prepare_anchors(cfg, [], cache_dir=d, device="cpu")
    a3, m3, _ = pipeline.prepare_anchors(cfg, ours, cache_dir=d, device="cpu")
    np.testing.assert_array_equal(a3, a)
    np.testing.assert_array_equal(m3, m)
    assert np.load(os.path.join(d, "anchors.npz"))["anchors"].shape[1] == 11


def _batches(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


@pytest.mark.parametrize("seed", [0, 7])
def test_train_loader_batches_match_jax(tree, seed):
    """The first 5 batches of a mixed-size tree: the same records, frames,
    mirrors and padded GTs, bit for bit."""
    (ours, theirs), (tcfg, jcfg) = _imdbs(tree), _cfgs(mirror_prob=0.5)
    got = _batches(pipeline.TrainLoader(ours, tcfg, seed=seed, prefetch=2),
                   5)
    want = _batches(jax_pipeline.TrainLoader(theirs, jcfg, seed=seed,
                                             prefetch=2), 5)
    shapes = set()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images_u8"], w["images_u8"])
        np.testing.assert_array_equal(g["mirror"], w["mirror"])
        for name, a, b in zip(w["gt"]._fields, g["gt"], w["gt"]):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        shapes.add(g["images_u8"].shape)
    mirrors = np.concatenate([g["mirror"] for g in got])
    assert mirrors.any() and not mirrors.all()
    assert len(shapes) == 2, "both size groups should be drawn"


def test_train_loader_cache_errors_and_close(tree, tmp_path):
    ours, _ = _imdbs(tree)
    cfg = config.load_config("tiny_synthetic")
    plain = _batches(pipeline.TrainLoader(ours, cfg, seed=3, prefetch=1), 3)
    cache = str(tmp_path / "cache")
    for _ in range(2):                   # cold, then from the mmap cache
        cached = _batches(pipeline.TrainLoader(ours, cfg, seed=3, prefetch=1,
                                               raw_cache_dir=cache), 3)
        for p, c in zip(plain, cached):
            np.testing.assert_array_equal(p["images_u8"], c["images_u8"])
    assert os.listdir(cache)

    bad = [dataclasses.replace(r, image_path=str(tmp_path / "no.png"))
           for r in ours]
    loader = pipeline.TrainLoader(bad, cfg, seed=0)
    with pytest.raises(RuntimeError, match="TrainLoader worker failed"):
        next(loader)
    loader.close()

    loader = pipeline.TrainLoader(ours, cfg, seed=0, prefetch=1)
    next(loader)
    waited, n = loader.pop_wait_stats()
    assert n == 1 and waited >= 0 and loader.pop_wait_stats() == (0.0, 0)
    loader.close()
    assert not loader._thread.is_alive()
