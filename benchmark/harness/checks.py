"""The comparisons that decide ``correct``: the program's outputs judged by
the plain reference.

Serving (``serve_check``).  Every batch the window served is compared
with the reference run on the same frames.  Each served row is matched to
the reference's decoded row of the same anchor (the nearest one over the
continuous columns, among the anchors that can reach the pre-NMS top-k),
and two numbers are taken over all rows:

* ``row_err``: the largest gap between a served number and the
  reference's for that anchor, over 1 + the largest magnitude of its group
  (the 2D box's corners, the projected centre, the depth, the 3D sizes, the
  3D centre, the score): a corner or a coordinate near 0 is the difference
  of two large numbers and rounds as they do.  The yaw and the observation
  angle are compared as angles, under the heading and axis branch the
  served row took.
* ``pick_gap``: how far each of the program's choices falls below the
  reference's best choice, in probability: the row's score below the best
  score still open after the rows served before it (greedy NMS: open means
  not already served, clearly inside the pre-NMS top-k and clearly not
  suppressed by an earlier served row); its class below the reference's
  best class; a branch taken against the reference's probability.  A row
  suppressed by an earlier one, served twice, or missing while a candidate
  is open counts 1.  Near-ties go either way: a sound program's gaps are
  rounding.

Training (``train.train_check``): the first step's loss and its steady
terms against the reference's; the first step's change of the parameters,
each leaf's gap between the program's norm and the reference's over the
larger of the reference's norm of that leaf and of the median leaf; and
SGD's rule applied to the program's own gradients over the checked steps.
"""

from __future__ import annotations

import math

import torch

# tolerance bands of the discrete decisions: a candidate within BAND_SCORE
# of the pre-NMS cut, or within BAND_IOU of the NMS threshold with an
# earlier row, may go either way
BAND_SCORE = 1e-5
BAND_IOU = 1e-3
# the columns of a served row compared as numbers (the rest are the class,
# the observation angle and the yaw), and the group of each among them:
# 2D corners, score, projected centre, depth, 3D sizes, 3D centre
CONT_COLS = [0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 13, 14, 15]
GROUPS = [0, 0, 0, 0, 1, 2, 2, 3, 4, 5, 6, 7, 7, 7]


def _scale(cont):
    """1 + the largest magnitude of each column's group, [..., 14]."""
    g = torch.tensor(GROUPS, device=cont.device)
    mag = cont.abs()
    top = torch.zeros(mag.shape[:-1] + (int(g.max()) + 1,),
                      dtype=mag.dtype, device=mag.device)
    top = top.scatter_reduce(-1, g.expand_as(mag), mag, "amax")
    return 1.0 + top.gather(-1, g.expand_as(mag))


def _wrap(t):
    return torch.remainder(t + math.pi, 2 * math.pi) - math.pi


def _iou_plus1(a, b):
    """Pairwise IoU with the +1-pixel widths of greedy NMS."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + 1.0).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[:, 2] - x[:, 0] + 1.0) * (x[:, 3] - x[:, 1] + 1.0)  # noqa
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp_min(1e-12)


def judge_image(rows, valid, scores, head, accept, ref, inp, exp):
    """(row_err, pick_gap, the column of row_err) of one image's served
    ``rows`` [K, 17] and ``valid`` [K] (numpy) against the reference's
    ``scores`` [R], ``head`` [R, per] and ``accept`` [R] (or None); ``inp``
    holds the anchors and the camera as tensors on the scores' device."""
    dev = scores.device
    top_pre, thr = exp["nms_topN_pre"], exp["nms_thres"]
    order = torch.argsort(scores, descending=True, stable=True)
    s_k = scores[order[min(top_pre, scores.numel()) - 1]]
    n_cand = min(max(int((scores >= s_k - BAND_SCORE).sum()), top_pre),
                 scores.numel())
    cand = order[:n_cand]
    dec = ref.decode_rows(head[cand].float(),
                          None if accept is None else accept[cand],
                          inp["rois"][cand], inp["rois_3d"][cand],
                          inp["p2_inv"], inp["scale"], inp["means"],
                          inp["stds"], len(exp["lbls"]) + 1)
    cont = dec["cont"].double()
    served = torch.as_tensor(rows, dtype=torch.float64, device=dev)
    ok = torch.as_tensor(valid, device=dev)
    sc = served[:, CONT_COLS]
    scale = _scale(cont)
    dist = ((sc[:, None, :] - cont[None]).abs() / scale[None]).amax(-1)
    err, m = dist.min(1)
    col = ((sc - cont[m]).abs() / scale[m]).argmax(1)
    ang = torch.maximum(
        _wrap(served[:, 16:17] - dec["ry"][m].double()).abs(),
        _wrap(served[:, 12:13] - dec["alpha"][m].double()).abs())
    ang_err, combo = ang.min(1)
    row_err = torch.maximum(err, ang_err)
    col = torch.where(ang_err > err, -1, col)

    ref_branch = dec["branch"][m]
    axis, headp = dec["axis"][m].double(), dec["head"][m].double()
    gap = torch.where((combo // 2) != (ref_branch // 2), (axis - 0.5).abs(),
                      0.0) + torch.where((combo % 2) != (ref_branch % 2),
                                         (headp - 0.5).abs(), 0.0)
    fg = dec["fg_prob"][m].double()
    cls = served[:, 5].round().long()
    cls_ok = (cls >= 1) & (cls <= fg.shape[1])
    picked = fg.gather(1, (cls.clamp(1, fg.shape[1]) - 1)[:, None])[:, 0]
    cls_gap = fg.amax(1) - picked
    gap = torch.maximum(gap, torch.where(cls_ok, cls_gap, 1.0))

    s_c = scores[cand].double()
    eligible = s_c > s_k.double() + BAND_SCORE
    k = served.shape[0]
    iou = _iou_plus1(cont[m, :4], cont[:, :4])                 # [K, M]
    maybe_sup = ((iou > thr - BAND_IOU) & ok[:, None]).int()
    before = torch.cumsum(maybe_sup, 0) - maybe_sup              # rows j < k
    taken = torch.zeros((k, n_cand), dtype=torch.int32, device=dev)
    taken[torch.arange(k, device=dev), m] = ok.int()
    taken_before = torch.cumsum(taken, 0) - taken
    open_ = eligible[None] & (before == 0) & (taken_before == 0)
    best = torch.where(open_, s_c[None], -math.inf).amax(1)
    pick = torch.clamp(best - s_c[m], min=0.0)
    over = (iou[:, m] > thr + BAND_IOU) & ok[None, :]
    earlier = torch.ones((k, k), dtype=torch.bool, device=dev).tril(-1)
    bad = (over & earlier).any(1) | (taken_before[torch.arange(k), m] > 0)
    pick = torch.where(bad, 1.0, pick)
    gap = torch.maximum(gap, pick)
    # a row left out while a candidate is open
    missing = torch.where(torch.isfinite(best), best.clamp_min(0.0), 0.0)
    gap = torch.where(ok, gap, missing)
    row_err = torch.where(ok, row_err, 0.0)
    if not bool(ok.all()) and bool((~ok[:-1] & ok[1:]).any()):
        gap = torch.where(ok, gap, 1.0)          # a valid row after a gap
    worst = int(row_err.argmax())
    c = int(col[worst])
    return float(row_err.max()), float(gap.max()), \
        "angle" if c < 0 else CONT_COLS[c]


@torch.no_grad()
def serve_check(server, served):
    """(row_err, pick_gap, number of batches compared, the column of the
    largest row error) over every batch in
    ``served`` [(batch index, (rows, valid))], the reference run once on
    each distinct frame set."""
    torch_ = server.torch
    ref, cfg, dev = server.ref, server.cfg, server.device
    exp = cfg["experiment"]
    h = server.host
    t = lambda x: torch_.as_tensor(x, dtype=torch_.float32, device=dev)  # noqa
    inp = {"rois": t(h["rois"]), "rois_3d": t(h["rois_3d"]),
           "p2_inv": t(h["p2_inv"]), "scale": float(h["scale"][0]),
           "means": t(h["means"]), "stds": t(h["stds"])}
    weights = ref.make_weights(ref.param_spec(cfg), server.seed, dev)
    by_set = {}
    for j, (rows, valid) in served:
        key = (rows.tobytes(), valid.tobytes())
        by_set.setdefault(j % server.n_sets, {})[key] = (rows, valid)
    row_err = pick_gap = 0.0
    worst_col = None
    crop_h, crop_w = exp["crop_size"]
    for s, outs in sorted(by_set.items()):
        frames = server.pool[s].to(dev)
        x = ref.resize_normalize(frames, None, exp["image_means"],
                                 exp["image_stds"], crop_h, crop_w)
        head, accept = ref.rpn_forward(weights, x, cfg["model"])
        scores = ref.anchor_scores(head, accept, len(exp["lbls"]) + 1)
        for rows, valid in outs.values():
            for i in range(rows.shape[0]):
                e, g, c = judge_image(rows[i], valid[i], scores[i], head[i],
                                      None if accept is None else accept[i],
                                      ref, inp, exp)
                if e > row_err:
                    row_err, worst_col = e, c
                pick_gap = max(pick_gap, g)
        del x, head, accept, scores
    return row_err, pick_gap, len(served), worst_col


def leaf_gaps(prog, ref, skip=None):
    """Each leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖), for
    ``prog`` and ``ref`` mapping leaf names to tensors, leaves in ``skip``
    left out: {leaf: gap}."""
    names = [n for n in ref if not skip or n not in skip]
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med) for n in names}


def leaf_diff_gaps(got, want, skip=None, slack=None):
    """Each leaf's ‖got - want‖ / max(‖want‖, median leaf ‖want‖), leaves
    in ``skip`` left out, each element's difference less its ``slack``
    (a dict of tensors like ``want``) where given: {leaf: gap}."""
    names = [n for n in want if not skip or n not in skip]
    wn = {n: float(want[n].double().norm()) for n in names}
    med = sorted(wn.values())[len(wn) // 2]
    out = {}
    for n in names:
        d = (got[n].double() - want[n].double()).abs()
        if slack is not None:
            d = (d - slack[n]).clamp_min(0.0)
        out[n] = float(d.norm()) / max(wn[n], med)
    return out


def ulp(x):
    """Each element's unit in the last place, in f64: the gap from |x| to
    the next magnitude of x's type."""
    a = x.abs()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


def small_leaves(grads, ratio=1e-3):
    """Leaves whose reference gradient norm is under ``ratio`` of the median
    leaf's: they move by weight decay and round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n for n, v in norms.items() if v < ratio * med}
