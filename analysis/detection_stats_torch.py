"""GT-matching statistics over a results directory, with the port's exact
3D IoU (the counterpart of ``analysis/detection_stats.py``, same flags and
output).

Per detection the best-matching ground truth by exact 3D IoU
(``groomed_nms_torch/ops/iou3d_exact.py``), depth and rotation errors, and
the score-IoU3D correlation (what GrooMeD-NMS's acceptance branch is meant
to improve).  No device is used.

Usage:
  python analysis/detection_stats_torch.py --results <dir/data> \
      --gt <label_2> [--score 0.3]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np


def _rows(path, min_cols=15):
    """KITTI txt rows.  Detection files carry 16 tokens (the score last,
    v[14]): pass min_cols=16 for those, so that a GT-format file or a cut
    line is skipped; ground-truth label files have 15 (the default)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= min_cols:
                out.append((p[0], [float(v) for v in p[1:]]))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--score", type=float, default=0.3)
    ap.add_argument("--cls", default="Car")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from groomed_nms_torch.ops.iou3d_exact import iou3d_exact

    scores, ious, z_errs, rot_errs, matched = [], [], [], [], 0
    n_gt = 0
    for name in sorted(os.listdir(args.results)):
        dets = _rows(os.path.join(args.results, name), min_cols=16)
        gts = _rows(os.path.join(args.gt, name))
        # GT rows: trunc occ alpha x1 y1 x2 y2 h w l x y z ry
        gt_boxes = [(v[10], v[11] - v[7] / 2, v[12], v[8], v[7], v[9], v[13])
                    for c, v in gts if c.lower() == args.cls.lower()]
        n_gt += len(gt_boxes)
        for c, v in dets:
            if c.lower() != args.cls.lower() or v[14] <= args.score:
                continue
            # det rows (KITTI result): ... h w l x y z ry score
            det_box = (v[10], v[11] - v[7] / 2, v[12], v[8], v[7], v[9],
                       v[13])
            best_iou, best_gt = 0.0, None
            for g in gt_boxes:
                i3 = iou3d_exact(det_box, g)
                if i3 > best_iou:
                    best_iou, best_gt = i3, g
            scores.append(v[14])
            ious.append(best_iou)
            if best_gt is not None and best_iou > 0.05:
                matched += 1
                z_errs.append(abs(det_box[2] - best_gt[2]))
                d_rot = det_box[6] - best_gt[6]
                rot_errs.append(abs(np.arctan2(np.sin(d_rot),
                                               np.cos(d_rot))))

    scores = np.asarray(scores)
    ious = np.asarray(ious)
    print(f"detections (score > {args.score}): {len(scores)}; "
          f"gts: {n_gt}; matched (IoU3D > 0.05): {matched}")
    if len(scores) > 1:
        corr = np.corrcoef(scores, ious)[0, 1]
        print(f"score vs IoU3D correlation: {corr:.4f}")
        print(f"mean IoU3D: {ious.mean():.4f}")
    if z_errs:
        print(f"z error  (m):  mean {np.mean(z_errs):.3f}  "
              f"median {np.median(z_errs):.3f}")
        print(f"ry error (rad): mean {np.mean(rot_errs):.3f}  "
              f"median {np.median(rot_errs):.3f}")


if __name__ == "__main__":
    main()
