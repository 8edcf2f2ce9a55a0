"""Symlink KITTI images/calib/labels into training/validation splits (the
port's twin of ``scripts/setup_split.py``: the same tree, without JAX).

Capability match for the reference's data/kitti_split{1,2}/setup_split.py.
Two id-list sources, auto-detected per split dir:

- ``train.txt`` / ``val.txt`` lists (split1 style): files keep their
  KITTI ids.
- ``kitti_ids_new.mat`` (split2 style, reference
  data/kitti_split2/setup_split.py:14,46): the MAT5 file's
  ``ids_train``/``ids_val`` rows are linked under CONSECUTIVE new ids
  (000000..N-1), exactly as the reference renumbers them.  Parsed by the
  port's MAT5 reader (groomed_nms_torch/data/matfile.py) -- no scipy
  needed.  The reference's val loop under-increments its counter when a
  source file already exists (setup_split.py:95, ``imind`` bumped inside
  the innermost if); we renumber unconditionally, which is what its first
  clean run produces.

Usage:
  python scripts/setup_split_torch.py --kitti <path/to/kitti/object> \
      --split-dir data/kitti_split2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def _link(src, dst):
    """Symlink src -> dst, replacing a stale/dangling link; returns whether
    the source existed (lexists, not exists: a dangling dst from a moved
    KITTI tree must be repaired, not crash os.symlink)."""
    if not os.path.exists(src):
        return False
    if os.path.lexists(dst):
        if os.path.islink(dst) and \
                os.readlink(dst) == os.path.abspath(src):
            return True
        os.remove(dst)
    os.symlink(os.path.abspath(src), dst)
    return True


def link_split(kitti_train, split_dir, ids, split_name):
    """``ids``: source id strings, or (source, destination) id pairs."""
    out = os.path.join(split_dir, split_name)
    for sub in ("image_2", "calib", "label_2", "prev_2"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    missing = 0
    pairs = [p if isinstance(p, tuple) else (p, p) for p in ids]
    for src_id, dst_id in pairs:
        for sub, ext in (("image_2", ".png"), ("calib", ".txt"),
                         ("label_2", ".txt")):
            src = os.path.join(kitti_train, sub, src_id + ext)
            if not _link(src, os.path.join(out, sub, dst_id + ext)):
                missing += 1
        # optional multi-frame context (prev_2/<id>_{01..03}.png) -- not
        # counted as missing: raw KITTI object has no prev_2
        for k in range(1, 4):
            src = os.path.join(kitti_train, "prev_2",
                               f"{src_id}_{k:02d}.png")
            _link(src, os.path.join(out, "prev_2", f"{dst_id}_{k:02d}.png"))
    print(f"{split_name}: {len(pairs)} ids linked under {out}"
          + (f" ({missing} MISSING source files)" if missing else ""))
    if missing == 3 * len(pairs) and pairs:
        raise SystemExit(
            f"no source files found under {kitti_train} -- wrong --kitti?")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti", required=True,
                    help="KITTI object dir containing training/")
    ap.add_argument("--split-dir", default="data/kitti_split1")
    args = ap.parse_args(argv)

    kitti_train = os.path.join(args.kitti, "training")
    mat_path = os.path.join(args.split_dir, "kitti_ids_new.mat")
    if os.path.exists(mat_path):
        # split2 style: renumber the .mat id rows consecutively
        from groomed_nms_torch.data.matfile import load_mat_numeric
        mat = load_mat_numeric(mat_path)
        for name, key in (("training", "ids_train"),
                          ("validation", "ids_val")):
            if key not in mat:
                raise SystemExit(f"{mat_path} has no '{key}' variable")
            src_ids = [int(v) for v in mat[key].ravel(order="F")]
            pairs = [(f"{sid:06d}", f"{i:06d}")
                     for i, sid in enumerate(src_ids)]
            link_split(kitti_train, args.split_dir, pairs, name)
        return
    for name, list_file in (("training", "train.txt"),
                            ("validation", "val.txt")):
        path = os.path.join(args.split_dir, list_file)
        if not os.path.exists(path):
            print(f"missing {path}; skipping {name}")
            continue
        with open(path) as f:
            ids = [line.strip() for line in f if line.strip()]
        link_split(kitti_train, args.split_dir, ids, name)


if __name__ == "__main__":
    main()
