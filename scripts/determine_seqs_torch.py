"""Map a split's image ids to their KITTI raw sequences with the port (the
counterpart of ``scripts/determine_seqs.py``, same flags and output).

Reads the devkit mapping files, prints which raw sequences a split's ids
draw from and, given a list of sequences with tracklet annotations, how
many of the split's images have tracking coverage.  No device is used.

Usage:
  python scripts/determine_seqs_torch.py --root data/kitti_split1 \
      --ids data/kitti_split1/val.txt [--tracklets seqs.txt]
"""

import argparse
import os
import sys

# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile: the
# repository root replaces it
_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="split root containing devkit/mapping/")
    ap.add_argument("--ids", required=True,
                    help="txt file of image ids (train.txt / val.txt)")
    ap.add_argument("--tracklets", default=None,
                    help="optional txt file listing raw sequences that "
                         "have tracklet annotations, one per line")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from groomed_nms_torch.data.tracking import (map_image_to_raw,
                                                 read_train_mapping,
                                                 read_train_rand)

    mapping = read_train_mapping(
        os.path.join(args.root, "devkit", "mapping", "train_mapping.txt"))
    rand_map = read_train_rand(
        os.path.join(args.root, "devkit", "mapping", "train_rand.txt"))

    with open(args.ids) as f:
        ids = [line.strip() for line in f if line.strip()]

    tracklet_seqs = set()
    if args.tracklets:
        with open(args.tracklets) as f:
            tracklet_seqs = {line.strip() for line in f if line.strip()}

    total_seqs = {seq for seq, _ in mapping}
    seqs_used, tr_count = [], 0
    for iid in ids:
        seq, _ = map_image_to_raw(int(iid), mapping, rand_map)
        if seq in tracklet_seqs:
            tr_count += 1
        if seq not in seqs_used:
            seqs_used.append(seq)
            print(f"'{seq}',")

    if tracklet_seqs:
        print(f"with tracking? {tr_count}/{len(ids)}, "
              f"{tr_count / max(len(ids), 1):.4f}")
    print(f"{len(seqs_used)}/{len(total_seqs)} seqs used")


if __name__ == "__main__":
    main()
