#!/usr/bin/env bash
# The paper's two-stage recipe with the PyTorch port, on the CUDA card:
#   stage 1: 80k-iter warmup without NMS in the loss (kitti_3d_warmup)
#   stage 2: 50k-iter GrooMeD-NMS run warm-started from the warmup weights,
#            its anchors and bbox statistics copied (copy_stats)
# then the evaluation of stage 2.  A stage that is interrupted resumes from
# its latest checkpoint when run again.
set -euo pipefail

DATA_ROOT=${DATA_ROOT:-data}
OUTPUT=${OUTPUT:-output}

python scripts/train_torch.py --config kitti_3d_warmup \
    --data-root "$DATA_ROOT" --output "$OUTPUT"

python scripts/train_torch.py --config groomed_nms \
    --data-root "$DATA_ROOT" --output "$OUTPUT" \
    --set "pretrained='$OUTPUT/kitti_3d_warmup'"

python scripts/evaluate_torch.py --config groomed_nms \
    --data-root "$DATA_ROOT" --output "$OUTPUT"
