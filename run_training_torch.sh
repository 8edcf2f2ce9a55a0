#!/usr/bin/env bash
# The paper's two-stage recipe with the PyTorch port, on the CUDA cards:
#   stage 1: 80k-iter warmup without NMS in the loss (kitti_3d_warmup)
#   stage 2: 50k-iter GrooMeD-NMS run warm-started from the warmup weights,
#            its anchors and bbox statistics copied (copy_stats)
# then the evaluation of stage 2.  Each step runs under torchrun with one
# process a visible card (NPROC, default: the card count), data-parallel
# over the configs' global batch (which must divide by NPROC).  A stage that
# is interrupted resumes from its latest checkpoint when run again.
set -euo pipefail

DATA_ROOT=${DATA_ROOT:-data}
OUTPUT=${OUTPUT:-output}
NPROC=${NPROC:-$(python -c "import torch; print(max(1, torch.cuda.device_count()))")}
RUN=(python -m torch.distributed.run --standalone --nproc_per_node "$NPROC")

"${RUN[@]}" scripts/train_torch.py --config kitti_3d_warmup \
    --data-root "$DATA_ROOT" --output "$OUTPUT"

"${RUN[@]}" scripts/train_torch.py --config groomed_nms \
    --data-root "$DATA_ROOT" --output "$OUTPUT" \
    --set "pretrained='$OUTPUT/kitti_3d_warmup'"

"${RUN[@]}" scripts/evaluate_torch.py --config groomed_nms \
    --data-root "$DATA_ROOT" --output "$OUTPUT"
