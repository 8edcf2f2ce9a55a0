"""Plain reference of the ``kitti_3d_warmup`` configuration: the paper's
stage 1, an M3D-RPN-style detector without the acceptance branch, and its
loss (``loss_stage1``)."""

from .loss_stage1 import stage1_loss as train_loss  # noqa: F401
from .loss_stage1 import target_stats  # noqa: F401
from .plain import decode_rows, make_weights, resize_normalize  # noqa: F401
from .plain import anchor_scores, param_spec as _spec, rpn_forward  # noqa: F401

ACCEPT = False


def param_spec(cfg):
    return _spec(cfg["model"], len(cfg["experiment"]["lbls"]) + 1, ACCEPT)
