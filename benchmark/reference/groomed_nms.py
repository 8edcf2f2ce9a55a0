"""Plain reference of the ``groomed_nms`` configuration: the GrooMeD-NMS
detector (Kumar et al., CVPR 2021) at test time, with its acceptance
branch.  Serving only: a training cell of this configuration names a
reference of its own that adds the stage-2 loss (GrooMeD-NMS and the
after-NMS AP loss in the loop)."""

from .loss_stage1 import target_stats  # noqa: F401
from .plain import decode_rows, make_weights, resize_normalize  # noqa: F401
from .plain import anchor_scores, param_spec as _spec, rpn_forward  # noqa: F401

ACCEPT = True


def param_spec(cfg):
    return _spec(cfg["model"], len(cfg["experiment"]["lbls"]) + 1, ACCEPT)

