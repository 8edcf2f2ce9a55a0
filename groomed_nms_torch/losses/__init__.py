"""Training losses (counterpart of ``groomed_nms_tpu/losses``)."""

from .aploss import ap_loss
from .ranknet import ranknet_loss
from .rpn_3d import LossConfig, UncertaintyState, rpn_3d_loss

__all__ = ["ap_loss", "ranknet_loss", "LossConfig", "UncertaintyState",
           "rpn_3d_loss"]
