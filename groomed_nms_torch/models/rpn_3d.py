"""Single-stage anchor-based 3D RPN head on the DenseNet trunk.

Counterpart of ``groomed_nms_tpu/models/rpn_3d.py``: a 3x3 ``prop_feats``
conv, ONE fused 1x1 ``head`` conv that emits every per-anchor channel, and the
optional acceptance branch.  The head's [B, A*per, H, W] output becomes
[B, H*W*A, per] with channel index ``a*per + p`` -- the (h, w, a) row order
of ``anchors.locate_anchors``.  With the module and its input in
``channels_last`` that reshape is a view.

Per-anchor channel order of ``fused_raw`` (anchor-major):
``[cls C | bbox_2d 4 | bbox_3d 10 (+1 vel) | uncertainty (0/1)]``.

``RPNOutputs`` keeps ``fused_raw`` in the compute dtype and computes the f32
splits (``cls``, ``prob``, ``bbox_2d``, ``bbox_3d``, ``uncertainty``) only
when they are read: the inference path scores and gathers from ``fused_raw``
and never reads them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from .densenet import DenseNetBackbone, DenseNetConfig

N_BOX2D = 4
N_BOX3D = 10  # x3d y3d z3d w3d h3d l3d rsin rcos axis head


@dataclass(frozen=True)
class RPNConfig:
    num_classes: int = 4                  # bg + Car/Pedestrian/Cyclist
    num_anchors: int = 36
    prop_features: int = 512
    feat_stride: int = 16
    predict_acceptance_prob: bool = False
    acceptance_prob_mode: str = "likelihood"   # regress|rank|likelihood|classify
    acceptance_prob_classify_bins: int = 2
    acceptance_prob_num_layers: int = 1
    acceptance_prob_num_channels: int = 128
    predict_uncertainty: bool = False     # the ``_un`` model's channel
    predict_velocity: bool = False        # the video model's bbox_3d channel
    backbone: DenseNetConfig = field(default_factory=DenseNetConfig)

    @property
    def n_box3d(self) -> int:
        return N_BOX3D + (1 if self.predict_velocity else 0)

    @property
    def per_anchor(self) -> int:
        return (self.num_classes + N_BOX2D + self.n_box3d
                + (1 if self.predict_uncertainty else 0))

    @property
    def accept_channels(self) -> int:
        if not self.predict_acceptance_prob:
            return 0
        if self.acceptance_prob_mode == "classify":
            return self.acceptance_prob_classify_bins - 1
        return 1


@dataclass
class RPNOutputs:
    """Head outputs, all [B, R, *] with R = H*W*A."""

    fused_raw: torch.Tensor               # [B, R, per] compute dtype
    feat_hw: tuple
    num_classes: int
    n_box3d: int
    accept_prob: Optional[torch.Tensor] = None   # [B, R] f32
    accept_cls: Optional[torch.Tensor] = None    # [B, R, bins-1] f32

    @cached_property
    def _f32(self):
        return self.fused_raw.float()

    @property
    def cls(self):
        """Raw class logits [B, R, C]."""
        return self._f32[..., :self.num_classes]

    @property
    def prob(self):
        return torch.softmax(self.cls, dim=-1)

    @property
    def bbox_2d(self):
        c = self.num_classes
        return self._f32[..., c:c + N_BOX2D]

    @property
    def bbox_3d(self):
        """[x, y, z, w, h, l, rsin, rcos, axis, head, (vel)]; axis and head
        pass through a sigmoid, vel stays linear."""
        s = self.num_classes + N_BOX2D
        b3 = self._f32[..., s:s + self.n_box3d]
        return torch.cat([b3[..., :8], torch.sigmoid(b3[..., 8:10]),
                          b3[..., 10:]], dim=-1)

    @property
    def uncertainty(self):
        per = self.fused_raw.shape[-1]
        u = self.num_classes + N_BOX2D + self.n_box3d
        return torch.sigmoid(self._f32[..., u]) if per > u else None


def _to_rows(x, k):
    """[B, A*k, H, W] -> [B, H*W*A, k] in (h, w, a) order."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, k)


class RPN3D(nn.Module):
    """Backbone + prop_feats conv + fused per-anchor prediction head."""

    def __init__(self, cfg: RPNConfig = RPNConfig()):
        super().__init__()
        self.config = cfg
        a = cfg.num_anchors
        self.backbone = DenseNetBackbone(cfg.backbone)
        self.prop_feats = nn.Conv2d(cfg.backbone.out_features,
                                    cfg.prop_features, 3, padding=1)
        self.head = nn.Conv2d(cfg.prop_features, a * cfg.per_anchor, 1)
        if cfg.predict_acceptance_prob:
            c_in = cfg.prop_features
            for i in range(cfg.acceptance_prob_num_layers - 1):
                self.add_module(f"accept_{i}", nn.Conv2d(
                    c_in, cfg.acceptance_prob_num_channels, 1))
                c_in = cfg.acceptance_prob_num_channels
            self.accept_out = nn.Conv2d(c_in, a * cfg.accept_channels, 1)

    def forward(self, images, return_base=False):
        """images [B, 3, H, W] (normalised) -> RPNOutputs, and with
        ``return_base`` the trunk's features too (the video model's pose
        branch reads them)."""
        cfg = self.config
        feats = self.backbone(images)
        h = F.relu(self.prop_feats(feats))
        fh, fw = h.shape[2], h.shape[3]
        out = RPNOutputs(fused_raw=_to_rows(self.head(h), cfg.per_anchor),
                         feat_hw=(fh, fw), num_classes=cfg.num_classes,
                         n_box3d=cfg.n_box3d)
        if cfg.predict_acceptance_prob:
            ah = h
            for i in range(cfg.acceptance_prob_num_layers - 1):
                ah = F.relu(getattr(self, f"accept_{i}")(ah))
            ap = _to_rows(self.accept_out(ah), cfg.accept_channels).float()
            if cfg.acceptance_prob_mode == "classify":
                out.accept_cls = torch.sigmoid(ap)
            else:
                out.accept_prob = torch.sigmoid(ap[..., 0])
        return (out, feats) if return_base else out
