"""Model FLOPs counted once from the configuration's shapes, over the plain
reference's forward on the meta device, so that they read the same work
whatever implements it (cuDNN, K4 or a later kernel)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def _meta_params(spec):
    return {n: torch.zeros((), dtype=torch.long, device="meta")
            if k == "count" else torch.empty(s, device="meta")
            for n, s, k in spec}


def forward_flops(ref, cfg, batch):
    """FLOPs of the detector's forward on ``batch`` images of the crop."""
    h, w = cfg["experiment"]["crop_size"]
    x = torch.empty(batch, 3, h, w, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.rpn_forward(_meta_params(ref.param_spec(cfg)), x, cfg["model"])
    return fc.get_total_flops()


def trunk_flops(trunk, spec, backbone, batch, h, w):
    """FLOPs of ``trunk`` (the plain DenseNet) alone at ``batch`` x h x w."""
    x = torch.empty(batch, 3, h, w, device="meta")
    with FlopCounterMode(display=False) as fc:
        trunk(_meta_params(spec), x, backbone)
    return fc.get_total_flops()
