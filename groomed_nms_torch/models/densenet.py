"""DenseNet trunk with a dilated final block (stride 16), NCHW.

Counterpart of ``groomed_nms_tpu/models/densenet.py``: torchvision's
DenseNet-121 ``features`` with ``transition3``'s pool removed and every
``denseblock4`` 3x3 conv dilated x2.  Submodule names follow the flax
module's (``conv0``, ``norm0``, ``denseblock{b}_layer{l}.{norm1,conv1,norm2,
conv2}``, ``transition{b}.{norm,conv}``, ``norm5``), so a flax variables tree
maps onto the ``state_dict`` name by name (``utils/weights.py``).

The compute dtype is not part of the module: run it under
``torch.autocast`` for bf16, with the input and the module in
``channels_last`` on the GPU.  BatchNorm keeps f32 parameters and statistics
and, in train mode, updates them as flax does (``FlaxBatchNorm2d``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


@dataclass(frozen=True)
class DenseNetConfig:
    """DenseNet-BC topology. Defaults = DenseNet-121, dilated stride-16."""

    growth_rate: int = 32
    block_layers: Sequence[int] = (6, 12, 24, 16)
    stem_features: int = 64
    bn_size: int = 4                     # bottleneck width multiplier
    # per-block dilation of the 3x3 convs; the last block is dilated x2 in
    # place of the stride the removed transition3 pool would have added
    block_dilations: Sequence[int] = (1, 1, 1, 2)
    # transitions after blocks 0..n-2; True = 2x2 avg-pool stride 2
    transition_pool: Sequence[bool] = (True, True, False)
    bn_momentum: float = 0.1             # torch convention: the batch weight

    @property
    def out_features(self) -> int:
        n = self.stem_features
        for i, layers in enumerate(self.block_layers):
            n += layers * self.growth_rate
            if i < len(self.block_layers) - 1:
                n //= 2
        return n


def tiny_densenet_config() -> DenseNetConfig:
    """A toy topology for unit tests."""
    return DenseNetConfig(growth_rate=8, block_layers=(2, 2, 2, 2),
                          stem_features=16)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics
    as flax's ``nn.BatchNorm`` does: the EMA of the batch mean and of the
    **biased** batch variance (torch's own update uses the unbiased one,
    n/(n-1) times larger), both in f32.  The output is normalised with the
    batch statistics, as in torch.  Eval mode is ``nn.BatchNorm2d``'s.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # the batch mean and 1/sqrt(var + eps) come from the same pass that
        # normalises (f32 for bf16 inputs too); var is recovered from them
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            var = invstd.float().pow(-2) - self.eps
            self.running_mean.mul_(1.0 - m).add_(m * mean.float())
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return out


def _bn(c, cfg):
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=cfg.bn_momentum)


class DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 conv -> BN -> ReLU -> 3x3 conv (dilated)."""

    def __init__(self, in_features, cfg: DenseNetConfig, dilation):
        super().__init__()
        width = cfg.bn_size * cfg.growth_rate
        self.norm1 = _bn(in_features, cfg)
        self.conv1 = nn.Conv2d(in_features, width, 1, bias=False)
        self.norm2 = _bn(width, cfg)
        self.conv2 = nn.Conv2d(width, cfg.growth_rate, 3, padding=dilation,
                               dilation=dilation, bias=False)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h)))


class Transition(nn.Module):
    """BN -> ReLU -> optional 2x2 avg pool -> 1x1 conv.

    Pooling before the bias-free 1x1 conv is the same function as after it
    (both are linear) at a quarter of the conv work.
    """

    def __init__(self, in_features, out_features, pool, cfg: DenseNetConfig):
        super().__init__()
        self.pool = pool
        self.norm = _bn(in_features, cfg)
        self.conv = nn.Conv2d(in_features, out_features, 1, bias=False)

    def forward(self, x):
        h = F.relu(self.norm(x))
        if self.pool:
            h = F.avg_pool2d(h, 2, 2)
        return self.conv(h)


class DenseNetBackbone(nn.Module):
    """stem -> 4 dense blocks with transitions -> final BN (no ReLU).

    The output is the raw ``norm5`` activation, as torchvision's ``features``
    gives it to the RPN's ``prop_feats`` conv.
    """

    def __init__(self, cfg: DenseNetConfig = DenseNetConfig()):
        super().__init__()
        self.config = cfg
        self.conv0 = nn.Conv2d(3, cfg.stem_features, 7, stride=2, padding=3,
                               bias=False)
        self.norm0 = _bn(cfg.stem_features, cfg)
        self.blocks = []               # (layer names, transition name or None)
        features = cfg.stem_features
        for bi, num_layers in enumerate(cfg.block_layers):
            names = []
            for li in range(num_layers):
                name = f"denseblock{bi + 1}_layer{li + 1}"
                self.add_module(name, DenseLayer(
                    features + li * cfg.growth_rate, cfg,
                    cfg.block_dilations[bi]))
                names.append(name)
            features += num_layers * cfg.growth_rate
            trans = None
            if bi < len(cfg.block_layers) - 1:
                trans = f"transition{bi + 1}"
                self.add_module(trans, Transition(
                    features, features // 2, cfg.transition_pool[bi], cfg))
                features //= 2
            self.blocks.append((names, trans))
        self.norm5 = _bn(features, cfg)

    def forward(self, x):
        x = F.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for names, trans in self.blocks:
            for name in names:
                x = torch.cat([x, getattr(self, name)(x)], dim=1)
            if trans is not None:
                x = getattr(self, trans)(x)
        return self.norm5(x)
