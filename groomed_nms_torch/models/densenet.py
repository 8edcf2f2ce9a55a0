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
``remat_layers`` / ``remat_epilogue`` recompute whole dense layers, or only
their BN2 -> ReLU -> conv2 tail, in the backward pass of a training step
(``torch.utils.checkpoint``), as flax's ``nn.remat`` does in the JAX trunk.

In eval-mode inference in f32 on a CUDA card each dense block runs as one
call of K4's f32 form (``ops/kernels.py::dense_block_eval``) on its
BatchNorms folded and its weights packed once (``_block_pack``), in place
of the concat chain; ``DenseNetBackbone.forward`` says when.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import (dense_block_eval, dense_block_takes,
                           pack_dense_block)
from ..utils.spans import span


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
    # recompute each dense layer in the backward pass of a training step
    # instead of saving its activations (a peak-memory knob): the whole
    # layer, or only its BN2 -> ReLU -> 3x3 conv tail, whose input (the
    # 128-wide bottleneck output) is saved either way.  Parameter and
    # buffer names are unchanged; eval, no_grad and export see no change
    remat_layers: bool = False
    remat_epilogue: bool = False

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

    With ``process_group`` set (``parallel.wrap_model`` sets it when the
    world is larger than one) the batch is the global one: the statistics
    of every rank's rows, as flax's under a sharded ``jit`` (see
    ``_global_forward``).

    A rematerialised layer's recomputation sets ``recomputing`` (see
    ``_recompute``): the output is recomputed, the running statistics are
    not updated a second time, as flax's ``nn.remat`` updates
    ``batch_stats`` once.
    """

    process_group = None
    recomputing = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_forward(x)
        # the batch mean and 1/sqrt(var + eps) come from the same pass that
        # normalises (f32 for bf16 inputs too); var is recovered from them
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self.recomputing:
            return out
        with torch.no_grad():
            m = self.momentum
            var = invstd.float().pow(-2) - self.eps
            self.running_mean.mul_(1.0 - m).add_(m * mean.float())
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return out

    def _global_forward(self, x):
        """Train mode over the global batch: each channel's sum, sum of
        squares and count reduced over the ranks in one differentiable
        ``all_reduce`` (in f32, f64 for an f64 input), then flax's fast
        variance ``E[x^2] - E[x]^2`` clipped at 0, the output
        ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in that dtype
        cast to x's, and the running statistics' EMA of the global mean and
        biased variance, the variance recovered from the f32 rsqrt as
        ``forward`` recovers it.  Every rank gets the same sums, so its
        statistics stay identical to the others'.  A recomputation
        all-reduces again (the same sums on every rank, so the calls stay
        matched): one more collective a recomputed BatchNorm."""
        from ..parallel.dist import all_reduce

        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=dtype,
                           device=x.device)
        sums = all_reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                     count]), self.process_group)
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + self.eps)
        shape = (1, c, 1, 1)
        out = (xf - mean.view(shape)) * (invstd * self.weight).view(shape) \
            + self.bias.view(shape)
        if self.recomputing:
            return out.to(x.dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.float())
            self.running_var.mul_(1.0 - m).add_(
                m * (invstd.float().pow(-2) - self.eps))
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


def _bn(c, cfg):
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=cfg.bn_momentum)


@contextlib.contextmanager
def _recompute(norms):
    """The context of a checkpointed region's recomputation: its
    BatchNorms normalise without updating their running statistics."""
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def _checkpointed(fn, x, norms):
    """``fn(x)`` with its activations recomputed in the backward pass
    instead of saved (non-reentrant: autocast and the RNG state are
    restored for the recomputation)."""
    return checkpoint(fn, x, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _recompute(norms)))


class DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 conv -> BN -> ReLU -> 3x3 conv (dilated).

    In a training step (train mode, gradients on) ``cfg.remat_layers``
    recomputes the whole layer in the backward pass and
    ``cfg.remat_epilogue`` its BN2 -> ReLU -> conv2 tail only."""

    def __init__(self, in_features, cfg: DenseNetConfig, dilation):
        super().__init__()
        width = cfg.bn_size * cfg.growth_rate
        self.norm1 = _bn(in_features, cfg)
        self.conv1 = nn.Conv2d(in_features, width, 1, bias=False)
        self.norm2 = _bn(width, cfg)
        self.conv2 = nn.Conv2d(width, cfg.growth_rate, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.remat = ("layer" if cfg.remat_layers else
                      "epilogue" if cfg.remat_epilogue else None)

    def _bottleneck(self, x):
        return self.conv1(F.relu(self.norm1(x)))

    def _epilogue(self, h):
        return self.conv2(F.relu(self.norm2(h)))

    def _layer(self, x):
        return self._epilogue(self._bottleneck(x))

    def forward(self, x):
        if self.remat is None or not (self.training
                                      and torch.is_grad_enabled()):
            return self._layer(x)
        if self.remat == "layer":
            return _checkpointed(self._layer, x, (self.norm1, self.norm2))
        return _checkpointed(self._epilogue, self._bottleneck(x),
                             (self.norm2,))


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


def _kernel_device(x):
    """Whether K4's hand-written form runs on ``x``'s device (a CUDA card;
    on the CPU ``dense_block_eval`` is its plain version, the chain's work
    in another order)."""
    return x.is_cuda


class DenseNetBackbone(nn.Module):
    """stem -> 4 dense blocks with transitions -> final BN (no ReLU).

    The output is the raw ``norm5`` activation, as torchvision's ``features``
    gives it to the RPN's ``prop_feats`` conv.

    A dense block runs as one K4 call (``dense_block_eval``) when the
    backbone is in eval mode, gradients are off, the block's input is f32 on
    a CUDA device with autocast off there, no ``torch.compile`` or
    ``torch.export`` trace is running (K4 is no custom op) and K4 takes the
    block's shape (``dense_block_takes``); otherwise as the concat chain.
    ``DenseNetBackbone.packs`` counts the packs built, over every backbone.
    """

    packs = 0

    def __init__(self, cfg: DenseNetConfig = DenseNetConfig()):
        super().__init__()
        self.config = cfg
        self.conv0 = nn.Conv2d(3, cfg.stem_features, 7, stride=2, padding=3,
                               bias=False)
        self.norm0 = _bn(cfg.stem_features, cfg)
        self.blocks = []               # (layer names, transition name or None)
        self.block_inputs = []         # c0 of each block
        self._packs = {}               # block index -> (key, K4's weights)
        features = cfg.stem_features
        for bi, num_layers in enumerate(cfg.block_layers):
            self.block_inputs.append(features)
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
        # the program's span of each stage (utils/spans.py), named once here
        self.stage_spans = [(f"trunk.block{bi + 1}",
                             trans and "trunk." + trans)
                            for bi, (_, trans) in enumerate(self.blocks)]

    def _on_kernel(self, x, bi):
        """Whether block ``bi`` runs on K4 for the input ``x``."""
        cfg = self.config
        return (not self.training and not torch.is_grad_enabled()
                and _kernel_device(x) and x.dtype == torch.float32
                and not torch.is_autocast_enabled(x.device.type)
                and not torch.compiler.is_compiling()
                and dense_block_takes(self.block_inputs[bi], cfg.growth_rate,
                                      cfg.bn_size * cfg.growth_rate))

    def _block_pack(self, bi, x):
        """Block ``bi``'s BatchNorms folded and weights packed for K4 in
        ``x``'s dtype on its device, kept until a parameter or statistic of
        the block is changed in place or replaced (``load_state_dict``, an
        optimizer step, a train-mode forward), or the module is moved or
        cast (``_apply``)."""
        layers = [getattr(self, n) for n in self.blocks[bi][0]]
        try:
            # each tensor's storage and in-place version: a change of either
            # may change its values
            key = (x.device, x.dtype, tuple(
                (t.data_ptr(), t._version) for layer in layers
                for m in (layer.norm1, layer.conv1, layer.norm2, layer.conv2)
                for t in (*m._parameters.values(), *m._buffers.values())
                if t is not None))
        except RuntimeError:        # an inference tensor keeps no version
            key = None
        kept = self._packs.get(bi)
        if kept is None or key is None or kept[0] != key:
            kept = key, pack_dense_block(layers, self.block_inputs[bi],
                                         x.dtype)
            self._packs[bi] = kept
            DenseNetBackbone.packs += 1
        return kept[1]

    def _apply(self, fn, *args, **kwargs):
        self._packs.clear()
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x):
        with span("trunk.stem"):
            x = F.relu(self.norm0(self.conv0(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
        for bi, ((names, trans), (block_span, trans_span)) in enumerate(zip(
                self.blocks, self.stage_spans)):
            with span(block_span):
                if self._on_kernel(x, bi):
                    x = dense_block_eval(
                        x, *self._block_pack(bi, x),
                        dilation=self.config.block_dilations[bi])
                else:
                    for name in names:
                        x = torch.cat([x, getattr(self, name)(x)], dim=1)
            if trans is not None:
                with span(trans_span):
                    x = getattr(self, trans)(x)
        with span("trunk.norm5"):
            return self.norm5(x)
