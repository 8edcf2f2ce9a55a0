"""Weight-folded eval engine for ``RPN3D`` (``fast_eval``).

Counterpart of ``groomed_nms_tpu/models/fast_eval.py``.  Built once from a
port ``RPN3D`` (``FastEvalRPN3D(model, dtype)``), it holds:

* every BatchNorm's running statistics folded into per-channel (mul, add),
  in f32, then cast to the compute dtype (``ops/kernels.py::fold_bn``);
* the dense blocks named by ``kernel_blocks`` (default the two
  high-resolution ones, 0 and 1) packed once for kernel K4
  (``ops/kernels.py::dense_block_eval``, ``pack_dense_block``); the other
  blocks run as a plain folded concat chain (cuDNN convs, ``torch.cat``);
* the stem, transitions, ``norm5`` and the head convs in the compute dtype.

``FastEvalBackbone.forward`` is JAX ``backbone_eval`` and
``FastEvalRPN3D.forward`` is JAX ``rpn_eval``: the same function as
``RPN3D.forward`` in eval mode up to rounding.  It rounds where JAX does:
each folded BatchNorm is ``x * mul + add`` in the compute dtype, product
then sum rounded, and the transitions' 2x2 pool sums its window in XLA's
order.  On a CUDA device K4 takes bf16 and f32, so an engine there with
kernel blocks refuses any other dtype (``check_kernel_dtype``).  Its output
is the port's ``RPNOutputs``, so ``eval/tester.py::make_infer`` serves it
unchanged.  The stem is the plain 7x7/s2 conv: JAX's TPU-only
space-to-depth rewrite of it is the same function and is left out.

This engine is not the ``fast_eval`` config key, which is the KITTI
evaluator's verbose-grid switch.
"""

from __future__ import annotations

import copy

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.kernels import (DENSE_BLOCK_DTYPES, dense_block_eval, fold_bn,
                           pack_dense_block)
from .densenet import DenseNetBackbone
from .rpn_3d import RPN3D


KERNEL_BLOCKS = (0, 1)         # the dense blocks K4 runs by default


def check_kernel_dtype(device, dtype, kernel_blocks):
    """Refuse an engine its kernel cannot serve: on a CUDA device K4 takes
    bf16 and f32 only, so an engine there with any ``kernel_blocks`` must
    compute in one of them.  (No other path stands in for K4: an f16 or
    f64 engine on the card would raise at its first batch.)"""
    if torch.device(device).type == "cuda" and kernel_blocks and \
            dtype not in DENSE_BLOCK_DTYPES:
        raise ValueError(
            f"fast_eval on {device} runs dense blocks {tuple(kernel_blocks)} "
            f"with K4, which takes bf16 or f32 only; got compute dtype "
            f"{dtype}")


def _frozen(weight, dtype):
    """A conv kernel of the engine: a copy in ``dtype``, off the graph."""
    return weight.detach().to(dtype, copy=True)


class _FoldedNorm(nn.Module):
    """Folded BatchNorm ``x * mul + add``, optional ReLU, rounded as JAX
    rounds it in the compute dtype: the product, then the sum."""

    def __init__(self, bn, dtype, relu=True):
        super().__init__()
        mul, add = fold_bn(bn, dtype)
        self.register_buffer("mul", mul[:, None, None])
        self.register_buffer("add", add[:, None, None])
        self.relu = relu

    def forward(self, x):
        y = (x * self.mul).add_(self.add)
        return y.relu_() if self.relu else y


def _avg_pool_2x2(x):
    """2x2/s2 average pool summed as flax's ``avg_pool`` sums in bf16:
    XLA's ``reduce_window`` on the CPU adds the window in row-major order,
    ``((a + b) + c) + d``, rounding after each add, then divides by 4.
    ``F.avg_pool2d`` rounds once.  An odd last row or column is dropped, as
    by both (VALID pooling)."""
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    return s.add_(x[..., 1::2, 0::2]).add_(x[..., 1::2, 1::2]).div_(4)


class KernelDenseBlock(nn.Module):
    """A dense block run by K4 from weights packed once."""

    def __init__(self, layers, c0, dilation, dtype):
        super().__init__()
        self.dilation = dilation
        packed = pack_dense_block(layers, c0, dtype)
        for name, t in zip(("mul1", "add1", "w1", "mul2", "add2", "w2"),
                           packed):
            self.register_buffer(name, t)

    def forward(self, x):
        return dense_block_eval(x, self.mul1, self.add1, self.w1, self.mul2,
                                self.add2, self.w2, dilation=self.dilation)


class _FoldedDenseLayer(nn.Module):
    """A dense layer with folded norms, for the plain concat chain."""

    def __init__(self, layer, dilation, dtype):
        super().__init__()
        self.dilation = dilation
        self.norm1 = _FoldedNorm(layer.norm1, dtype)
        self.norm2 = _FoldedNorm(layer.norm2, dtype)
        self.register_buffer("w1", _frozen(layer.conv1.weight, dtype))
        self.register_buffer("w2", _frozen(layer.conv2.weight, dtype))

    def forward(self, x):
        h = self.norm2(F.conv2d(self.norm1(x), self.w1))
        return F.conv2d(h, self.w2, padding=self.dilation,
                        dilation=self.dilation)


class _ChainDenseBlock(nn.Module):
    """A dense block as a plain folded concat chain (JAX
    ``_dense_block_lax``): cheap at low resolution."""

    def __init__(self, layers, dilation, dtype):
        super().__init__()
        self.layers = nn.ModuleList(_FoldedDenseLayer(l, dilation, dtype)
                                    for l in layers)

    def forward(self, x):
        for layer in self.layers:
            x = torch.cat([x, layer(x)], dim=1)
        return x


class _FoldedTransition(nn.Module):
    """Folded BN -> ReLU -> optional 2x2 avg pool -> 1x1 conv."""

    def __init__(self, trans, dtype):
        super().__init__()
        self.pool = trans.pool
        self.norm = _FoldedNorm(trans.norm, dtype)
        self.register_buffer("w", _frozen(trans.conv.weight, dtype))

    def forward(self, x):
        x = self.norm(x)
        if self.pool:
            x = _avg_pool_2x2(x)
        return F.conv2d(x, self.w)


class FastEvalBackbone(nn.Module):
    """The eval DenseNet trunk from folded weights (JAX ``backbone_eval``).

    Built once from a ``DenseNetBackbone``; ``kernel_blocks`` are the block
    indices that K4 runs.  NCHW in and out; keep the input channels_last on
    the GPU so the activations pass to K4 and cuDNN without layout copies.
    """

    def __init__(self, backbone: DenseNetBackbone, dtype=torch.bfloat16,
                 kernel_blocks=KERNEL_BLOCKS):
        super().__init__()
        check_kernel_dtype(backbone.conv0.weight.device, dtype, kernel_blocks)
        cfg = backbone.config
        self.register_buffer("conv0", _frozen(backbone.conv0.weight, dtype))
        self.norm0 = _FoldedNorm(backbone.norm0, dtype)
        stages = []
        features = cfg.stem_features
        for bi, (names, trans) in enumerate(backbone.blocks):
            layers = [getattr(backbone, n) for n in names]
            dil = cfg.block_dilations[bi]
            stages.append(KernelDenseBlock(layers, features, dil, dtype)
                          if bi in kernel_blocks else
                          _ChainDenseBlock(layers, dil, dtype))
            features += len(names) * cfg.growth_rate
            if trans is not None:
                stages.append(_FoldedTransition(getattr(backbone, trans),
                                                dtype))
                features //= 2
        self.stages = nn.Sequential(*stages)
        self.norm5 = _FoldedNorm(backbone.norm5, dtype, relu=False)

    def stem(self, x):
        """7x7/s2 conv -> folded norm0 -> ReLU -> 3x3/s2 max pool."""
        x = F.conv2d(x.to(self.conv0.dtype), self.conv0, stride=2, padding=3)
        return F.max_pool2d(self.norm0(x), 3, 2, padding=1)

    def forward(self, x):
        return self.norm5(self.stages(self.stem(x)))


class FastEvalRPN3D(nn.Module):
    """``RPN3D`` served from folded weights (JAX ``rpn_eval``).

    Built once from a port ``RPN3D``: its trunk becomes a
    ``FastEvalBackbone``, its head convs are copied in ``dtype``, and the
    forward is ``RPN3D.forward`` itself, so the outputs are the same
    ``RPNOutputs`` (``fused_raw`` in (h, w, a) row order, plus
    ``accept_prob`` or ``accept_cls``).  Eval only: nothing here trains.
    """

    forward = RPN3D.forward
    _head = RPN3D._head

    def __init__(self, model: RPN3D, dtype=torch.bfloat16,
                 kernel_blocks=KERNEL_BLOCKS):
        super().__init__()
        self.config = model.config
        self.backbone = FastEvalBackbone(model.backbone, dtype, kernel_blocks)
        for name, module in model.named_children():
            if name != "backbone":
                self.add_module(name, copy.deepcopy(module).to(dtype)
                                .requires_grad_(False))
        self.eval()
