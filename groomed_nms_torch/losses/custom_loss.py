"""A mean squared error with its gradient written by hand, the counterpart
of ``groomed_nms_tpu/losses/custom_loss.py`` (a ``jax.custom_vjp``): the
template of the hand-gradient losses, held against autograd's MSE."""

from __future__ import annotations

import torch


class _CustomMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, loss_weight):
        ctx.save_for_backward(pred, target)
        ctx.loss_weight = loss_weight
        return loss_weight * ((pred - target) ** 2).mean()

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        grad = ctx.loss_weight * 2.0 * (pred - target) / pred.numel()
        return grad * g, None, None


def custom_mse(pred, target, loss_weight=1.0):
    """``loss_weight * mean((pred - target)^2)``; its backward, by hand,
    gives ``pred`` the gradient ``loss_weight * 2 (pred - target) / n`` and
    ``target`` none, as JAX's custom VJP does."""
    return _CustomMSE.apply(pred, target, loss_weight)
