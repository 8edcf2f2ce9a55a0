"""AP-loss (Chen et al., CVPR 2019) with a hand-specified gradient
(counterpart of ``groomed_nms_tpu/losses/aploss.py``).

The forward computes the loss and its gradient together; the backward of the
``autograd.Function`` returns that stored gradient times the incoming one,
as the JAX ``custom_vjp`` does.  Batched over leading axes: the positives'
loop of the reference is two [N, N] products and a running max:

  rank terms    H_ij = clamp((s_j - s_i) / (2 delta) + 0.5, 0, 1)
  a_i = sum_{j in P} H_ij + 0.5,  b_i = sum_{j in valid negatives} H_ij
  prec_i = running max over positives in ascending score of a_i / (a_i + b_i)
  d/ds_j = sum_i H_ij * scale_i / (a_i + b_i) / F   (negatives)
  d/ds_i = -(1 - prec_i) / F                        (positives)

Targets: 1 positive, 0 negative, anything else (-1) ignored.  The loss is
``1 - mean interpolated precision`` (0 when there is no positive).
"""

from __future__ import annotations

import torch

_DELTA = 1.0


def _ap_forward(logits, targets):
    """(metric [...], grad [..., N]) for logits, targets [..., N]."""
    logits = logits.float()
    pos = targets == 1
    neg = targets == 0
    fg_num = pos.sum(-1)
    any_pos = fg_num > 0

    inf = torch.full((), float("inf"), device=logits.device)
    min_fg = torch.where(pos, logits, inf).amin(-1, keepdim=True)
    valid_neg = neg & (logits >= min_fg - _DELTA)

    # rows: reference positive i, columns: other box j
    h = ((logits[..., None, :] - logits[..., :, None]) / (2 * _DELTA)
         + 0.5).clamp(0.0, 1.0)
    a = torch.where(pos, (h * pos[..., None, :]).sum(-1), 0.0) + 0.5
    b = (h * valid_neg[..., None, :]).sum(-1)
    current = a / (a + b)

    # running max of precision in ascending positive-score order
    order = torch.sort(torch.where(pos, logits, inf), dim=-1,
                       stable=True).indices
    pos_sorted = torch.gather(pos, -1, order)
    cur_sorted = torch.where(pos_sorted, torch.gather(current, -1, order),
                             -inf)
    running = torch.cummax(cur_sorted, dim=-1).values
    prev = torch.cat([torch.full_like(running[..., :1], float("-inf")),
                      running[..., :-1]], dim=-1)
    scale_sorted = torch.where(
        cur_sorted >= prev, 1.0,
        (1.0 - running) / (1.0 - cur_sorted).clamp_min(1e-12))
    zero = torch.zeros_like(current)
    prec = zero.scatter(-1, order, torch.where(pos_sorted, running, 0.0))
    scale = zero.scatter(-1, order, torch.where(pos_sorted, scale_sorted,
                                                0.0))

    fg_den = fg_num.clamp_min(1).float()[..., None]
    w = torch.where(pos, scale / (a + b), 0.0)
    grad_neg = torch.where(valid_neg, (w[..., None, :] @ h)[..., 0, :], 0.0)
    grad_pos = torch.where(pos, -(1.0 - prec), 0.0)
    grad = torch.where(any_pos[..., None], (grad_neg + grad_pos) / fg_den,
                       0.0)
    metric = torch.where(any_pos, 1.0 - prec.sum(-1) / fg_den[..., 0], 0.0)
    return metric, grad


class _APLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        metric, grad = _ap_forward(logits.detach(), targets)
        ctx.save_for_backward(grad)
        return metric

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g[..., None], None


def ap_loss(logits, targets):
    """AP ranking loss of logits [..., N] with targets [..., N] in
    {1, 0, -1}; one value per leading index."""
    return _APLoss.apply(logits, targets)
