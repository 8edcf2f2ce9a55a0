"""RankNet pairwise ranking loss (Burges et al., 2005), the counterpart of
``groomed_nms_tpu/losses/ranknet.py``: binary cross-entropy with logits over
every ordered pair of valid entries whose relevance differs."""

from __future__ import annotations

import torch


def ranknet_loss(scores, relevance, valid_mask=None, weight_by_diff=False):
    """Mean over valid pairs (i, j) with rel_i != rel_j of
    BCE(sigmoid(s_i - s_j), 1[rel_i > rel_j]), in f32.

    ``scores`` [N] logits, ``relevance`` [N], ``valid_mask`` optional [N]
    bool (padded entries join no pair).  ``weight_by_diff`` weights each
    pair by |rel_i - rel_j|.  A scalar; 0 when no pair is valid.
    """
    scores = scores.float()
    relevance = relevance.float()
    if valid_mask is None:
        valid_mask = torch.ones(scores.shape, dtype=torch.bool,
                                device=scores.device)
    s_diff = scores[:, None] - scores[None, :]
    r_diff = relevance[:, None] - relevance[None, :]
    pair_valid = valid_mask[:, None] & valid_mask[None, :] & (r_diff != 0)
    label = (r_diff > 0).float()
    # the numerically stable form of BCE with logits
    bce = (s_diff.clamp_min(0) - s_diff * label
           + torch.log1p(torch.exp(-s_diff.abs())))
    if weight_by_diff:
        bce = bce * r_diff.abs()
    count = pair_valid.sum().clamp_min(1)
    return torch.where(pair_valid, bce, 0.0).sum() / count
