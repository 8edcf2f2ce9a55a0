"""K1 (``ops/kernels.py::fused_head_scores``): per anchor the largest
foreground softmax probability of the C class logits, times the acceptance.
Operations: 4 f32 ops a logit (max, exp, sum, divide); bytes: the head rows
read once ([B, R, per] of ``elem_bytes``), the acceptance [B, R] f32 when
there is one, the scores [B, R] f32 written once.  Held against the f32
CUDA-core rate."""

from harness.peaks import PEAK_F32

OPS_PER_LOGIT = 4
PEAK = PEAK_F32


def work(b, r, per, elem_bytes, accept, num_classes=4, **_):
    ops = b * r * num_classes * OPS_PER_LOGIT
    nbytes = b * r * (per * elem_bytes + (4 if accept else 0) + 4)
    return ops, nbytes
