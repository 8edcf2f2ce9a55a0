"""K2 (``csrc/greedy_nms.cu``): batched exact greedy NMS over the pre-NMS
top-k rows of each image.  Operations: each pair of rows tested once,
16 f32 ops an IoU test (min, max, sub, add and clamp for each side, the
product, the union, a clamp, the divide, the compare); bytes: the boxes
(16), scores (4) and keep flag (1) of every row moved once.  Held against
the f32 CUDA-core rate."""

from harness.peaks import PEAK_F32

IOU_TEST_OPS = 16
PEAK = PEAK_F32


def tests(b, n):
    return b * n * (n - 1) // 2


def work(b, nms_n, **_):
    return tests(b, nms_n) * IOU_TEST_OPS, b * nms_n * (16 + 4 + 1)
