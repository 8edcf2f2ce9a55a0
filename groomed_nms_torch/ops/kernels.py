"""The hand-written Hopper kernels of the inference paths.

K1 ``fused_head_scores`` (Triton) replaces the TPU kernel
``groomed_nms_tpu/ops/pallas_kernels.py::fused_head_scores``: per anchor,
``max_{i>=1} softmax(l)_i`` over the first C logits of the head tensor,
times the acceptance probability when one is given.

K2 ``greedy_nms`` (CUDA C++, ``csrc/greedy_nms.cu``) replaces
``groomed_nms_tpu/ops/pallas_kernels.py::greedy_nms_pallas``: batched exact
greedy NMS over score-sorted rows.

K3 ``fused_iou_prune`` (CUDA C++, ``csrc/iou_prune.cu``) replaces
``groomed_nms_tpu/ops/pallas_kernels.py::fused_iou_prune``: for score-sorted
boxes, the pairwise IoU matrix and the GrooMeD-NMS prune matrix
``pruning(iou)`` kept strictly lower triangular, padding zeroed.

K4 ``dense_block_eval`` (CUDA C++, ``csrc/dense_block.cu`` in bf16,
``csrc/dense_block_f32.cu`` in f32) replaces
``groomed_nms_tpu/ops/pallas_dense_block.py::dense_block_eval``: one
eval-mode DenseNet block with BatchNorm folded to (mul, add)
(``fold_bn``, ``pack_dense_block``), for the ``fast_eval`` engine
(``models/fast_eval.py``) and the trunk's eval blocks in f32
(``models/densenet.py``).  Its f32 form takes its
products at f32 accuracy from three TF32 products, each operand split into
TF32 halves; ``tf32_split`` is the prep kernel that splits the weights.

``group_leaders`` (CUDA C++, ``csrc/group_leaders.cu``) has no TPU kernel
behind it: it computes GrooMeD-NMS's greedy grouping, which
``groomed_nms_tpu/ops/groomed_nms.py::group_leaders`` leaves to XLA as a
``lax.while_loop``, from the overlap matrix of score-sorted rows.  It has
two paths, chosen from N by ``group_leaders_plan``: one launch on a thread
block cluster an image, or two kernels for larger N.

Each wrapper checks its inputs and dispatches on the tensors' device: on the
CPU it runs the kernel's plain PyTorch version (``*_plain``, the oracle the
CPU tests hold against the JAX kernels), on a CUDA device it launches the
kernel, and on any other device it raises.  ``<wrapper>.launches`` counts the
calls that launched the kernel (plain-version calls are not counted; one K4
call is 2L CUDA launches, one per conv of each layer, after one
``tf32_split`` launch in f32).  Triton is imported
and the CUDA library built only when a kernel is first launched.

The four kernels of the serving paths (K1, K2, K3 and the grouping) are
``torch.library`` custom ops, ``torch.ops.groomed_nms.*``: the CPU kernel
of each is its plain version, the CUDA kernel the hand-written one, and a
fake implementation gives ``torch.export`` the output shapes, so an
exported program (``export.py``) holds each kernel as one node.  The public
wrappers check shapes, dtypes and devices and call the op; the checks that
need real storage (contiguity, alignment, the kernels' size limits) and the
launch counts live in the ops' implementations, so tracing counts nothing.
No op has an autograd formula: K2's output is a mask, and the callers of K1,
K3 and the grouping run without a gradient through them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

_HEAD_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_SCORE_BLOCK = 1024          # head rows per Triton program
_NMS_BLOCK = 64              # rows / columns per uint64 mask word
# the sweep keeps one removed word per 64 rows in shared memory (48 KB at
# this N, far below the 227 KB a block may opt into); the mask scratch is
# already 18 GB an image here
_NMS_MAX_N = 64 * 6000
_IOU_TILE = 32               # K3: output tile edge (csrc/iou_prune.cu)
# f32 operations of one IoU test of K2 and K3: min, max, sub, add and clamp
# for each side, product, union, clamp, divide, compare
IOU_TEST_OPS = 16
# group_leaders: the two-kernel path's sweep block keeps two ints a row in
# shared memory (64 KB at this N); m is 256 MB an image here
_GROUP_MAX_N = 8192
# the cluster path (csrc/group_leaders.cu): one thread block cluster an
# image, a CTA a row block of 64 rows, up to 16 CTAs (8 is the portable
# size, 16 the most Hopper allows), so up to 1024 rows: the operator's
# [8, 512] and [1, 1000]
_GROUP_CLUSTER_CTAS = 16
_GROUP_CLUSTER_MAX_N = _GROUP_CLUSTER_CTAS * _NMS_BLOCK
_TRIPS_PER_CHECK = 4         # group_leaders_plain: survivor trips per host read


def _device_kind(t):
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return kind


def _check_contiguous(**tensors):
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _custom_op(name, schema):
    """A ``groomed_nms::<name>`` op whose CPU kernel is the decorated
    function; the CUDA kernel and the fake are registered on the result."""
    return torch.library.custom_op(f"groomed_nms::{name}", mutates_args=(),
                                   device_types="cpu", schema=schema)


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# K1: fused head scores (Triton)
# ---------------------------------------------------------------------------

def fused_head_scores_plain(fused, accept=None, *, num_classes):
    """The formula of K1 in PyTorch, in f32: [B, R, per] -> [B, R]."""
    logits = fused[..., :num_classes].float()
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e[..., 1:].amax(-1) / e.sum(-1)
    return s * accept if accept is not None else s


@functools.cache
def _head_scores_kernel():
    """Compile-on-first-use Triton kernel.

    Bound on this card by memory alone: at the main-path shape it reads the
    bf16 head tensor [8, 126720, 18] (36.5 MB; the C=4 logits sit in the
    first 8 bytes of every 36-byte row, so nearly every 32-byte sector is
    touched), the f32 acceptance (4.05 MB) and writes 4.05 MB of f32.  One
    program takes a block of rows: a masked load of the first C channels
    (the ragged tail and the 36-byte row stride are handled by the masks and
    the offsets), then max, exp and sum in registers in f32 -- one pass, no
    softmax tensor is ever written.
    """
    # `tl` is made a module global so that the kernel body below, which
    # Triton compiles from source, finds it in the module's namespace
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def head_scores(x_ptr, a_ptr, out_ptr, n_rows, per,
                    C: tl.constexpr, CP: tl.constexpr,
                    HAS_ACCEPT: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        cols = tl.arange(0, CP)
        row_ok = rows < n_rows
        ptrs = x_ptr + rows.to(tl.int64)[:, None] * per + cols[None, :]
        ok = row_ok[:, None] & (cols[None, :] < C)
        x = tl.load(ptrs, mask=ok, other=float("-inf")).to(tl.float32)
        m = tl.max(x, axis=1)
        e = tl.exp(x - m[:, None])                 # padded columns -> 0
        s = tl.sum(e, axis=1)
        fg = tl.max(tl.where(cols[None, :] >= 1, e, 0.0), axis=1)
        score = fg / s
        if HAS_ACCEPT:
            score = score * tl.load(a_ptr + rows, mask=row_ok, other=0.0)
        tl.store(out_ptr + rows, score, mask=row_ok)

    return triton, head_scores


def fused_head_scores(fused, accept=None, *, num_classes):
    """Detection score per anchor: ``max(softmax(fused[..., :C])[1:])``,
    times ``accept`` when given.

    ``fused`` [B, R, per] bf16/f16/f32 contiguous (class logits in channels
    [0, C)); ``accept`` [B, R] f32 contiguous or None.  Returns [B, R] f32.
    """
    if fused.dim() != 3 or fused.dtype not in _HEAD_DTYPES:
        raise ValueError(f"fused must be [B, R, per] of {_HEAD_DTYPES}, got "
                         f"{tuple(fused.shape)} {fused.dtype}")
    b, r, per = fused.shape
    if not 2 <= num_classes <= per:
        raise ValueError(f"num_classes={num_classes} with per={per}")
    if accept is not None and (
            accept.shape != (b, r) or accept.dtype != torch.float32
            or accept.device != fused.device):
        raise ValueError(f"accept must be a contiguous f32 [{b}, {r}] on "
                         f"{fused.device}, got {tuple(accept.shape)} "
                         f"{accept.dtype} on {accept.device}")
    _device_kind(fused)
    return torch.ops.groomed_nms.fused_head_scores(fused, accept, num_classes)


@_custom_op("fused_head_scores",
            "(Tensor fused, Tensor? accept, int num_classes) -> Tensor")
def _head_scores_cpu(fused, accept, num_classes):
    _check_contiguous(fused=fused, accept=accept)
    return fused_head_scores_plain(fused, accept, num_classes=num_classes)


@_head_scores_cpu.register_fake
def _(fused, accept, num_classes):
    return fused.new_empty(fused.shape[:2], dtype=torch.float32)


@_head_scores_cpu.register_kernel("cuda")
def _(fused, accept, num_classes):
    _check_contiguous(fused=fused, accept=accept)
    triton, kernel = _head_scores_kernel()
    b, r, per = fused.shape
    out = torch.empty((b, r), dtype=torch.float32, device=fused.device)
    n_rows = b * r
    with torch.cuda.device(fused.device):
        kernel[(triton.cdiv(n_rows, _SCORE_BLOCK),)](
            fused, accept if accept is not None else out, out, n_rows, per,
            C=num_classes, CP=triton.next_power_of_2(num_classes),
            HAS_ACCEPT=accept is not None, BLOCK=_SCORE_BLOCK, num_warps=4)
    fused_head_scores.launches += 1
    return out


fused_head_scores.launches = 0


# ---------------------------------------------------------------------------
# K2: batched greedy NMS (CUDA C++)
# ---------------------------------------------------------------------------

def greedy_nms_plain(boxes, scores, *, nms_threshold=0.4, shift=1.0):
    """K2's function in PyTorch: a sequential greedy loop over the
    [B, N, N] overlap matrix, the IoU in ``_nms_kernel``'s operation order."""
    n = boxes.shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + shift) * (y2 - y1 + shift)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :]) + shift).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :]) + shift).clamp_min(0.0)
    inter = iw * ih
    union = (area[:, :, None] + area[:, None, :] - inter).clamp_min(1e-12)
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    over = (inter / union > nms_threshold) & later      # row i suppresses j>i
    alive = scores > 0
    for i in range(n):
        alive &= ~(over[:, i] & alive[:, i:i + 1])
    return alive


def greedy_nms(boxes, scores, *, nms_threshold=0.4, shift=1.0):
    """Batched exact greedy NMS; rows must be score-sorted per image.

    ``boxes`` [B, N, 4] f32 and ``scores`` [B, N] f32, contiguous, on one
    device; rows with score <= 0 are padding (never kept, suppress nothing).
    IoU uses the ``+shift`` pixel convention; a row is suppressed when its
    IoU with a kept earlier row is > ``nms_threshold``.  Returns keep [B, N]
    bool.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be [B, N, 4] and scores [B, N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"boxes and scores must be f32, got {boxes.dtype} "
                         f"and {scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    _device_kind(boxes)
    return torch.ops.groomed_nms.greedy_nms(
        boxes, scores, float(nms_threshold), float(shift))


@_custom_op("greedy_nms", "(Tensor boxes, Tensor scores, float nms_threshold,"
            " float shift) -> Tensor")
def _greedy_nms_cpu(boxes, scores, nms_threshold, shift):
    _check_contiguous(boxes=boxes, scores=scores)
    return greedy_nms_plain(boxes, scores, nms_threshold=nms_threshold,
                            shift=shift)


@_greedy_nms_cpu.register_fake
def _(boxes, scores, nms_threshold, shift):
    return scores.new_empty(scores.shape, dtype=torch.bool)


@_greedy_nms_cpu.register_kernel("cuda")
def _(boxes, scores, nms_threshold, shift):
    _check_contiguous(boxes=boxes, scores=scores)
    b, n = scores.shape
    if n > _NMS_MAX_N or b > 65535:
        raise ValueError(f"greedy_nms takes B <= 65535 and N <= {_NMS_MAX_N},"
                         f" got B={b}, N={n}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (rows load as float4)")
    lib = _build.greedy_nms_lib()
    words = -(-n // _NMS_BLOCK)
    mask = torch.empty((b, n, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = lib.greedy_nms(
            boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, n, nms_threshold, shift,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "greedy_nms")
    greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0


# ---------------------------------------------------------------------------
# K3: fused IoU + prune matrices (CUDA C++)
# ---------------------------------------------------------------------------

PRUNING_METHODS = ("linear", "sigmoidal", "soft_nms")


def prune_transform(iou, nms_threshold, temperature, pruning_method):
    """p(iou), the probability that an overlap prunes a lower-scored box,
    as K3's body writes it: ``linear`` iou, ``sigmoidal`` sigmoid((iou -
    t) / T), ``soft_nms`` 1 - exp(-iou^2 / T)."""
    if pruning_method == "linear":
        return iou
    if pruning_method == "sigmoidal":
        return torch.sigmoid((iou - nms_threshold) / temperature)
    if pruning_method == "soft_nms":
        return 1.0 - torch.exp(-(iou * iou) / temperature)
    raise NotImplementedError(f"pruning method {pruning_method!r}")


def fused_iou_prune_plain(boxes, valid, *, nms_threshold=0.4,
                          temperature=0.1, pruning_method="linear",
                          shift=0.0):
    """K3's function in PyTorch, in the kernel's operation order: ``iw``,
    ``ih``, ``inter``, both areas, ``union = max(a + b - inter, 1e-12)``,
    ``inter / union``, then the prune transform, the strict lower triangle,
    and zeros wherever either box is padding."""
    ax1, ay1, ax2, ay2 = (c[:, :, None] for c in boxes.unbind(-1))
    bx1, by1, bx2, by2 = (c[:, None, :] for c in boxes.unbind(-1))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + shift
          ).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + shift
          ).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + shift) * (ay2 - ay1 + shift)
    area_b = (bx2 - bx1 + shift) * (by2 - by1 + shift)
    iou = inter / (area_a + area_b - inter).clamp_min(1e-12)
    p = prune_transform(iou, nms_threshold, temperature, pruning_method)
    n = boxes.shape[1]
    lower = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril(-1)
    vv = valid[:, :, None] & valid[:, None, :]
    return (torch.where(vv, iou, 0.0),
            torch.where(vv & lower, p, 0.0))


@torch.no_grad()
def fused_iou_prune(boxes, valid=None, *, nms_threshold=0.4, temperature=0.1,
                    pruning_method="linear", shift=0.0):
    """Pairwise IoU and GrooMeD-NMS prune matrices of score-sorted boxes.

    ``boxes`` [B, N, 4] f32 contiguous, rows in descending score order;
    ``valid`` [B, N] bool contiguous on the same device (None: every row is
    real).  Returns ``(iou, prune)``, each [B, N, N] f32: ``prune[i, j]`` is
    ``pruning(iou[i, j])`` for ``j < i`` and 0 on and above the diagonal,
    and both are 0 wherever row i or column j is padding.  ``pruning`` is
    "linear" (the identity), "sigmoidal" ``sigmoid((iou - t) / T)`` or
    "soft_nms" ``1 - exp(-iou^2 / T)``.  Runs under ``torch.no_grad()``: K3
    has no backward, and both callers stop the gradient of the overlaps.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be [B, N, 4] f32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if pruning_method not in PRUNING_METHODS:
        raise ValueError(f"pruning_method must be one of {PRUNING_METHODS}, "
                         f"got {pruning_method!r}")
    b, n, _ = boxes.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    if valid.shape != (b, n) or valid.dtype != torch.bool or \
            valid.device != boxes.device:
        raise ValueError(f"valid must be a contiguous bool [{b}, {n}] on "
                         f"{boxes.device}, got {tuple(valid.shape)} "
                         f"{valid.dtype} on {valid.device}")
    _device_kind(boxes)
    return torch.ops.groomed_nms.fused_iou_prune(
        boxes, valid, float(nms_threshold), float(temperature),
        pruning_method, float(shift))


@_custom_op("fused_iou_prune", "(Tensor boxes, Tensor valid, float "
            "nms_threshold, float temperature, str pruning_method, float "
            "shift) -> (Tensor, Tensor)")
def _iou_prune_cpu(boxes, valid, nms_threshold, temperature, pruning_method,
                   shift):
    _check_contiguous(boxes=boxes, valid=valid)
    return fused_iou_prune_plain(
        boxes, valid, nms_threshold=nms_threshold, temperature=temperature,
        pruning_method=pruning_method, shift=shift)


@_iou_prune_cpu.register_fake
def _(boxes, valid, nms_threshold, temperature, pruning_method, shift):
    b, n, _ = boxes.shape
    return boxes.new_empty((b, n, n)), boxes.new_empty((b, n, n))


@_iou_prune_cpu.register_kernel("cuda")
def _(boxes, valid, nms_threshold, temperature, pruning_method, shift):
    _check_contiguous(boxes=boxes, valid=valid)
    b, n, _ = boxes.shape
    if b > 65535 or n > 65535 * _IOU_TILE:
        raise ValueError(f"fused_iou_prune takes B <= 65535 and N <= "
                         f"{65535 * _IOU_TILE}, got B={b}, N={n}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (rows load as float4)")
    lib = _build.iou_prune_lib()
    iou = torch.empty((b, n, n), dtype=torch.float32, device=boxes.device)
    prune = torch.empty_like(iou)
    with torch.cuda.device(boxes.device):
        err = lib.iou_prune(
            boxes.data_ptr(), valid.data_ptr(), iou.data_ptr(),
            prune.data_ptr(), b, n, PRUNING_METHODS.index(pruning_method),
            nms_threshold, temperature, shift,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "fused_iou_prune")
    fused_iou_prune.launches += 1
    return iou, prune


fused_iou_prune.launches = 0


def iou_prune_work(b, n):
    """The least work of K3 at [b, n]: (f32 operations, bytes).  Each pair
    of boxes tested once (``IOU_TEST_OPS``; the mirror is free), the boxes
    and valid flags read once and both [b, n, n] f32 matrices written."""
    return (b * n * (n - 1) // 2 * IOU_TEST_OPS,
            b * n * (16 + 1) + 2 * b * n * n * 4)


# ---------------------------------------------------------------------------
# GrooMeD-NMS's grouping (CUDA C++)
# ---------------------------------------------------------------------------

def group_leaders_plain(m, valid, *, nms_threshold, group_size):
    """The grouping in PyTorch: ``m`` [B, N, N], ``valid`` [B, N] ->
    [B, N] int64 (arguments as ``group_leaders``).

    The reference groups greedily: the first alive box leads a group of
    every alive box i with ``m[i, leader] > nms_threshold``; all of them
    leave the alive set, and only the first ``group_size + 1`` (in score
    order) stay in the group.  That loop's structure gives it without one
    host round trip per group:

    * the leaders are the greedy-NMS survivors in score order: box i
      survives when it is valid and no earlier survivor j has ``m[i, j] >
      nms_threshold``.  That rule has one solution (by induction over i),
      and iterating it from "every valid box survives" reaches it: after t
      trips rows 0..t-1 are final, and a trip that changes nothing has
      reached it.  Each trip is one batched product; the host reads whether
      the last of every ``_TRIPS_PER_CHECK`` trips changed anything (a few
      reads per call where greedy chains are short, never one per group);
    * box i's group is the first leader j <= i with ``m[i, j] >
      nms_threshold`` (i itself for a leader);
    * its rank in the group counts the members up to i (the cap).
    """
    n = m.shape[-1]
    idx = torch.arange(n, device=m.device)
    over = m > nms_threshold
    before = idx[None, :] < idx[:, None]                 # [i, j]: j < i
    # 0/1 in f32: the products count earlier survivors exactly (TF32 too)
    removable = (over & before).float()
    leader_of = valid
    while True:
        for _ in range(_TRIPS_PER_CHECK):
            prev = leader_of
            hits = torch.bmm(removable, prev.float()[..., None])[..., 0]
            leader_of = valid & (hits == 0)
        if torch.equal(prev, leader_of):
            break
    joins = leader_of[:, None, :] & (over & before | torch.eye(
        n, dtype=torch.bool, device=m.device))
    # the first such leader: j weighted n - j so the argmax is unique
    first = torch.where(joins, n - idx, 0).argmax(-1)
    # members of i's group up to i itself: valid j <= i with the same leader
    same = (first[:, :, None] == first[:, None, :]) & valid[:, None, :] & \
        ~before.T
    rank = same.sum(-1) - 1
    capped = valid & (rank < group_size + 1)
    return torch.where(capped, first, -1)


def group_leaders_work(b, n):
    """The least work of the grouping at [b, n]: (f32 compares, bytes).
    The strict lower triangle of m read once (one compare an entry), the
    valid flags read and the int64 leaders written."""
    pairs = b * n * (n - 1) // 2
    return pairs, pairs * 4 + b * n * (1 + 8)


@torch.no_grad()
def group_leaders(m, valid, *, nms_threshold, group_size):
    """GrooMeD-NMS's greedy grouping of score-sorted rows.

    ``m`` [B, N, N] f32 contiguous, the overlap of row i with row j at
    ``m[i, j]`` (it need not be symmetric); ``valid`` [B, N] bool
    contiguous on the same device.  Row i leads a group when it is valid and
    no earlier leader j has ``m[i, j] > nms_threshold`` (an f32 compare;
    NaN is never over).  A valid row's group is the first leader j <= i
    with ``m[i, j] > nms_threshold`` (itself for a leader); the first
    ``group_size + 1`` valid rows of a group, in row order, keep it.
    Returns [B, N] int64: each row's leader, -1 for padding and for rows
    past the cap (a negative ``group_size`` caps every row out).

    On a CUDA tensor one call takes the path ``group_leaders_plan(N)``
    gives: up to ``_GROUP_CLUSTER_MAX_N`` rows one launch of the cluster
    kernel, above it two (bits, then the sweep).  Either counts once in
    ``group_leaders.launches`` and once in its path's count
    (``group_leaders.cluster_launches``, ``.two_kernel_launches``); N is at
    most ``_GROUP_MAX_N`` there.
    """
    if m.dim() != 3 or m.shape[1] != m.shape[2] or m.dtype != torch.float32:
        raise ValueError(f"m must be [B, N, N] f32, got {tuple(m.shape)} "
                         f"{m.dtype}")
    b, n, _ = m.shape
    if valid.shape != (b, n) or valid.dtype != torch.bool or \
            valid.device != m.device:
        raise ValueError(f"valid must be a contiguous bool [{b}, {n}] on "
                         f"{m.device}, got {tuple(valid.shape)} "
                         f"{valid.dtype} on {valid.device}")
    _device_kind(m)
    return torch.ops.groomed_nms.group_leaders(
        m, valid, float(nms_threshold), float(group_size))


@_custom_op("group_leaders", "(Tensor m, Tensor valid, float nms_threshold, "
            "float group_size) -> Tensor")
def _group_leaders_cpu(m, valid, nms_threshold, group_size):
    _check_contiguous(m=m, valid=valid)
    return group_leaders_plain(m, valid, nms_threshold=nms_threshold,
                               group_size=group_size)


@_group_leaders_cpu.register_fake
def _(m, valid, nms_threshold, group_size):
    return valid.new_empty(valid.shape, dtype=torch.int64)


@_group_leaders_cpu.register_kernel("cuda")
def _(m, valid, nms_threshold, group_size):
    _check_contiguous(m=m, valid=valid)
    b, n, _ = m.shape
    if b > 65535:
        raise ValueError(f"group_leaders takes B <= 65535 and N <= "
                         f"{_GROUP_MAX_N}, got B={b}, N={n}")
    plan = group_leaders_plan(n)
    out = _group_leaders_launch(m, valid, nms_threshold, group_size, plan)
    group_leaders.launches += 1
    if plan.path == "cluster":
        group_leaders.cluster_launches += 1
    else:
        group_leaders.two_kernel_launches += 1
    return out


group_leaders.launches = 0
# the launches of each path (csrc/group_leaders.cu): one cluster kernel, or
# the bits and sweep kernels
group_leaders.cluster_launches = 0
group_leaders.two_kernel_launches = 0


class GroupPlan(NamedTuple):
    """How ``group_leaders`` runs at one N on the card: ``path`` "cluster"
    (one launch, a thread block cluster of ``ctas`` CTAs an image, one a row
    block of 64 rows) or "two_kernel" (the bits kernel, then the sweep;
    ``ctas`` 0); ``smem`` the dynamic shared memory of a block of the
    cluster kernel or of the sweep, in bytes, as ``csrc/group_leaders.cu``
    computes it."""
    path: str
    ctas: int
    smem: int


def group_leaders_plan(n):
    """The path of ``group_leaders`` at N rows on the card (``GroupPlan``).

    Up to ``_GROUP_CLUSTER_MAX_N`` rows the cluster path on nb = ceil(N /
    64) CTAs; its shared memory is the CTA's over words ([nb, 64] u64), two
    mailbox words and a leader word a row block and its valid word (u64), a
    group a row of its block and a group count a row of the image (int32).
    Above it the two-kernel path, whose sweep keeps three u64 a row block
    and two int32 a row.  Raises ValueError above ``_GROUP_MAX_N``."""
    if n > _GROUP_MAX_N:
        raise ValueError(f"group_leaders takes N <= {_GROUP_MAX_N}, got "
                         f"N={n}")
    nb = -(-n // _NMS_BLOCK)
    if n <= _GROUP_CLUSTER_MAX_N:
        return GroupPlan("cluster", max(nb, 1),
                         8 * (nb * _NMS_BLOCK + 3 * nb + 1)
                         + 4 * (_NMS_BLOCK + n))
    return GroupPlan("two_kernel", 0, 3 * nb * 8 + 2 * n * 4)


def _group_leaders_launch(m, valid, nms_threshold, group_size, plan):
    """One launch of ``csrc/group_leaders.cu`` on contiguous CUDA tensors by
    ``plan``; returns the [B, N] int64 leaders.  Counts nothing: the custom
    op counts its own launches."""
    b, n, _ = m.shape
    # rank < group_size + 1 for an integer rank in [0, n): the same as
    # rank < cap with cap an integer in [0, n + 1]
    cap = n + 1 if group_size >= n else max(math.ceil(group_size + 1), 0)
    lib = _build.group_leaders_lib()
    out = torch.empty((b, n), dtype=torch.int64, device=m.device)
    sup = over = None
    if plan.path == "two_kernel":
        words = -(-n // _NMS_BLOCK)
        sup = torch.empty((b, n, words), dtype=torch.int64, device=m.device)
        over = torch.empty_like(sup)
    with torch.cuda.device(m.device):
        err = lib.group_leaders(
            m.data_ptr(), valid.data_ptr(),
            None if sup is None else sup.data_ptr(),
            None if over is None else over.data_ptr(), out.data_ptr(), b, n,
            nms_threshold, cap, plan.ctas,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "group_leaders")
    return out


# ---------------------------------------------------------------------------
# K4: eval-mode dense block (CUDA C++)
# ---------------------------------------------------------------------------

# the dtypes K4 takes, on the card and on the CPU
DENSE_BLOCK_DTYPES = (torch.bfloat16, torch.float32)


def dense_block_takes(c0, growth, bw):
    """Whether K4's kernels take a block of this shape: c0 and G multiples
    of 8, G <= 64 and bw a multiple of 32 up to 128."""
    return not (c0 % 8 or growth % 8 or growth > 64 or bw % 32 or bw > 128)


@torch.no_grad()
def fold_bn(bn, dtype):
    """Eval BatchNorm -> (mul, add): folded in f32, then cast to ``dtype``."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    mul = bn.weight.float() * inv
    add = bn.bias.float() - bn.running_mean.float() * mul
    return mul.to(dtype), add.to(dtype)


@torch.no_grad()
def pack_dense_block(layers, c0, dtype):
    """One block's folded weights in K4's layout, zero past each layer's
    input, from its dense layers (``models/densenet.py::DenseLayer``: norm1,
    conv1, norm2, conv2): (mul1 [L, cmax], add1 [L, cmax], w1 [L, bw, cmax],
    mul2 [L, bw], add2 [L, bw], w2 [L, G, 9*bw] with
    k = (ty*3 + tx)*bw + channel)."""
    n = len(layers)
    bw, growth = layers[0].conv1.out_channels, layers[0].conv2.out_channels
    cmax = c0 + n * growth
    kw = dict(dtype=dtype, device=layers[0].conv1.weight.device)
    mul1, add1 = torch.zeros(n, cmax, **kw), torch.zeros(n, cmax, **kw)
    w1 = torch.zeros(n, bw, cmax, **kw)
    mul2, add2 = torch.zeros(n, bw, **kw), torch.zeros(n, bw, **kw)
    w2 = torch.zeros(n, growth, 9 * bw, **kw)
    for l, layer in enumerate(layers):
        cin = c0 + l * growth
        mul1[l, :cin], add1[l, :cin] = fold_bn(layer.norm1, dtype)
        w1[l, :, :cin] = layer.conv1.weight[:, :, 0, 0]
        mul2[l], add2[l] = fold_bn(layer.norm2, dtype)
        w2[l] = layer.conv2.weight.permute(0, 2, 3, 1).reshape(growth, -1)
    return mul1, add1, w1, mul2, add2, w2


def dense_block_eval_plain(x0, mul1, add1, w1, mul2, add2, w2, *,
                           dilation=1):
    """K4's function in PyTorch: a concat chain with the rounding points of
    the TPU kernel.  Each folded norm is ``x * mul + add`` in ``x0.dtype``
    as JAX applies it: the product rounded, then the sum rounded, then ReLU.
    The convolutions' products are taken in f32 from operands in
    ``x0.dtype`` (on a CUDA card, turn TF32 off before comparing), and the
    1x1's f32 sum, ``h`` and the new channels are rounded to ``x0.dtype``
    (nothing to round in f32).  Arguments as ``dense_block_eval``."""
    dt = x0.dtype
    layers, bw, _ = w1.shape
    growth = w2.shape[1]
    c0 = x0.shape[1]

    def affine_relu(x, mul, add):
        return (x * mul[:, None, None] + add[:, None, None]).clamp_min(0.0)

    stack = x0
    for l in range(layers):
        cin = c0 + l * growth
        y = affine_relu(stack, mul1[l, :cin], add1[l, :cin])
        k1 = w1[l, :, :cin, None, None].float()
        h = affine_relu(F.conv2d(y.float(), k1).to(dt), mul2[l], add2[l])
        k2 = w2[l].float().reshape(growth, 3, 3, bw).permute(0, 3, 1, 2)
        out = F.conv2d(h.float(), k2, padding=dilation, dilation=dilation)
        stack = torch.cat([stack, out.to(dt)], dim=1)
    return stack.contiguous(memory_format=torch.channels_last)


def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` in integer bit operations: the f32 ``x`` rounded
    to TF32's 10 mantissa bits, to nearest with ties away from zero, as an
    f32 whose low 13 bits are zero.  On the magnitude's bits, adding half
    the dropped unit (``0x1000``) and clearing the 13 low bits rounds that
    way; a carry into the exponent is the rounding up that it should be.
    Finite inputs (the largest magnitudes round to infinity)."""
    u = x.contiguous().view(torch.int32)
    sign = u & torch.iinfo(torch.int32).min
    mag = ((u & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (sign | mag).view(torch.float32)


def tf32_split_plain(x):
    """The prep kernel's function in PyTorch: f32 ``x`` -> (hi, lo) with
    ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, each rounded as
    ``cvt.rna.tf32.f32`` rounds (``_tf32_rna``); ``x - hi`` is exact in f32,
    and ``|x - hi - lo| <= 2**-22 |x|`` plus TF32's smallest subnormal
    (2**-136).  Bit for bit the kernel's on finite inputs."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split takes f32, got {x.dtype}")
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def tf32_split(x):
    """The prep kernel of K4's f32 form (``csrc/dense_block_f32.cu::
    tf32_split``), alone: f32 ``x`` -> (hi, lo) as ``tf32_split_plain``,
    each in ``x``'s shape.  ``dense_block_eval`` launches it inside its f32
    entry (counted there); a call here counts once in
    ``tf32_split.launches``."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split takes f32, got {x.dtype}")
    if _device_kind(x) == "cpu":
        return tf32_split_plain(x)
    n = x.shape[-1] if x.dim() else 1
    xs = F.pad(x.reshape(x.numel() // n if n else 0, n),
               (0, -n % 4)).contiguous()
    out = torch.empty((xs.shape[0], 2, xs.shape[1]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _build.dense_block_f32_lib().tf32_split_f32(
            xs.data_ptr(), xs.shape[0], xs.shape[1], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "tf32_split")
    tf32_split.launches += 1
    return tuple(out[:, i, :n].reshape(x.shape) for i in range(2))


tf32_split.launches = 0


def dense_block_work(b, c0, h, w, layers, growth, bw, elem_bytes=2):
    """The least work of one dense block on the kernel: (FLOP, bytes).

    FLOP: 2 * pixels * bw * (sum over layers of cin + 9 * G), the 1x1 and
    3x3 products.  Bytes: the input x0 read once and the whole stack
    [B, c0 + L*G, H, W] written once, ``elem_bytes`` an element (2 in bf16,
    4 in f32; the weights, under 2% of it on DenseNet-121's blocks, are
    left out)."""
    pixels = b * h * w
    k1 = sum(c0 + l * growth for l in range(layers))
    flop = 2 * pixels * bw * (k1 + 9 * growth * layers)
    nbytes = pixels * (c0 + c0 + layers * growth) * elem_bytes
    return flop, nbytes


def _check_dense_block(x0, mul1, add1, w1, mul2, add2, w2, dilation):
    """K4's argument checks; returns (layers, c0, cmax, bw, growth)."""
    if x0.dim() != 4 or x0.dtype not in DENSE_BLOCK_DTYPES:
        raise ValueError(f"x0 must be [B, c0, H, W] of {DENSE_BLOCK_DTYPES}, "
                         f"got {tuple(x0.shape)} {x0.dtype}")
    if w1.dim() != 3 or w2.dim() != 3:
        raise ValueError(f"w1 must be [L, bw, cmax] and w2 [L, G, 9*bw], got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    layers, bw, cmax = w1.shape
    growth, c0 = w2.shape[1], x0.shape[1]
    if layers < 1 or growth < 1 or cmax != c0 + layers * growth:
        raise ValueError(f"cmax={cmax} is not c0 + L*G = {c0} + {layers}*"
                         f"{growth}")
    want = {"mul1": (layers, cmax), "add1": (layers, cmax),
            "mul2": (layers, bw), "add2": (layers, bw),
            "w2": (layers, growth, 9 * bw)}
    for name, t in zip(("mul1", "add1", "w1", "mul2", "add2", "w2"),
                       (mul1, add1, w1, mul2, add2, w2)):
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {list(want[name])}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != x0.dtype or t.device != x0.device or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {x0.dtype} on "
                             f"{x0.device}, got {t.dtype} on {t.device}")
    if isinstance(dilation, bool) or not isinstance(dilation, int) or \
            dilation < 1:
        raise ValueError(f"dilation must be an int >= 1, got {dilation!r}")
    return layers, c0, cmax, bw, growth


def dense_block_eval(x0, mul1, add1, w1, mul2, add2, w2, *, dilation=1):
    """One eval-mode DenseNet block: L x (BN1 -> ReLU -> 1x1 conv to bw ->
    BN2 -> ReLU -> 3x3 conv dilated by ``dilation`` to G channels, appended).

    ``x0`` [B, c0, H, W] (channels_last keeps its copy into the stack a
    straight one) -> the block's whole stack [B, c0 + L*G, H, W] in
    channels_last, input channels first.  The weights, packed by
    ``pack_dense_block`` in ``x0``'s dtype, contiguous:
    ``mul1``/``add1`` [L, cmax] folded norm1 (zero past each layer's input),
    ``w1`` [L, bw, cmax] 1x1 kernels (K contiguous, zero past the input),
    ``mul2``/``add2`` [L, bw] folded norm2, ``w2`` [L, G, 9*bw] 3x3 kernels
    with k = (ty*3 + tx)*bw + channel.

    On a CUDA tensor one call is 2L kernel launches (after a copy of ``x0``
    into the stack; in f32 after one ``tf32_split`` launch that splits the
    weights into scratch, 2 * (w1 + w2) elements when cmax is a multiple of
    32) and counts once in ``dense_block_eval.launches``.  The kernel takes
    bf16
    (``csrc/dense_block.cu::dense_block_eval``) and f32
    (``csrc/dense_block_f32.cu::dense_block_eval_f32``: products at f32
    accuracy, 3xTF32), the shapes ``dense_block_takes``; anything else
    raises ``ValueError``.
    """
    layers, c0, cmax, bw, growth = _check_dense_block(
        x0, mul1, add1, w1, mul2, add2, w2, dilation)
    if _device_kind(x0) == "cpu":
        return dense_block_eval_plain(x0, mul1, add1, w1, mul2, add2, w2,
                                      dilation=dilation)

    if not dense_block_takes(c0, growth, bw):
        raise ValueError(f"the dense-block kernel takes c0 and G multiples of "
                         f"8, G <= 64, bw in (32, 64, 96, 128); got c0={c0}, "
                         f"G={growth}, bw={bw}")
    b, _, h, w = x0.shape
    with torch.cuda.device(x0.device):
        stack = torch.empty((b, cmax, h, w), dtype=x0.dtype, device=x0.device,
                            memory_format=torch.channels_last)
        stack[:, :c0].copy_(x0)
        hbuf = torch.empty((b * h * w, bw), dtype=x0.dtype, device=x0.device)
        # _check_dense_block took DENSE_BLOCK_DTYPES only
        if x0.dtype == torch.bfloat16:
            fn, scratch = _build.dense_block_lib().dense_block_eval, ()
        else:
            lib = _build.dense_block_f32_lib()
            fn = lib.dense_block_eval_f32
            wsplit = torch.empty(
                lib.dense_block_eval_f32_scratch(cmax, layers, bw, growth),
                dtype=torch.float32, device=x0.device)
            scratch = (wsplit.data_ptr(),)
        err = fn(stack.data_ptr(), hbuf.data_ptr(), *scratch,
                 mul1.data_ptr(), add1.data_ptr(), w1.data_ptr(),
                 mul2.data_ptr(), add2.data_ptr(), w2.data_ptr(), b, h, w,
                 c0, cmax, layers, bw, growth, dilation,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_block_eval kernel launch failed: CUDA "
                           f"error {err}")
    dense_block_eval.launches += 1
    return stack


dense_block_eval.launches = 0
