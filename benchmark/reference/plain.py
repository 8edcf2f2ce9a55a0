"""Plain PyTorch pieces shared by the configurations' references.

The detector as the paper and its config describe it, written as plain
``torch`` operations over a dict of tensors, with no kernel, cache or
batching trick: the preprocess (half-pixel bilinear resize, crop or pad,
normalise), DenseNet-121 dilated to stride 16 with BatchNorm, the RPN's 3x3
``prop_feats`` conv, the fused 1x1 head and the acceptance branch, the
per-anchor scores and the decode of detection rows.  It imports torch only:
nothing of the program under test, and nothing it has made.  The
parameter names follow the program's ``state_dict`` so that the benchmark
can hand one set of weights to both sides.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
N_BOX2D, N_BOX3D = 4, 10


def param_spec(model, num_classes, accept):
    """[(name, shape, kind)] of the detector's parameters and BatchNorm
    buffers; kind is "conv" (a kernel), "zero", "one" or "count"."""
    bb = model["backbone"]
    growth, bn_size = bb["growth_rate"], bb["bn_size"]
    spec = []

    def conv(name, cout, cin, k, bias=False):
        spec.append((f"{name}.weight", (cout, cin, k, k), "conv"))
        if bias:
            spec.append((f"{name}.bias", (cout,), "zero"))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "one"),
                     (f"{name}.bias", (c,), "zero"),
                     (f"{name}.running_mean", (c,), "zero"),
                     (f"{name}.running_var", (c,), "one"),
                     (f"{name}.num_batches_tracked", (), "count")])

    feats = bb["stem_features"]
    conv("backbone.conv0", feats, 3, 7)
    bn("backbone.norm0", feats)
    for bi, layers in enumerate(bb["block_layers"]):
        for li in range(layers):
            pre = f"backbone.denseblock{bi + 1}_layer{li + 1}"
            bn(f"{pre}.norm1", feats + li * growth)
            conv(f"{pre}.conv1", bn_size * growth, feats + li * growth, 1)
            bn(f"{pre}.norm2", bn_size * growth)
            conv(f"{pre}.conv2", growth, bn_size * growth, 3)
        feats += layers * growth
        if bi < len(bb["block_layers"]) - 1:
            bn(f"backbone.transition{bi + 1}.norm", feats)
            conv(f"backbone.transition{bi + 1}.conv", feats // 2, feats, 1)
            feats //= 2
    bn("backbone.norm5", feats)
    a, prop = model["num_anchors"], model["prop_features"]
    conv("prop_feats", prop, feats, 3, bias=True)
    conv("head", a * (num_classes + N_BOX2D + N_BOX3D), prop, 1, bias=True)
    if accept:
        conv("accept_out", a, prop, 1, bias=True)
    return spec


def make_weights(spec, seed, device):
    """The weights of ``spec`` from ``seed``: every conv kernel drawn in one
    call of a ``torch.Generator`` on ``device``, scaled to N(0, 1/fan_in);
    biases 0; BatchNorm the identity."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, k in spec if k == "conv")
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "conv":
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) / math.sqrt(
                math.prod(shape[1:]))
            at += n
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            fill = torch.ones if kind == "one" else torch.zeros
            out[name] = fill(shape, device=device)
    return out


def resize_normalize(frames_u8, mirror, means, stds, target_h, crop_w):
    """uint8 [B, H0, W0, 3] -> normalised f32 [B, 3, target_h, crop_w]:
    mirrored where ``mirror`` [B] is true, resized by target_h / H0 in both
    axes with half-pixel bilinear taps (the width rounded), cropped or
    zero-padded to ``crop_w``, then (x / 255 - mean) / std.  Only
    upsampling: a shrink would need an antialiasing kernel."""
    x = frames_u8.permute(0, 3, 1, 2).float()
    if mirror is not None:
        x = torch.where(mirror[:, None, None, None], x.flip(-1), x)
    h0, w0 = x.shape[-2:]
    new_w = int(round(w0 * target_h / h0))
    if target_h < h0 or new_w < w0:
        raise NotImplementedError("the reference resizes up only")
    x = _lerp(_lerp(x, target_h, 2), new_w, 3)
    x = x[..., :crop_w] if new_w >= crop_w else F.pad(x, (0, crop_w - new_w))
    m = torch.as_tensor(means, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(stds, dtype=torch.float32, device=x.device)
    return (x / 255.0 - m[:, None, None]) / s[:, None, None]


def _lerp(x, n_out, dim):
    """Half-pixel linear resampling of axis ``dim`` to ``n_out`` samples:
    source (i + 0.5) * n_in / n_out - 0.5, clamped at 0 and at the last."""
    n_in = x.shape[dim]
    src = ((torch.arange(n_out, device=x.device, dtype=torch.float32) + 0.5)
           * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.floor().long().clamp_max(n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    w = src - i0.float()
    shape = [1] * x.dim()
    shape[dim] = n_out
    w = w.view(shape)
    return x.index_select(dim, i0) * (1.0 - w) + x.index_select(dim, i1) * w


def _bn(p, name, x, train):
    return F.batch_norm(x, None if train else p[f"{name}.running_mean"],
                        None if train else p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"],
                        training=train, eps=BN_EPS)


def trunk(p, x, backbone, train=False):
    """DenseNet-BC: stem, dense blocks with transitions, the final BN.
    ``train`` normalises by the batch's statistics (biased variance)."""
    x = F.conv2d(x, p["backbone.conv0.weight"], stride=2, padding=3)
    x = F.max_pool2d(F.relu(_bn(p, "backbone.norm0", x, train)), 3, 2,
                     padding=1)
    blocks = backbone["block_layers"]
    for bi, layers in enumerate(blocks):
        dil = backbone["block_dilations"][bi]
        for li in range(layers):
            pre = f"backbone.denseblock{bi + 1}_layer{li + 1}"
            h = F.relu(_bn(p, f"{pre}.norm1", x, train))
            h = F.conv2d(h, p[f"{pre}.conv1.weight"])
            h = F.relu(_bn(p, f"{pre}.norm2", h, train))
            h = F.conv2d(h, p[f"{pre}.conv2.weight"], padding=dil,
                         dilation=dil)
            x = torch.cat([x, h], dim=1)
        if bi < len(blocks) - 1:
            pre = f"backbone.transition{bi + 1}"
            h = F.relu(_bn(p, f"{pre}.norm", x, train))
            if backbone["transition_pool"][bi]:
                h = F.avg_pool2d(h, 2, 2)
            x = F.conv2d(h, p[f"{pre}.conv.weight"])
    return _bn(p, "backbone.norm5", x, train)


def rpn_forward(p, images, model, train=False):
    """images [B, 3, H, W] -> (head [B, R, per], accept [B, R] or None),
    rows in (h, w, anchor) order, per = classes, 2D deltas, 3D deltas."""
    feats = trunk(p, images, model["backbone"], train)
    h = F.relu(F.conv2d(feats, p["prop_feats.weight"], p["prop_feats.bias"],
                        padding=1))
    b = h.shape[0]
    head = F.conv2d(h, p["head.weight"], p["head.bias"])
    per = head.shape[1] // model["num_anchors"]
    head = head.permute(0, 2, 3, 1).reshape(b, -1, per)
    accept = None
    if "accept_out.weight" in p:
        a = F.conv2d(h, p["accept_out.weight"], p["accept_out.bias"])
        accept = torch.sigmoid(a.permute(0, 2, 3, 1).reshape(b, -1))
    return head, accept


def anchor_scores(head, accept, num_classes):
    """[B, R]: the largest foreground class probability, times the
    acceptance probability when there is one."""
    prob = torch.softmax(head[..., :num_classes], dim=-1)
    s = prob[..., 1:].amax(-1)
    return s * accept if accept is not None else s


def wrap_angle(t):
    """Angles wrapped into (-pi, pi]."""
    w = torch.remainder(t + math.pi, 2 * math.pi) - math.pi
    return torch.where(w <= -math.pi, w + 2 * math.pi, w)


def decode_rows(head, accept, rois, rois_3d, p2_inv, scale, means, stds,
                num_classes):
    """Detection rows of the anchors ``rois`` [K, 5] of one image from their
    head rows [K, per] (f32) and acceptance [K] (or None).

    Returns a dict: ``cont`` [K, 14] the continuous columns [x1, y1, x2, y2,
    score, x2d, y2d, z2d, w3d, h3d, l3d, x3d, y3d, z3d] in the original
    frame's pixels and the camera frame; ``fg_prob`` [K, C-1]; ``axis`` and
    ``head`` [K] the two branch probabilities; ``ry`` and ``alpha`` [K, 4]
    the yaw and observation angle of each branch pair (axis sin/cos x head
    0/pi, in that order), ``branch`` [K] the pair the probabilities pick.
    """
    c = num_classes
    prob = torch.softmax(head[:, :c], dim=-1)
    fg = prob[:, 1:]
    d2 = head[:, c:c + N_BOX2D] * stds[:4] + means[:4]
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    cx = rois[:, 0] + 0.5 * w
    cy = rois[:, 1] + 0.5 * h
    pcx, pcy = d2[:, 0] * w + cx, d2[:, 1] * h + cy
    pw, ph = torch.exp(d2[:, 2]) * w, torch.exp(d2[:, 3]) * h
    box = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw - 1,
                       pcy + 0.5 * ph - 1], dim=-1) / scale
    b3 = head[:, c + N_BOX2D:c + N_BOX2D + N_BOX3D]
    cols = [4, 5, 6, 7, 8, 9, 11, 12]
    dn = b3[:, :8] * stds[cols] + means[cols]
    x2d = (dn[:, 0] * w + cx) / scale
    y2d = (dn[:, 1] * h + cy) / scale
    z2d = rois_3d[:, 0] + dn[:, 2]
    w3d = torch.exp(dn[:, 3]) * rois_3d[:, 1]
    h3d = torch.exp(dn[:, 4]) * rois_3d[:, 2]
    l3d = torch.exp(dn[:, 5]) * rois_3d[:, 3]
    pt = torch.stack([x2d * z2d, y2d * z2d, z2d, torch.ones_like(z2d)], -1)
    cam = (pt[:, None, :] * p2_inv[None, :3, :]).sum(-1)
    x3d, y3d, z3d = cam[:, 0], cam[:, 1], cam[:, 2]
    raw = fg.amax(-1)
    score = raw * accept if accept is not None else raw
    axis, headp = torch.sigmoid(b3[:, 8]), torch.sigmoid(b3[:, 9])
    rsin = rois_3d[:, 5] + dn[:, 6]
    rcos = rois_3d[:, 6] + dn[:, 7]
    ray = torch.atan2(-z3d, x3d)
    ry, alpha = [], []
    for base in (rsin, rcos):
        for flip in (0.0, math.pi):
            r = wrap_angle(wrap_angle(base + flip) + ray + 0.5 * math.pi)
            ry.append(r)
            alpha.append(wrap_angle(r - ray - 0.5 * math.pi))
    branch = (axis < 0.5).long() * 2 + (headp >= 0.5).long()
    cont = torch.stack([box[:, 0], box[:, 1], box[:, 2], box[:, 3], score,
                        x2d, y2d, z2d, w3d, h3d, l3d, x3d, y3d, z3d], -1)
    return {"cont": cont, "fg_prob": fg, "axis": axis, "head": headp,
            "ry": torch.stack(ry, -1), "alpha": torch.stack(alpha, -1),
            "branch": branch}
