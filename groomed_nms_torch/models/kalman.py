"""The video model's Kalman tracker and ego-pose network (counterpart of
``groomed_nms_tpu/models/kalman.py``).

Tracks live in T fixed slots with a validity mask and measurements in M
fixed slots, so every function is a fixed-shape tensor program: no boolean-
mask indexing, no ``.item()``, no ``nonzero``, and no value read back to the
host, which keeps a clip's tracking free of device synchronisations and open
to a CUDA graph.  The greedy association runs its ``min(T, M)`` iterations
as the JAX ``fori_loop`` does, without stopping early.  The small matrix
products (3x3 rotations, the 9x9 covariances) are written as products and
sums, so no TF32 matmul can enter; the Kalman gain is one batched 8x8
``torch.linalg.solve_ex`` (``solve`` checks its result on the host).

The JAX package's semantics are kept, quirks included (its docstrings pin
them against the reference): the process noise covers all nine state
variables where the initial and measurement covariances cover eight; a
frame with tracks but no association kills every track; phase 1 of the
association gates on a 3D-centre distance of ``match_dist`` (0.5 m).

State layout (9): [x, y, z, w3d, h3d, l3d, theta, head, vel].
Measurement layout (16):
  [x1, y1, x2, y2, score, cls, x, y, z, w3d, h3d, l3d, theta, head, un, vel]
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import project_3d_box
from ..ops.iou import pairwise_iou

NUM_VARS = 9
MEAS_COLS = 16

LAMBDA_O = 0.2   # confidence -> covariance scale
K_P = 0.75       # a missed track's confidence decay
K_M = 0.05       # track kill threshold
MATCH_DIST = 0.5


@dataclasses.dataclass
class Tracks:
    """Fixed-slot track state of one clip (leading dim T)."""

    valid: torch.Tensor    # [T] bool
    ids: torch.Tensor      # [T] int32 (-1 for empty)
    next_id: torch.Tensor  # 0-dim int32
    X: torch.Tensor        # [T, 9] state
    C: torch.Tensor        # [T, 9, 9] covariance
    A: torch.Tensor        # [T, 9, 9] transition
    box2d: torch.Tensor    # [T, 6] x1 y1 x2 y2 score cls
    un: torch.Tensor       # [T] confidence

    @staticmethod
    def empty(t, device=None, dtype=torch.float32) -> "Tracks":
        eye = _eye(t, NUM_VARS, device, dtype)
        return Tracks(
            valid=torch.zeros((t,), dtype=torch.bool, device=device),
            ids=torch.full((t,), -1, dtype=torch.int32, device=device),
            next_id=torch.zeros((), dtype=torch.int32, device=device),
            X=torch.zeros((t, NUM_VARS), dtype=dtype, device=device),
            C=eye, A=eye.clone(),
            box2d=torch.zeros((t, 6), dtype=dtype, device=device),
            un=torch.zeros((t,), dtype=dtype, device=device))

    def replace(self, **changes) -> "Tracks":
        return dataclasses.replace(self, **changes)


def _eye(n, size, device, dtype):
    return torch.eye(size, dtype=dtype, device=device).expand(
        n, size, size).clone()


def _bmm(a, b):
    """[..., i, j] x [..., j, k] -> [..., i, k] as products and a sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _bmv(a, v):
    """[..., i, j] x [..., j] -> [..., i]."""
    return (a * v[..., None, :]).sum(-1)


def make_transition_matrix(theta, head):
    """Velocity along the heading: identity with (0, 8) = cos(ry) and
    (2, 8) = -sin(ry), ry = theta (+ pi when head >= 0.5)."""
    ry = torch.where(head >= 0.5, theta + math.pi, theta)
    a = _eye(ry.shape[0], NUM_VARS, ry.device, ry.dtype)
    a[:, 0, 8] = torch.cos(ry)
    a[:, 2, 8] = -torch.sin(ry)
    return a.detach()


def make_covariance(vals, size=NUM_VARS, n_diag=8):
    """eye(size) with the first ``min(n_diag, size)`` diagonal entries set
    to ``vals`` [N] (the JAX docstring has the call sites' widths)."""
    c = _eye(vals.shape[0], size, vals.device, vals.dtype)
    c.diagonal(dim1=1, dim2=2)[:, :min(n_diag, size)] = vals[:, None]
    return c


def project_ego(tracks: Tracks, pose_dn, p2) -> Tracks:
    """Rigid-transform the track states by the relative ego pose ``pose_dn``
    [6] = (tx, ty, tz, rx, ry, rz) (euler angles, rotation z @ y @ x) and
    refresh the projected 2D boxes through ``p2`` [4, 4]."""
    tx, ty, tz, rx, ry, rz = pose_dn.unbind()
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    rot_x = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    rot_y = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rot_z = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    rot = _bmm(_bmm(rot_z, rot_y), rot_x)

    x = tracks.X
    xyz = _bmv(rot, x[:, :3]) + torch.stack([tx, ty, tz])
    x_new = torch.cat([xyz, x[:, 3:6], (x[:, 6] + ry)[:, None], x[:, 7:]],
                      dim=-1)
    return tracks.replace(X=x_new, box2d=_refresh_box2d(tracks.box2d, x_new,
                                                        p2))


def _refresh_box2d(box2d, x, p2):
    proj = project_3d_box(p2, *x[:, :7].unbind(-1))
    return torch.cat([proj, box2d[:, 4:]], dim=-1)


def forecast_tracks(tracks: Tracks, p2) -> Tracks:
    """X <- A X; C <- A C A^T; refresh the projected 2D boxes."""
    a = tracks.A
    x_new = _bmv(a, tracks.X)
    c_new = _bmm(_bmm(a, tracks.C), a.transpose(1, 2))
    return tracks.replace(X=x_new, C=c_new,
                          box2d=_refresh_box2d(tracks.box2d, x_new, p2))


def _greedy_match(cost, pair_ok, thresh, minimize, match_t, used_m):
    """Greedy bipartite matching over a [T, M] cost: ``min(T, M)`` times,
    take the best pair of the whole matrix, record it when it passes
    ``thresh``, and poison its row and column.  Returns (match_t [T] int32,
    used_m [M] bool)."""
    t, m = cost.shape
    bad = math.inf if minimize else -math.inf
    cost = torch.where(pair_ok, cost, bad)
    # rows and columns matched by an earlier phase
    cost = torch.where((match_t >= 0)[:, None] | used_m[None, :], bad, cost)
    rows = torch.arange(t, device=cost.device)
    cols = torch.arange(m, device=cost.device)
    for _ in range(min(t, m)):
        flat = cost.reshape(-1)
        best = flat.argmin() if minimize else flat.argmax()
        val = flat.gather(0, best[None])[0]
        ti, mi = best // m, best % m
        ok = (val <= thresh) if minimize else (val >= thresh)
        hit_t, hit_m = ok & (rows == ti), ok & (cols == mi)
        match_t = torch.where(hit_t, mi.to(torch.int32), match_t)
        used_m = used_m | hit_m
        cost = torch.where(hit_t[:, None] | hit_m[None, :], bad, cost)
    return match_t, used_m


def associate_tracks(tracks: Tracks, meas, meas_valid, best_thresh=0.35,
                     match_dist=MATCH_DIST):
    """Two-phase greedy association: 3D-centre distance <= ``match_dist``,
    then 2D IoU >= ``best_thresh``.  Returns (match_t [T] int32, -1 where
    unmatched; used_m [M] bool)."""
    t, m = tracks.valid.shape[0], meas.shape[0]
    pair_ok = tracks.valid[:, None] & meas_valid[None, :]
    dist = ((meas[None, :, 6:9] - tracks.X[:, None, :3]) ** 2).sum(-1).sqrt()
    match_t = torch.full((t,), -1, dtype=torch.int32, device=meas.device)
    used_m = torch.zeros((m,), dtype=torch.bool, device=meas.device)
    match_t, used_m = _greedy_match(dist, pair_ok, match_dist, True, match_t,
                                    used_m)
    ols = torch.nan_to_num(pairwise_iou(tracks.box2d[:, :4], meas[:, :4]),
                           nan=0.0)
    return _greedy_match(ols, pair_ok, best_thresh, False, match_t, used_m)


def update_tracks(tracks: Tracks, meas, meas_valid, match_t) -> Tracks:
    """Kalman measurement update and track health: the gain from the
    blended confidences, a 0.5/0.5 confidence mix, K_P decay for missed
    tracks, tracks with z <= 1 or confidence <= K_M pruned."""
    matched = match_t >= 0
    z_meas = meas.index_select(0, match_t.clamp_min(0).long())   # [T, 16]
    un_meas = z_meas[:, 14] * z_meas[:, 4]
    un_pre = tracks.un

    c_pre = tracks.C + make_covariance(1.0 - un_pre, n_diag=9)
    r = make_covariance(LAMBDA_O * (1.0 - un_meas), size=8)
    # H = I[:8]: H C H^T = C[:8, :8], C H^T = C[:, :8]
    s = c_pre[:, :8, :8] + r
    k_gain = torch.linalg.solve_ex(
        s.transpose(1, 2), c_pre[:, :, :8].transpose(1, 2)).result
    k_gain = k_gain.transpose(1, 2)                             # [T, 9, 8]

    innov = z_meas[:, 6:14] - tracks.X[:, :8]
    x_final = tracks.X + _bmv(k_gain, innov)
    eye = torch.eye(NUM_VARS, dtype=c_pre.dtype, device=c_pre.device)
    c_final = _bmm(eye - F.pad(k_gain, (0, 1)), c_pre)

    upd = matched & tracks.valid
    x_new = torch.where(upd[:, None], x_final, tracks.X)
    c_new = torch.where(upd[:, None, None], c_final, tracks.C)
    un_new = torch.where(upd, 0.5 * un_meas + 0.5 * un_pre,
                         tracks.un * torch.where(tracks.valid, K_P, 1.0))
    box_new = torch.where(upd[:, None], z_meas[:, :6], tracks.box2d)
    a_new = torch.where(upd[:, None, None],
                        make_transition_matrix(x_new[:, 6], x_new[:, 7]),
                        tracks.A)
    # a frame with tracks but no association kills every track, and this
    # frame's measurements respawn fresh ones
    healthy = tracks.valid & upd.any() & (x_new[:, 2] > 1.0) & (un_new > K_M)
    return tracks.replace(valid=healthy, X=x_new, C=c_new, A=a_new,
                          box2d=box_new, un=un_new)


def add_unused_measurements(tracks: Tracks, meas, meas_valid,
                            used_m) -> Tracks:
    """Start tracks from the unmatched measurements: the k-th new
    measurement (in slot order) fills the k-th free slot."""
    t, m = tracks.valid.shape[0], meas.shape[0]
    new_mask = meas_valid & ~used_m
    free_rank = torch.cumsum(~tracks.valid, 0) - 1              # [T]
    new_rank = torch.cumsum(new_mask, 0) - 1                    # [M]
    n_new = new_mask.sum()

    want = torch.where(~tracks.valid & (free_rank < n_new), free_rank, -1)
    order = torch.sort(torch.where(new_mask, new_rank, m + 1),
                       stable=True).indices
    m_sorted = order[:t] if t <= m else F.pad(order, (0, t - m))
    fill = want >= 0
    take = torch.where(fill, m_sorted.gather(0, want.clamp_min(0)), 0)
    z = meas.index_select(0, take)

    un0 = z[:, 14] * z[:, 4]
    x0 = F.pad(z[:, 6:14], (0, 1))                               # vel = 0
    a0 = make_transition_matrix(z[:, 12], z[:, 13])
    c0 = make_covariance(LAMBDA_O * (1.0 - un0))
    ids0 = tracks.next_id + torch.where(fill, want.clamp_min(0), 0)
    return tracks.replace(
        valid=tracks.valid | fill,
        ids=torch.where(fill, ids0.to(torch.int32), tracks.ids),
        next_id=tracks.next_id + n_new.to(torch.int32),
        X=torch.where(fill[:, None], x0, tracks.X),
        C=torch.where(fill[:, None, None], c0, tracks.C),
        A=torch.where(fill[:, None, None], a0, tracks.A),
        box2d=torch.where(fill[:, None], z[:, :6], tracks.box2d),
        un=torch.where(fill, un0, tracks.un))


def track_step(tracks: Tracks, meas, meas_valid, pose_dn, p2,
               best_thresh=0.35, apply_pose=True,
               match_dist=MATCH_DIST) -> Tracks:
    """One tracker step: ego-project, forecast, associate, update, spawn.
    The same for every frame (frame 0 starts from empty tracks)."""
    if apply_pose:
        tracks = project_ego(tracks, pose_dn, p2)
    tracks = forecast_tracks(tracks, p2)
    match_t, used_m = associate_tracks(tracks, meas, meas_valid, best_thresh,
                                       match_dist)
    tracks = update_tracks(tracks, meas, meas_valid, match_t)
    return add_unused_measurements(tracks, meas, meas_valid, used_m)


class PoseNet(nn.Module):
    """Spatially attended 6-DoF relative ego pose from a pair of frames'
    trunk features: a 3x3 conv on their channel concatenation, 1x1 pose
    and confidence heads, a softmax over positions, the weighted sum.

    It runs in f32 with autocast off, as the flax module (dtype f32) does
    inside a bf16 model, and with its parameters cast to f32 in an f64
    model, as flax casts them to the module's dtype."""

    def __init__(self, in_features, features=512):
        super().__init__()
        self.pose_feats = nn.Conv2d(in_features, features, 3, padding=1)
        self.pose = nn.Conv2d(features, 6, 1)
        self.conf = nn.Conv2d(features, 1, 1)

    def forward(self, feats_pair):
        """feats_pair [N, 2C, H, W] -> poses [N, 6] f32."""
        def conv(m, x):
            return m._conv_forward(x, m.weight.float(), m.bias.float())

        with torch.autocast(feats_pair.device.type, enabled=False):
            h = F.relu(conv(self.pose_feats, feats_pair.float()))
            n = h.shape[0]
            attn = torch.softmax(conv(self.conf, h).reshape(n, 1, -1), dim=-1)
            return (attn * conv(self.pose, h).reshape(n, 6, -1)).sum(-1)
