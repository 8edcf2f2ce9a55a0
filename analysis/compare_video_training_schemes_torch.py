"""The video stage's two training schemes, measured with the port (the
counterpart of ``analysis/compare_video_training_schemes.py``).

  scheme "direct": L1 on the pose head against the ego-motion labels
                   (``losses/pose.py::pose_loss``, as
                   ``scripts/train_pose_torch.py`` trains it);
  scheme "fused":  no ego labels; the smooth L1 between the Kalman-fused
                   track centres and the current frame's GT centres, the
                   gradient reaching the pose head through ``project_ego``
                   (``losses/fused_track.py::fused_track_loss``, one clip at
                   a time, averaged over the batch).

The synthetic world is the JAX tool's, drawn with the same numpy calls: a
textured background translated each frame by a known forward ego motion,
objects whose camera-frame centres move with it, oracle measurements (GT +
noise) that keep detection quality out of the comparison.  The model is
the same tiny ``VideoRPN3D`` (64x192, F = 3, the tiny DenseNet, 4 anchors,
``prop_features`` 32, ``max_tracks`` 16, ``best_thresh`` 0.35) in eval
mode; Adam at 2e-4 trains ``pose_net`` only, the rest frozen (JAX's
``multi_transform`` with ``set_to_zero``), each scheme on the same batch
sequence from ``seed + 1``.  Held-out metrics over ``n_eval`` clips
through ``video_track``: the pose's tz error, the fused tracks' centre RMSE
and the velocity state's error; the untrained model's too.

Usage:
  python analysis/compare_video_training_schemes_torch.py [--iters 80] \
      [--batch 4] [--out PATH] [--device cuda]

Writes ``analysis/video_scheme_comparison_torch.json`` unless ``--out`` is
given (never the JAX tool's file).  The fused-track loss is a Python loop
of small launches (~9000 a call at the tracker's full slots): expect the
card to wait on the host.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np

H, W, F = 64, 192, 3
FOCAL = 200.0
SHIFT_PER_TZ = 14.0          # pixels of background shift per metre of ego tz


def make_p2():
    p2 = np.eye(4, dtype=np.float32)
    p2[0, 0] = p2[1, 1] = FOCAL
    p2[0, 2], p2[1, 2] = W / 2, H / 2
    return p2


def make_sequence(rng, p2):
    """One clip: images [F, H, W, 3], ego tz, per-frame oracle measurements
    [F, M, 16], current-frame GT centres [G, 3]."""
    tz = float(rng.uniform(0.6, 1.6))
    shift = SHIFT_PER_TZ * tz
    texture = rng.uniform(0, 1, (H, W + int(shift * (F + 1)) + 4, 3))
    images = np.zeros((F, H, W, 3), np.float32)
    for f in range(F):
        off = int(round(shift * (F - 1 - f)))
        images[f] = texture[:, off:off + W]

    g = 2
    centers0 = np.stack([rng.uniform(-4, 4, g), rng.uniform(0.2, 1.0, g),
                         rng.uniform(14, 26, g)], axis=1)
    meas = np.zeros((F, g, 16), np.float32)
    valid = np.ones((F, g), bool)
    centers_f = None
    for f in range(F):
        centers_f = centers0.copy()
        centers_f[:, 2] -= tz * f           # the camera approaches
        noisy = centers_f + rng.normal(0, 0.05, centers_f.shape)
        for gi in range(g):
            x, y, z = noisy[gi]
            w3, h3, l3 = 1.7, 1.5, 4.0
            u = FOCAL * x / z + W / 2
            v = FOCAL * y / z + H / 2
            bw, bh = FOCAL * w3 / z, FOCAL * h3 / z
            meas[f, gi, :6] = [u - bw / 2, v - bh / 2, u + bw / 2,
                               v + bh / 2, 0.9, 1.0]
            meas[f, gi, 6:14] = [x, y, z, w3, h3, l3, 0.1, 0.0]
            meas[f, gi, 14] = 0.9
    ego = np.array([0, 0, tz, 0, 0, 0], np.float32)
    return images, ego, meas, valid, centers_f.astype(np.float32)


def build_batch(rng, n, p2):
    out = [make_sequence(rng, p2) for _ in range(n)]
    return tuple(np.stack([o[i] for o in out]) for i in range(5))


def video_config():
    from groomed_nms_torch.models.densenet import tiny_densenet_config
    from groomed_nms_torch.models.rpn_3d import RPNConfig
    from groomed_nms_torch.models.video import VideoConfig
    return VideoConfig(rpn=RPNConfig(num_classes=4, num_anchors=4,
                                     prop_features=32,
                                     backbone=tiny_densenet_config()),
                       max_tracks=16, best_thresh=0.35)


def run(iters=80, batch=4, seed=0, log=print, schemes=("direct", "fused"),
        n_eval=24, device="cuda", dtype=None, state_dict=None,
        step_losses=None):
    """Train each scheme and evaluate it; returns {scheme: metrics,
    "untrained": metrics}.  ``state_dict`` (None: ``init_weights`` from
    ``seed``) is the model's initial weights, e.g. JAX's through
    ``utils/weights.py::from_flax``; ``dtype`` (None: f32) the model's and
    the tracker's (``PoseNet`` computes in f32).  ``step_losses``, a dict,
    receives each scheme's per-step losses."""
    import torch

    from groomed_nms_torch.losses.fused_track import fused_track_loss
    from groomed_nms_torch.losses.pose import pose_loss
    from groomed_nms_torch.models.video import VideoRPN3D, video_track
    from groomed_nms_torch.utils.weights import init_weights

    device = torch.device(device)
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    p2 = make_p2()
    vcfg = video_config()
    model = VideoRPN3D(vcfg)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model = model.to(device, dtype).eval()
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device, dtype=dt)

    # pose normalisation from a label sample (both schemes share the
    # output parameterisation; the fused scheme never sees the labels)
    sample = np.stack([make_sequence(rng, p2)[1] for _ in range(64)])
    pose_means = sample.mean(0)
    pose_stds = np.maximum(sample.std(0), 1e-3)
    pm, ps = t(pose_means), t(pose_stds)
    p2_t = t(p2)

    def loss_fn(scheme, images, ego, meas, mvalid, gts):
        poses_n = model(images).poses.to(dtype)          # [B, F-1, 6]
        if scheme == "direct":
            tar = ((ego[:, None, :] - pm) / ps).expand_as(poses_n)
            loss, _ = pose_loss(poses_n.reshape(-1, 6), tar.reshape(-1, 6),
                                pm, ps)
            return loss
        poses_dn = torch.cat([poses_n.new_zeros((poses_n.shape[0], 1, 6)),
                              poses_n * ps + pm], dim=1)
        ones = torch.ones(gts.shape[1], dtype=torch.bool, device=device)
        return torch.stack([
            fused_track_loss(poses_dn[b], meas[b], mvalid[b], gts[b], ones,
                             p2_t, vcfg)[0]
            for b in range(poses_dn.shape[0])]).mean()

    def evaluate(n=n_eval):
        ev = np.random.default_rng(seed + 999)
        images, ego, meas, mvalid, gts = build_batch(ev, n, p2)
        with torch.no_grad():
            out = model(t(images).permute(0, 1, 4, 2, 3))
        poses_dn = out.poses.to(dtype).cpu().numpy() * pose_stds + pose_means
        pose_mae = float(np.abs(poses_dn[:, :, 2] - ego[:, None, 2]).mean())
        center_err, vel_err = [], []
        for bi in range(n):
            pd = np.concatenate([np.zeros((1, 6)), poses_dn[bi]], 0)
            with torch.no_grad():
                final, _ = video_track(t(meas[bi]), t(mvalid[bi], torch.bool),
                                       t(pd), p2_t, vcfg)
            X = final.X.cpu().numpy()
            tv = final.valid.cpu().numpy()
            if not tv.any():
                continue
            d = np.linalg.norm(X[tv, None, :3] - gts[bi][None], axis=-1)
            # per-object errors: the RMSE below is then a real RMSE,
            # unskewed by unequal track counts
            center_err.extend(d.min(axis=0).tolist())
            # objects are static in the world: after correct ego
            # compensation the along-heading velocity state is ~0
            vel_err.extend(np.abs(X[tv, 8]).tolist())
        # None (JSON null) when no track survived: NaN is not JSON
        return dict(pose_tz_mae=pose_mae,
                    track_center_rmse=float(np.sqrt(np.mean(
                        np.square(center_err)))) if center_err else None,
                    track_vel_mae=float(np.mean(vel_err))
                    if vel_err else None)

    results = {}
    for scheme in schemes:
        log(f"training scheme: {scheme}")
        model.load_state_dict(init)
        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith("pose_net."))
        opt = torch.optim.Adam(model.pose_net.parameters(), lr=2e-4)
        # the same batch sequence for every scheme, whatever the order
        srng = np.random.default_rng(seed + 1)
        losses = []
        for it in range(iters):
            images, ego, meas, mvalid, gts = build_batch(srng, batch, p2)
            loss = loss_fn(scheme, t(images).permute(0, 1, 4, 2, 3), t(ego),
                           t(meas), t(mvalid, torch.bool), t(gts))
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if (it + 1) % 20 == 0:
                log(f"  [{scheme}] iter {it + 1}: loss "
                    f"{float(losses[-1]):.4f}")
        if step_losses is not None:
            step_losses[scheme] = [float(v) for v in losses]
        results[scheme] = evaluate()
        log(f"  -> {results[scheme]}")
    model.load_state_dict(init)
    results["untrained"] = evaluate()
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-eval", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "video_scheme_comparison_torch.json"))
    return ap.parse_args(argv)


def main(argv=None):
    """Write the results JSON; returns its path."""
    args = parse_args(argv)
    from groomed_nms_torch.utils import measure

    device = measure.tool_device(args.device)
    print(measure.header(device), flush=True)
    t0 = time.perf_counter()
    results = run(iters=args.iters, batch=args.batch, n_eval=args.n_eval,
                  device=device)
    measure.sync(device)
    print(f"{args.iters} steps a scheme, batch {args.batch}, {args.n_eval} "
          f"held-out clips in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2), flush=True)
    return args.out


if __name__ == "__main__":
    main()
