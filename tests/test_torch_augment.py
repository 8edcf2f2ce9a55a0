"""Photometric jitter in training, JAX vs the PyTorch port, on the CPU:
``photometric_distort``, ``preprocess_images_train``, the step-keyed draws
of ``fuse_preprocess`` and two train steps of the tiny model with jitter.

The port cannot reproduce threefry, so each JAX comparison feeds the port
JAX's own draws, taken from the same key through the same splits
(``jax_draws``).  Tolerances: ``photometric_distort`` and
``preprocess_images_train`` within 1e-4 on the 0-255 scale (f32; the means
and the resize summed in other orders); ``distort_prob <= 0`` bit-identical
to ``preprocess_images``; the two train steps in f64 at
``test_torch_training.py``'s step rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.data import augment as jax_augment
from groomed_nms_tpu.losses.rpn_3d import UncertaintyState as JaxUnState
from groomed_nms_tpu.models import RPN3D as JaxRPN3D, RPNConfig as JaxRPNConfig
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny
from groomed_nms_tpu.config import load_config as jax_load_config
from groomed_nms_tpu.training import build_lr_schedule as jax_schedule
from groomed_nms_tpu.training import build_optimizer as jax_optimizer
from groomed_nms_tpu.training import make_train_step as jax_make_train_step
from groomed_nms_tpu.training.trainer import TrainState as JaxTrainState
from groomed_nms_tpu.training.trainer import fuse_preprocess as jax_fuse

from groomed_nms_torch.config import load_config
from groomed_nms_torch.data import augment
from groomed_nms_torch.data.augment import PhotometricDraws
from groomed_nms_torch.losses.rpn_3d import UncertaintyState
from groomed_nms_torch.training import trainer
from groomed_nms_torch.training.schedules import build_lr_schedule
from groomed_nms_torch.training.trainer import (TrainState, build_optimizer,
                                                fuse_preprocess, jitter_draws,
                                                make_train_step)
from groomed_nms_torch.utils.weights import from_flax
from test_torch_loss import _gt_batch, _rois
from test_torch_training import STEP_PARAM_REL, STEP_STATS_ATOL, \
    STEP_STATS_RTOL
from torch_port_common import TINY, tiny_models

MEANS = np.array([0.485, 0.456, 0.406], np.float32)
STDS = np.array([0.229, 0.224, 0.225], np.float32)
ATOL_255 = 1e-4                       # on the 0-255 scale


def jax_draws(key, b, distort_prob):
    """JAX's draws for ``preprocess_images_train(key)``: ``kd, kp =
    split(key)``, the apply mask from ``kp``, then ``kb, kc, ks = split(kd,
    3)`` and each factor uniform in [0.8, 1.2], as ``PhotometricDraws``."""
    kd, kp = jax.random.split(key)
    apply = jax.random.uniform(kp, (b,)) <= distort_prob
    fs = [jax.random.uniform(k, (b, 1, 1, 1), minval=0.8, maxval=1.2)
          for k in jax.random.split(kd, 3)]
    return PhotometricDraws(torch.from_numpy(np.array(apply)),
                            *(torch.from_numpy(np.array(f).reshape(b))
                              for f in fs))


def _frames(seed, b=4, h=48, w=160):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                np.uint8)


def _to_255(x):
    """Normalised NCHW output -> NHWC on the 0-255 scale, f64."""
    x = np.asarray(x, np.float64)
    if x.shape[1] == 3:
        x = x.transpose(0, 2, 3, 1)
    return (x * STDS + MEANS) * 255.0


def test_photometric_distort_matches_jax():
    u8 = _frames(0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_augment.photometric_distort(
        key, jnp.asarray(u8, jnp.float32)))
    # photometric_distort(key) splits ``key`` itself into kb, kc, ks
    fs = [jax.random.uniform(k, (4, 1, 1, 1), minval=0.8, maxval=1.2)
          for k in jax.random.split(key, 3)]
    f_b, f_c, f_s = (torch.from_numpy(np.array(f).reshape(4)) for f in fs)
    got = augment.photometric_distort(
        torch.from_numpy(u8).permute(0, 3, 1, 2).float(), f_b, f_c, f_s)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= ATOL_255
    assert (got == 0).any() and (got == 255).any(), "the clip is not reached"
    assert not np.allclose(got, u8), "nothing jittered"


@pytest.mark.parametrize("shape,target,distort_prob", [
    ((4, 48, 160, 3), (64, 224), 0.5),         # upsampled, crop
    ((3, 96, 320, 3), (64, 224), 1.0),         # shrunk, pad
    ((2, 72, 240, 3), (96, 320), 0.3)])
def test_preprocess_images_train_matches_jax(shape, target, distort_prob):
    """Flip, jitter of the images the draws pick, resize, normalise: JAX's
    ``preprocess_images_train`` from a key against the port's from that
    key's draws, within ATOL_255 beyond ``preprocess_images``' own distance
    from JAX's at the shape.  That distance is ~2e-5 when the resize
    enlarges (as 375 -> 512 rows does in training) and 1.2e-3 when it
    shrinks: the antialiased resize's roundings, with or without jitter."""
    b = shape[0]
    u8 = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    mirror = np.arange(b) % 2 == 0
    key = jax.random.PRNGKey(3)       # picks some images and not others
    draws = jax_draws(key, b, distort_prob)
    assert draws.apply.any(), "no image jittered: the test checks nothing"
    want = np.asarray(jax_augment.preprocess_images_train(
        jnp.asarray(u8), jnp.asarray(mirror), MEANS, STDS, key,
        target_h=target[0], crop_w=target[1], distort_prob=distort_prob))
    got = augment.preprocess_images_train(
        torch.from_numpy(u8), torch.from_numpy(mirror), MEANS, STDS, draws,
        target_h=target[0], crop_w=target[1], distort_prob=distort_prob)
    assert got.shape == (b, 3, *target)
    assert got.is_contiguous(memory_format=torch.channels_last)
    plain = augment.preprocess_images(
        torch.from_numpy(u8), torch.from_numpy(mirror), MEANS, STDS,
        target_h=target[0], crop_w=target[1])
    own = np.abs(_to_255(plain.numpy()) - _to_255(
        jax_augment.preprocess_images(
            jnp.asarray(u8), jnp.asarray(mirror), MEANS, STDS,
            target_h=target[0], crop_w=target[1]))).max()
    err = np.abs(_to_255(got.numpy()) - _to_255(want)).max()
    print(f"max err on the 0-255 scale: {err:.3e} (preprocess_images' own "
          f"{own:.3e})")
    assert err <= own + ATOL_255
    jittered = ~torch.isclose(got, plain).flatten(1).all(1)
    assert torch.equal(jittered, draws.apply)


@pytest.mark.parametrize("distort_prob", [0.0, -1.0])
def test_no_jitter_is_preprocess_images_bit_for_bit(distort_prob):
    u8 = torch.from_numpy(_frames(2))
    mirror = torch.tensor([True, False, True, True])
    want = augment.preprocess_images(u8, mirror, MEANS, STDS, target_h=64,
                                     crop_w=224, out_dtype=torch.bfloat16)
    got = augment.preprocess_images_train(
        u8, mirror, MEANS, STDS, None, target_h=64, crop_w=224,
        distort_prob=distort_prob, out_dtype=torch.bfloat16)
    assert torch.equal(got, want)


def _recording_step(seen):
    def step(state, batch):
        seen.append(batch["images"])
        state.step += 1
        return {}
    return step


class _State:
    def __init__(self, step=0):
        self.step = step


def test_jitter_draws_are_keyed_by_the_step_and_survive_a_resume():
    """The draws of a step depend on the seed and the step alone: a run
    resumed at step 2 sees at steps 2-3 the images of an uninterrupted run,
    and other steps or seeds draw otherwise."""
    d = [jitter_draws(5, s, 8, 0.5) for s in range(3)]
    again = jitter_draws(5, 1, 8, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(d[1], again))
    assert not torch.equal(d[0].f_b, d[1].f_b)
    assert not torch.equal(jitter_draws(6, 1, 8, 0.5).f_b, d[1].f_b)
    assert ((d[0].f_b >= 0.8) & (d[0].f_b <= 1.2)).all()
    assert 0 < int(torch.cat([x.apply for x in d]).sum()) < 24

    u8 = torch.from_numpy(_frames(3))
    raw = {"images_u8": u8, "mirror": torch.zeros(4, dtype=torch.bool)}

    def run(start, n):
        seen = []
        fused = fuse_preprocess(_recording_step(seen), MEANS, STDS,
                                target_h=64, crop_w=224, distort_prob=0.5,
                                rng_seed=5)
        state = _State(start)
        for _ in range(n):
            fused(state, raw)
        return seen

    whole, resumed = run(0, 4), run(2, 2)
    assert torch.equal(whole[2], resumed[0])
    assert torch.equal(whole[3], resumed[1])
    assert not torch.equal(whole[0], whole[1])


def test_fuse_preprocess_jitters_frames_but_not_clips():
    """Still frames are jittered when ``distort_prob > 0``; clips are not
    (JAX checks ``video`` first)."""
    u8 = torch.from_numpy(_frames(4))
    raw = {"images_u8": u8, "mirror": torch.tensor([True, False] * 2)}
    out = {}
    for p in (1.0, -1.0):
        seen = []
        fuse_preprocess(_recording_step(seen), MEANS, STDS, target_h=64,
                        crop_w=224, distort_prob=p)(_State(), raw)
        out[p] = seen[0]
    assert not torch.isclose(out[1.0], out[-1.0]).flatten(1).all(1).any()
    clips = {"images_u8": u8.reshape(2, 2, *u8.shape[1:]),
             "mirror": torch.tensor([True, False])}
    for p in (1.0, -1.0):
        seen = []
        fuse_preprocess(_recording_step(seen), MEANS, STDS, target_h=64,
                        crop_w=224, distort_prob=p, video=True)(_State(),
                                                                clips)
        out[p] = seen[0]
    assert torch.equal(out[1.0], out[-1.0])


def test_two_train_steps_with_jitter_match_jax_in_f64(monkeypatch):
    """``distort_prob = 1.0``: JAX's ``fuse_preprocess`` (draws from
    ``fold_in(PRNGKey(rng_seed + 1), step)``) -> ``make_train_step``
    against the port's ``fuse_preprocess`` fed those draws (in place of
    ``jitter_draws``) -> ``make_train_step``, two steps of the tiny model
    in f64 with the groomed_nms loss: stats and every tensor at the step
    rules."""
    seed, b = 7, 2
    _, variables, tmodel = tiny_models(seed=5, predict_acceptance_prob=True)
    variables["params"]["head"]["kernel"] *= np.float32(0.1)
    tmodel.load_state_dict(from_flax(variables["params"],
                                     variables["batch_stats"]))
    tmodel.double()
    rois, rois_3d = _rois()
    gt = _gt_batch(7)
    u8 = _frames(5, b=b, h=48, w=96)
    mirror = np.array([True, False])
    means, stds = np.zeros(13, np.float32), np.ones(13, np.float32)
    sched = (0.01, 100)
    loss_cfg = "groomed_nms"

    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.asarray(a).dtype == np.float32 else jnp.asarray(a), t)
        jmodel = JaxRPN3D(JaxRPNConfig(backbone=jax_tiny(jnp.float64),
                                       **TINY, predict_acceptance_prob=True))
        tx = jax_optimizer("sgd", jax_schedule(*sched))
        params = cast(variables["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=cast(variables["batch_stats"]),
            opt_state=tx.init(params), un_state=cast(JaxUnState.init()),
            tx=tx, apply_fn=jmodel.apply)
        jstep = jax.jit(jax_fuse(
            jax_make_train_step(jax_load_config(loss_cfg).loss_config(),
                                cast(rois), cast(rois_3d), cast(means),
                                cast(stds)),
            cast(MEANS), cast(STDS), target_h=64, crop_w=128,
            distort_prob=1.0, rng_seed=seed))
        raw = dict(images_u8=jnp.asarray(u8), mirror=jnp.asarray(mirror),
                   **cast(gt))
        ref, draws = [], []
        base = jax.random.PRNGKey(seed + 1)
        for s in range(2):
            draws.append(jax_draws(jax.random.fold_in(base, s), b, 1.0))
            state, stats = jstep(state, raw)
            np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
            ref.append((from_flax(np_tree(state.params),
                                  np_tree(state.batch_stats)),
                        {k: float(v) for k, v in stats.items()}))
    assert all(d.f_b.dtype == torch.float64 for d in draws)

    f64 = lambda a: torch.from_numpy(np.asarray(a)).double() \
        if np.asarray(a).dtype.kind == "f" else torch.from_numpy(a)
    tstate = TrainState(tmodel, build_optimizer(
        tmodel.parameters(), "sgd", build_lr_schedule(*sched)),
        UncertaintyState.init())
    monkeypatch.setattr(trainer, "jitter_draws",
                        lambda rng_seed, step, n, p: draws[step])
    tstep = fuse_preprocess(
        make_train_step(load_config(loss_cfg).loss_config(), f64(rois),
                        f64(rois_3d), f64(means), f64(stds)),
        torch.from_numpy(MEANS), torch.from_numpy(STDS), target_h=64,
        crop_w=128, distort_prob=1.0, rng_seed=seed,
        out_dtype=torch.float64)
    traw = {"images_u8": torch.from_numpy(u8),
            "mirror": torch.from_numpy(mirror),
            **{k: f64(v) for k, v in gt.items()}}
    for step, (params, jstats) in enumerate(ref):
        tstats = {k: float(v) for k, v in tstep(tstate, traw).items()}
        assert set(tstats) == set(jstats) and jstats["fg_num"] > 0
        for k in jstats:
            np.testing.assert_allclose(tstats[k], jstats[k],
                                       rtol=STEP_STATS_RTOL,
                                       atol=STEP_STATS_ATOL,
                                       err_msg=f"step {step}: {k}")
        got = tmodel.state_dict()
        for k, r in params.items():
            if k.endswith("num_batches_tracked"):
                continue
            err = (got[k] - r.double()).abs().max().item()
            assert err <= STEP_PARAM_REL * r.abs().max().item(), \
                f"step {step}: {k} off f64 by {err:.3e}"
