"""Write the PyTorch port's checkpoint format from other weights.

  python scripts/torch_checkpoint.py from-jax --config groomed_nms \
      --output output [--step N] [--num-anchors A]
  python scripts/torch_checkpoint.py from-pth --pth model_50000_pkl \
      --config groomed_nms --num-anchors 36 --output output [--step 0]

``from-jax`` restores an Orbax snapshot of the JAX package
(``output/<name>/weights/checkpoint_<step>/``) and maps its weights with
``groomed_nms_torch.utils.weights.from_flax``; ``from-pth`` maps a reference
PyTorch RPN ``state_dict`` with
``groomed_nms_torch.utils.torch_weights.convert_rpn_checkpoint``.  Both load
the result into the port's ``RPN3D`` (``VideoRPN3D`` for a ``kalman``
config; every tensor, no extra) and write
``output/<name>/weights/checkpoint_<step>.pt`` (weights only, no optimizer
state), which ``scripts/evaluate_torch.py`` restores.  This maintainer tool
imports JAX for ``from-jax``; the port itself never does.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _num_anchors(cfg, out_dir, given):
    """``--num-anchors``, else the row count of the run's anchors.npz."""
    if given:
        return given
    from groomed_nms_torch.data.pipeline import load_anchors, \
        resolve_stats_dir
    return load_anchors(cfg, resolve_stats_dir(cfg, out_dir))[0].shape[0]


def from_jax(args, cfg, out_dir):
    from groomed_nms_tpu.platform import ensure_requested_platform
    ensure_requested_platform()
    from groomed_nms_tpu.config import load_config as jax_load_config
    from groomed_nms_tpu.models import RPN3D as JaxRPN3D
    from groomed_nms_tpu.models.video import (VideoConfig as JaxVideoConfig,
                                              VideoRPN3D as JaxVideoRPN3D)
    from groomed_nms_tpu.training import (build_lr_schedule, build_optimizer,
                                          create_train_state,
                                          restore_checkpoint)

    from groomed_nms_torch.utils.weights import from_flax

    jcfg = jax_load_config(args.config)
    a = _num_anchors(cfg, out_dir, args.num_anchors)
    tx = build_optimizer(jcfg.solver_type,
                         build_lr_schedule(jcfg.lr, jcfg.max_iter))
    if jcfg.model == "kalman":
        model = JaxVideoRPN3D(JaxVideoConfig(rpn=jcfg.rpn_config(a)))
        shape = (1, max(1, jcfg.video_count), 64, 64, 3)
    else:
        model, shape = JaxRPN3D(jcfg.rpn_config(a)), (1, 64, 64, 3)
    state = create_train_state(model, shape, tx)
    state = restore_checkpoint(out_dir, state, args.step,
                               restore_optimizer=False)
    return a, from_flax(state.params, state.batch_stats), int(state.step)


def from_pth(args, cfg, out_dir):
    import torch

    from groomed_nms_torch.utils.torch_weights import convert_rpn_checkpoint

    if cfg.has_vel:
        raise ValueError("the reference's video model has no .pth loader "
                         "here; convert its JAX checkpoint with from-jax")
    payload = torch.load(args.pth, map_location="cpu", weights_only=True)
    sd = payload.get("state_dict", payload)
    a = _num_anchors(cfg, out_dir, args.num_anchors)
    return a, convert_rpn_checkpoint(
        sd, num_classes=cfg.num_classes, num_anchors=a,
        predict_acceptance_prob=cfg.predict_acceptance_prob,
        predict_uncertainty=cfg.has_un), args.step or 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="source", required=True)
    for name in ("from-jax", "from-pth"):
        p = sub.add_parser(name)
        p.add_argument("--config", required=True)
        p.add_argument("--output", default="output",
                       help="runs root; the run is <output>/<config name>")
        p.add_argument("--step", type=int, default=None,
                       help="from-jax: the Orbax step to read (default "
                            "latest); from-pth: the step to write (0)")
        p.add_argument("--num-anchors", type=int, default=None,
                       help="default: the rows of the run's anchors.npz")
        if name == "from-pth":
            p.add_argument("--pth", required=True,
                           help="reference state_dict file (torch.save)")
    args = ap.parse_args(argv)

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.models.rpn_3d import RPN3D
    from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D
    from groomed_nms_torch.training.checkpoint import save_checkpoint

    cfg = load_config(args.config)
    out_dir = os.path.join(args.output, cfg.name)
    convert = from_jax if args.source == "from-jax" else from_pth
    a, state_dict, step = convert(args, cfg, out_dir)
    model = VideoRPN3D(VideoConfig(rpn=cfg.rpn_config(a))) \
        if cfg.model == "kalman" else RPN3D(cfg.rpn_config(a))
    model.load_state_dict(state_dict)
    path = save_checkpoint(out_dir, model, step=step)
    print("wrote", path)
    return path


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
