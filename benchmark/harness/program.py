"""The program under test, built for a configuration: its experiment
config and its model on the card with the benchmark's weights."""

from __future__ import annotations


def experiment(cfg):
    """The port's ``ExperimentConfig`` from the configuration's file."""
    from groomed_nms_torch.config import ExperimentConfig
    return ExperimentConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg["experiment"].items()})


def model(torch, cfg, ecfg, ref, seed, device):
    """``RPN3D`` of the configuration, channels-last on ``device``, loaded
    with the weights the reference makes from ``seed``."""
    from groomed_nms_torch.models.rpn_3d import RPN3D
    m = RPN3D(ecfg.rpn_config(cfg["model"]["num_anchors"]))
    check_backbone(m, cfg)
    m = m.to(device, memory_format=torch.channels_last)
    m.load_state_dict(ref.make_weights(ref.param_spec(cfg), seed, device))
    return m


def check_backbone(model, cfg):
    """The program's trunk has the configuration's topology."""
    bb, want = model.config.backbone, cfg["model"]["backbone"]
    got = {"growth_rate": bb.growth_rate, "block_layers": list(bb.block_layers),
           "stem_features": bb.stem_features, "bn_size": bb.bn_size,
           "block_dilations": list(bb.block_dilations),
           "transition_pool": list(bb.transition_pool)}
    for k, v in got.items():
        if want[k] != v:
            raise ValueError(f"the program's backbone has {k}={v}, the "
                             f"configuration states {want[k]}")
