"""Experiment configuration loaded from JSON.

The configs are the JSON files under ``groomed_nms_torch/configs/``, one per
experiment name of the repository's ``configs/`` package (ablations
included), written by ``scripts/dump_torch_configs.py``.  ``ExperimentConfig``
has exactly the fields of those files, so every file loads 1:1; the typed
sub-configs for the model, the loss and the detection layers are derived
from it.  Fields the PyTorch package does not read yet (data, the JAX
runtime's remat knobs) are kept so that one file describes the whole
experiment.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .inference import DetectConfig
from .losses.rpn_3d import LossConfig
from .models.densenet import DenseNetConfig, tiny_densenet_config
from .models.rpn_3d import RPNConfig

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


@dataclass(frozen=True)
class ExperimentConfig:
    """Every knob of an experiment; defaults = the shipped GrooMeD-NMS run."""

    name: str = "groomed_nms"
    model: str = "rpn_3d"

    # solver
    solver_type: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 0.0005
    max_iter: int = 50000
    snapshot_iter: int = 10000
    display: int = 100
    do_test: bool = True
    fast_eval: bool = True
    lr: float = 0.004
    lr_policy: str = "poly"
    lr_steps: Optional[Sequence[float]] = None
    lr_target_factor: float = 1e-5
    warmup_iters: int = 0
    batch_skip: int = 1
    grad_clip_value: float = 1.0
    pretrained: Optional[str] = None
    copy_stats: bool = False

    # freezing
    freeze_blacklist: Optional[Sequence[str]] = None
    freeze_whitelist: Optional[Sequence[str]] = None
    freeze_bn: bool = False
    slow_bn: float = 0.0

    # loss
    hard_negatives: bool = True
    focal_loss: float = 0.0
    cls_2d_lambda: float = 1.0
    iou_2d_lambda: float = 1.0
    bbox_2d_lambda: float = 0.0
    bbox_3d_lambda: float = 1.0
    bbox_axis_head_lambda: float = 0.35
    predict_acceptance_prob: bool = True
    acceptance_prob_lambda: float = 0.0
    use_nms_in_loss: bool = True
    diff_nms_temperature: float = 0.1
    diff_nms_pruning_method: str = "linear"
    diff_nms_valid_box_prob_threshold: float = 0.3
    diff_nms_group_boxes: bool = True
    diff_nms_mask_group_boxes: bool = True
    diff_nms_group_size: int = 100
    after_nms_lambda: float = 0.05
    after_nms_loss_mode: str = "rank"
    rank_boxes_of_all_images_at_once: bool = False
    overlap_in_nms: str = "2d"
    best_target_box_beta: float = 0.3
    has_un: bool = False
    bbox_un_lambda: float = 0.0
    bbox_un_dynamic: bool = True
    use_un_for_score: bool = True
    use_acceptance_prob_for_nms: bool = True
    boxes_for_acceptance_prob: str = "foregrounds"
    acceptance_prob_overlap_thres: float = 0.01
    acceptance_prob_mode: str = "likelihood"
    acceptance_prob_classify_bins: int = 2
    acceptance_prob_classify_sort_K: int = 0
    bins_boundary: Sequence[float] = (0.5,)
    use_acceptance_prob_in_regression_loss: bool = True
    weigh_acceptance_prob_regularization: bool = True
    weigh_3D_regression_loss_by_gt_iou3d: bool = False
    rank_with_class_confidence: bool = False
    decomp_alpha: bool = True
    score_thres: float = 0.6
    has_vel: bool = False
    video_count: int = 1
    pose_lambda_t: float = 1.0
    pose_lambda_r: float = 40.0

    rng_seed: int = 5

    # network / image
    image_means: Sequence[float] = (0.485, 0.456, 0.406)
    image_stds: Sequence[float] = (0.229, 0.224, 0.225)
    feat_stride: int = 16
    test_scale: int = 512
    crop_size: Sequence[int] = (512, 1760)
    mirror_prob: float = 0.5
    distort_prob: float = -1.0

    # dataset
    dataset_root: str = "data"
    dataset_train: str = "kitti_split1"
    dataset_test: str = "kitti_split1"
    im_ext: str = ".png"
    use_3d_for_2d: bool = True
    percent_anc_h: Sequence[float] = (0.0625, 0.75)
    min_gt_vis: float = 0.65
    ilbls: Sequence[str] = ("Van", "ignore")
    lbls: Sequence[str] = ("Car", "Pedestrian", "Cyclist")

    # sampling
    batch_size: int = 2
    fg_image_ratio: float = 1.0
    box_samples: float = 0.20
    fg_fraction: float = 0.20
    bg_thresh_lo: float = 0.0
    bg_thresh_hi: float = 0.5
    fg_thresh: float = 0.5
    ign_thresh: float = 0.5
    best_thresh: float = 0.35

    # inference
    nms_topN_pre: int = 3000
    nms_topN_post: int = 40
    nms_thres: float = 0.4
    clip_boxes: bool = False
    use_differentiable_nms_at_test: bool = False
    test_batch_size: int = 8
    eval_single_program: bool = False

    # anchors
    anchor_scales_count: int = 12
    anchor_ratios: Sequence[float] = (0.5, 1.0, 1.5)

    # fixed-shape padding of the JAX training step
    max_gts: int = 64
    max_igns: int = 32
    max_nms_boxes: int = 512
    max_ap_boxes: int = 1024

    # backbone
    backbone_tiny: bool = False
    compute_dtype: str = "float32"            # or "bfloat16" (autocast)
    backbone_remat: object = False

    @property
    def num_classes(self) -> int:
        return len(self.lbls) + 1

    @property
    def min_gt_h(self) -> float:
        return self.test_scale * self.percent_anc_h[0]

    @property
    def max_gt_h(self) -> float:
        return self.test_scale * self.percent_anc_h[1]

    @property
    def anchor_scales(self):
        """Template heights, geometric from ``min_gt_h`` to ``max_gt_h``."""
        base = (self.max_gt_h / self.min_gt_h) ** (
            1.0 / (self.anchor_scales_count - 1))
        return np.array([self.min_gt_h * base ** i
                         for i in range(self.anchor_scales_count)])

    def backbone_config(self) -> DenseNetConfig:
        # torch BatchNorm momentum is the batch weight (0.1 default);
        # slow_bn overrides it, as in the reference
        momentum = self.slow_bn if self.slow_bn else 0.1
        cfg = tiny_densenet_config() if self.backbone_tiny else DenseNetConfig()
        return dataclasses.replace(cfg, bn_momentum=momentum)

    def rpn_config(self, num_anchors: int) -> RPNConfig:
        return RPNConfig(
            num_classes=self.num_classes,
            num_anchors=num_anchors,
            feat_stride=self.feat_stride,
            predict_acceptance_prob=self.predict_acceptance_prob,
            acceptance_prob_mode=self.acceptance_prob_mode,
            acceptance_prob_classify_bins=self.acceptance_prob_classify_bins,
            predict_uncertainty=self.has_un,
            predict_velocity=self.has_vel,
            backbone=self.backbone_config(),
        )

    def loss_config(self) -> LossConfig:
        """Every ``LossConfig`` field is the experiment field of its name."""
        values = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(LossConfig)}
        values["bins_boundary"] = tuple(values["bins_boundary"])
        return LossConfig(**values)

    def detect_config(self) -> DetectConfig:
        return DetectConfig(
            num_classes=self.num_classes,
            nms_topN_pre=self.nms_topN_pre,
            nms_topN_post=self.nms_topN_post,
            nms_thres=self.nms_thres,
            score_thres=self.score_thres,
            clip_boxes=self.clip_boxes,
            use_un_for_score=self.use_un_for_score,
            use_differentiable_nms=self.use_differentiable_nms_at_test,
            diff_nms_pruning_method=self.diff_nms_pruning_method,
            diff_nms_temperature=self.diff_nms_temperature,
            diff_nms_valid_box_prob_threshold=self.diff_nms_valid_box_prob_threshold,
            diff_nms_group_boxes=self.diff_nms_group_boxes,
            diff_nms_mask_group_boxes=self.diff_nms_mask_group_boxes,
            diff_nms_group_size=self.diff_nms_group_size,
            overlap_in_nms=self.overlap_in_nms,
            use_acceptance_prob_for_nms=self.use_acceptance_prob_for_nms,
            decomp_alpha=self.decomp_alpha,
        )

    def dump(self, path):
        """Write every field as JSON (``from_json`` reads it back)."""
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    @classmethod
    def from_json(cls, path) -> "ExperimentConfig":
        """Load a file written by ``ExperimentConfig.dump`` (JSON lists come
        back as tuples; an unknown key raises ``TypeError``)."""
        with open(path) as f:
            raw = json.load(f)
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in raw.items()})


def apply_overrides(cfg: ExperimentConfig,
                    items: Sequence[str]) -> ExperimentConfig:
    """Apply ``key=value`` CLI overrides, parsed as Python literals
    (``--set lr=0.008 --set batch_size=8``; a value that is not a literal is
    kept as a string).  Unknown fields and malformed items raise
    ``ValueError`` with the nearby valid names."""
    import ast
    valid = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    for item in items:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"bad override {item!r}: expected KEY=VALUE")
        if key not in valid:
            near = sorted(v for v in valid if key.split("_")[0] in v)[:5]
            raise ValueError(
                f"unknown config field {key!r}" +
                (f" (did you mean one of {near}?)" if near else ""))
        try:
            updates[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            updates[key] = raw  # bare strings: --set lr_policy=step
    return dataclasses.replace(cfg, **updates)


def config_names():
    """Names of the experiment configs shipped as JSON."""
    return sorted(p.stem for p in CONFIG_DIR.glob("*.json"))


def load_config(name: str) -> ExperimentConfig:
    path = CONFIG_DIR / f"{name}.json"
    if not path.exists():
        raise ValueError(f"unknown config {name!r}; known: {config_names()}")
    return ExperimentConfig.from_json(path)
