"""Layer freezing by name substring (counterpart of
``groomed_nms_tpu/training/freeze.py``).

The config's strings match the JAX package's flax paths
(``backbone/denseblock1_layer1/norm1/scale``, ``head/kernel``,
``.../norm1/mean``), so one config freezes the same tensors in both
packages: every rule here reads a tensor's flax path through
``utils/weights.py::flax_names``, never its torch name.

* ``build_freeze_labels``: "freeze" / "train" per parameter.  The
  reference's knobs are inverted: ``freeze_blacklist`` freezes every
  parameter matching NONE of its strings (a train whitelist),
  ``freeze_whitelist`` freezes the matching ones, ``freeze_bn`` freezes
  every BatchNorm scale and bias.  A frozen parameter gets no update at all
  (no momentum, no decay): ``apply_freeze`` turns its gradient off and
  leaves it out of the optimizer.
* ``frozen_stats_mask``: True per BatchNorm running statistic that the
  reference's per-module ``eval()`` stops updating; ``all_stats_frozen``:
  every one of them, when the train step runs BatchNorm in eval mode
  (``make_train_step(train_bn=False)``), else it keeps the frozen ones
  unchanged through a step (``frozen_stats``).
* ``slow_bn`` is BatchNorm's momentum (the batch's weight in the running
  statistics), set by ``config.ExperimentConfig.backbone_config``.
"""

from __future__ import annotations

from ..utils.weights import flax_names


def _is_bn_affine(path):
    return "norm" in path and ("scale" in path or "bias" in path)


def _frozen_by_lists(path, freeze_blacklist, freeze_whitelist):
    if freeze_blacklist is not None and \
            not any(s in path for s in freeze_blacklist):
        return True
    return freeze_whitelist is not None and \
        any(s in path for s in freeze_whitelist)


def build_freeze_labels(model, freeze_blacklist=None, freeze_whitelist=None,
                        freeze_bn=False):
    """{parameter name: "freeze" | "train"} for every parameter of
    ``model``."""
    names = flax_names(model)
    labels = {}
    for key, _ in model.named_parameters():
        path = names[key][1]
        frozen = (freeze_bn and _is_bn_affine(path)) or \
            _frozen_by_lists(path, freeze_blacklist, freeze_whitelist)
        labels[key] = "freeze" if frozen else "train"
    return labels


def frozen_stats_mask(model, freeze_blacklist=None, freeze_whitelist=None,
                      freeze_bn=False):
    """{running_mean / running_var buffer name: frozen} for every
    BatchNorm statistic of ``model``."""
    return {key: bool(freeze_bn) or _frozen_by_lists(
                path, freeze_blacklist, freeze_whitelist)
            for key, (coll, path) in flax_names(model).items()
            if coll == "batch_stats"}


def all_stats_frozen(mask) -> bool:
    """True when the mask has statistics and every one is frozen."""
    return bool(mask) and all(mask.values())


def apply_freeze(model, labels):
    """Turn the gradient of the frozen parameters off; returns the
    trainable ones, in ``model.parameters()`` order, for the optimizer."""
    trainable = []
    for key, p in model.named_parameters():
        frozen = labels[key] == "freeze"
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable
