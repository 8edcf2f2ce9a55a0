"""Load the reference implementation's PyTorch RPN weights into the port.

The logic of ``groomed_nms_tpu/utils/torch_weights.py::convert_rpn_checkpoint``
with no flax tree in between: a reference ``state_dict`` (torchvision
DenseNet-121 ``features`` under ``base.``, the ``prop_feats`` conv, 14
separate 1x1 head convs and the acceptance branch) becomes this package's
``RPN3D`` ``state_dict``.

* ``base.*`` maps onto ``backbone.*`` by name (``denseblock{b}.denselayer
  {l}`` -> ``denseblock{b}_layer{l}``); both sides are OIHW, so tensors are
  copied as they are.  BatchNorm step counters restart at 0.
* The head convs are scattered into the one fused head: the reference's
  class channel ``class * A + anchor`` and per-anchor field channels go to
  ``anchor * per + field``, and the single ``bbox_alpha`` conv fills both
  rsin and rcos (the reference decodes both from it).
* ``acceptance_prob.layer_<i>`` maps onto ``accept_<i>``, the last layer
  onto ``accept_out``.
* ``predict_uncertainty`` is checked against the presence of ``bbox_un``.

``module.`` prefixes (DataParallel) are stripped.  The velocity channel of
the video model waits for the video slice.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_DENSE_RE = re.compile(r"denseblock(\d+)\.denselayer(\d+)\.(.+)")
_BACKBONE_RE = re.compile(
    r"(conv0|norm0|norm5|transition\d+\.(norm|conv))\.(.+)")
_ACCEPT_RE = re.compile(r"acceptance_prob\.layer_(\d+)\.(weight|bias)")
_FIELDS_2D = ("bbox_x", "bbox_y", "bbox_w", "bbox_h")
_FIELDS_3D = ("bbox_x3d", "bbox_y3d", "bbox_z3d", "bbox_w3d", "bbox_h3d",
              "bbox_l3d")


def _tensor(v):
    return torch.from_numpy(np.array(v, np.float32))


def _strip(sd):
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def convert_backbone(sd):
    """torchvision ``features`` state dict -> ``backbone.*`` entries."""
    out = OrderedDict()
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        m = _DENSE_RE.fullmatch(key)
        if m:
            name = f"denseblock{m.group(1)}_layer{m.group(2)}.{m.group(3)}"
        elif _BACKBONE_RE.fullmatch(key):
            name = key
        else:
            raise KeyError(f"unexpected backbone tensor base.{key}")
        out[f"backbone.{name}"] = _tensor(v)
        if name.endswith(".running_var"):
            out[f"backbone.{name[:-len('running_var')]}num_batches_tracked"] \
                = torch.zeros((), dtype=torch.long)
    return out


def convert_rpn_checkpoint(sd, num_classes, num_anchors,
                           predict_acceptance_prob=False,
                           predict_uncertainty=None):
    """Reference RPN state dict (numpy arrays or tensors) -> this package's
    ``RPN3D`` state dict.  ``predict_uncertainty`` None follows the
    checkpoint; a value that contradicts it raises ``ValueError``."""
    sd = {k: np.asarray(v) for k, v in _strip(sd).items()}
    has_un = "bbox_un.weight" in sd
    if predict_uncertainty is None:
        predict_uncertainty = has_un
    if predict_uncertainty != has_un:
        raise ValueError(
            f"predict_uncertainty={predict_uncertainty} but the checkpoint "
            f"{'has' if has_un else 'lacks'} bbox_un weights -- converting "
            "would silently drop or randomize the uncertainty head")
    out = convert_backbone({k[len("base."):]: v for k, v in sd.items()
                            if k.startswith("base.")})
    out["prop_feats.weight"] = _tensor(sd["prop_feats.0.weight"])
    out["prop_feats.bias"] = _tensor(sd["prop_feats.0.bias"])

    a, c = num_anchors, num_classes
    per = c + 4 + 10 + (1 if predict_uncertainty else 0)
    in_ch = sd["cls.weight"].shape[1]
    weight = np.zeros((a * per, in_ch), np.float32)
    bias = np.zeros((a * per,), np.float32)

    def put(field, name, stride=1):
        """Reference conv ``name`` (``stride`` channels an anchor, anchor
        ``ai``'s channel ``k`` at ``k * A + ai``) -> fused channels."""
        w, b = sd[name + ".weight"][:, :, 0, 0], sd[name + ".bias"]
        for ai in range(a):
            for k in range(stride):
                weight[ai * per + field + k] = w[k * a + ai]
                bias[ai * per + field + k] = b[k * a + ai]

    put(0, "cls", stride=c)
    for i, name in enumerate(_FIELDS_2D + _FIELDS_3D):
        put(c + i, name)
    put(c + 10, "bbox_alpha")                 # rsin
    put(c + 11, "bbox_alpha")                 # rcos
    put(c + 12, "bbox_axis")
    put(c + 13, "bbox_head")
    if predict_uncertainty:
        put(c + 14, "bbox_un")
    out["head.weight"] = torch.from_numpy(weight[:, :, None, None].copy())
    out["head.bias"] = torch.from_numpy(bias)

    if predict_acceptance_prob:
        layers = sorted(int(m.group(1)) for k in sd
                        for m in [_ACCEPT_RE.fullmatch(k)]
                        if m and m.group(2) == "weight")
        for li in layers:
            name = "accept_out" if li == layers[-1] else f"accept_{li}"
            out[f"{name}.weight"] = _tensor(
                sd[f"acceptance_prob.layer_{li}.weight"])
            out[f"{name}.bias"] = _tensor(
                sd[f"acceptance_prob.layer_{li}.bias"])
    return out
