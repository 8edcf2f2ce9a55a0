"""Weights for the PyTorch modules: the flax bridge and seeded random init.

``from_flax`` maps a flax variables tree of ``groomed_nms_tpu``'s ``RPN3D``
(numpy arrays, nested dicts) onto this package's ``state_dict``: the module
names already match, conv kernels go HWIO -> OIHW, BatchNorm ``scale``/
``bias``/``mean``/``var`` become ``weight``/``bias``/``running_mean``/
``running_var`` (both sides use eps 1e-5).  It is the bridge the tests use
to run one set of weights through both packages.  ``flax_names`` is the
same map read the other way: each ``state_dict`` key's flax path, which is
what the freezing rules (``training/freeze.py``) match the config's strings
against.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):                 # dict or flax FrozenDict
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_flax(params, batch_stats=None):
    """flax ``params`` / ``batch_stats`` trees -> a torch ``state_dict``."""
    sd = OrderedDict()
    for path, v in _flatten(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            sd[f"{mod}.weight"] = torch.from_numpy(
                np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
        elif leaf == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(v.copy())
        elif leaf == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(v.copy())
        else:
            raise KeyError(f"unexpected flax param {'/'.join(path)}")
    for path, v in _flatten(batch_stats or {}):
        mod, leaf = ".".join(path[:-1]), path[-1]
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[f"{mod}.{name}"] = torch.from_numpy(v.copy())
        sd[f"{mod}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


_FLAX_LEAF = {
    nn.Conv2d: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    nn.BatchNorm2d: {"weight": ("params", "scale"),
                     "bias": ("params", "bias"),
                     "running_mean": ("batch_stats", "mean"),
                     "running_var": ("batch_stats", "var")},
}


def flax_names(model: nn.Module):
    """{state_dict key: (collection, flax path)} for the keys ``from_flax``
    writes: ``backbone.denseblock1_layer1.norm1.weight`` ->
    ("params", "backbone/denseblock1_layer1/norm1/scale"),
    ``...running_mean`` -> ("batch_stats", ".../mean").  BatchNorm's
    ``num_batches_tracked`` has no flax counterpart and is left out."""
    out = OrderedDict()
    for mod_name, mod in model.named_modules():
        leaves = next((v for k, v in _FLAX_LEAF.items()
                       if isinstance(mod, k)), None)
        if leaves is None:
            continue
        prefix = mod_name.replace(".", "/")
        for name, _ in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            if name in leaves:
                coll, leaf = leaves[name]
                out[f"{mod_name}.{name}"] = (coll, f"{prefix}/{leaf}")
    return out


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded random weights, as flax initialises the JAX model: conv
    kernels ~ N(0, 1/fan_in) (LeCun normal), conv biases 0, BatchNorm the
    identity (weight 1, bias 0, running mean 0, running var 1).

    The numbers come from ``generator`` on the CPU and are then copied to
    each parameter's device, so a seed gives the same weights everywhere.
    """
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
