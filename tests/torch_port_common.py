"""Shared fixtures-as-functions for the PyTorch port's differential tests.

One set of flax variables drives both packages: the JAX ``RPN3D`` runs it
directly, the port's ``RPN3D`` loads it through ``utils.weights.from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from groomed_nms_tpu.models import RPN3D as JaxRPN3D, RPNConfig as JaxRPNConfig
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny

from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.rpn_3d import RPN3D, RPNConfig
from groomed_nms_torch.utils.weights import from_flax

TINY = dict(num_classes=4, num_anchors=6, prop_features=64)


def _perturb(tree, rs, path=()):
    """Non-trivial BatchNorm statistics and affine terms, head biases."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(v, rs, path + (k,))
            continue
        v = np.asarray(v)
        if k in ("scale", "var"):
            v = rs.uniform(0.5, 1.5, v.shape)
        elif k in ("mean", "bias"):
            v = rs.normal(0, 0.2, v.shape)
        out[k] = v.astype(np.float32)
    return out


def tiny_models(seed=0, bf16=False, **rpn_kwargs):
    """(jax model, flax variables as numpy trees, torch model in eval mode)
    for the tiny topology; ``rpn_kwargs`` override ``TINY``."""
    kw = {**TINY, **rpn_kwargs}
    jcfg = JaxRPNConfig(backbone=jax_tiny(jnp.bfloat16 if bf16 else
                                          jnp.float32), **kw)
    jmodel = JaxRPN3D(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 64, 64, 3), jnp.float32))
    rs = np.random.default_rng(seed)
    params = _perturb(variables["params"], rs)
    stats = _perturb(variables["batch_stats"], rs)
    tmodel = RPN3D(RPNConfig(backbone=tiny_densenet_config(), **kw))
    tmodel.load_state_dict(from_flax(params, stats))
    tmodel.eval()
    return jmodel, {"params": params, "batch_stats": stats}, tmodel


def jax_apply(jmodel, variables, images):
    """Jitted eval-mode forward: one compile instead of op-by-op dispatch."""
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(images))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
