"""The port's checkpoint format: one ``torch.save`` file per snapshot.

``output/<name>/weights/checkpoint_<step>.pt`` holds ``{"step": int,
"model": state_dict, "optimizer": state_dict or None}`` and is read with
``torch.load(weights_only=True)``.  The file name cannot collide with the
JAX package's Orbax snapshots, which are directories
``weights/checkpoint_<step>/``; each package lists only its own.
``scripts/torch_checkpoint.py`` writes this format from an Orbax snapshot
or from a reference ``.pth``.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"checkpoint_(\d+)\.pt")


def checkpoint_path(output_dir, step):
    return os.path.join(os.path.abspath(output_dir), "weights",
                        f"checkpoint_{int(step)}.pt")


def save_checkpoint(output_dir, model, optimizer=None, step=0):
    """Write ``model``'s (and ``optimizer``'s) state as snapshot ``step``;
    returns the path.  The file appears whole or not at all."""
    path = checkpoint_path(output_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"step": int(step), "model": model.state_dict(),
               "optimizer": optimizer.state_dict() if optimizer is not None
               else None}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(output_dir):
    """The largest step with a port snapshot under ``output_dir``, or None."""
    wdir = os.path.join(output_dir, "weights")
    if not os.path.isdir(wdir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(wdir)
             for m in [_NAME.fullmatch(name)] if m]
    return max(steps) if steps else None


def restore_checkpoint(output_dir, model, optimizer=None, step=None,
                       restore_optimizer=True):
    """Load snapshot ``step`` (None: the latest) into ``model`` (strictly:
    every tensor, no extra) and, when ``restore_optimizer`` and the file
    holds one, into ``optimizer``.  Returns the step."""
    if step is None:
        step = latest_checkpoint(output_dir)
        if step is None:
            raise FileNotFoundError(f"no port checkpoints (weights/"
                                    f"checkpoint_<step>.pt) under "
                                    f"{output_dir}")
    payload = torch.load(checkpoint_path(output_dir, step),
                         map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if restore_optimizer and optimizer is not None \
            and payload["optimizer"] is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return payload["step"]
