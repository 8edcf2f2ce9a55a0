"""The port's checkpoint format: one ``torch.save`` file per snapshot.

``output/<name>/weights/checkpoint_<step>.pt`` holds ``{"step": int,
"model": state_dict, "optimizer": state_dict or None, "un_state": {"lam",
"n"} or None}`` and is read with ``torch.load(weights_only=True)``.  The
file name cannot collide with the JAX package's Orbax snapshots, which are
directories ``weights/checkpoint_<step>/``; each package lists only its own.
``scripts/torch_checkpoint.py`` writes this format from an Orbax snapshot
or from a reference ``.pth``.

A snapshot of another config restores as the reference's ``load_weights``
does (the JAX package's key-intersection restore): where the strict load
fails, each tensor of the model whose ``state_dict`` key and shape the
snapshot shares is copied, the others keep their fresh values, and the
snapshot's tensors without a counterpart are dropped, each case logged.
That is how the paper's second stage starts from the first stage's
weights, which lack the acceptance branch.  An optimizer state that does
not fit (another solver, another list of trainable parameters) is skipped
with a warning and the optimizer keeps its fresh state.
"""

from __future__ import annotations

import logging
import os
import re

import torch

from ..losses.rpn_3d import UncertaintyState
from ..parallel.dist import barrier

_NAME = re.compile(r"checkpoint_(\d+)\.pt")
log = logging.getLogger(__name__)


def checkpoint_path(output_dir, step):
    return os.path.join(os.path.abspath(output_dir), "weights",
                        f"checkpoint_{int(step)}.pt")


def _steps(output_dir):
    wdir = os.path.join(output_dir, "weights")
    if not os.path.isdir(wdir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(wdir)
                  for m in [_NAME.fullmatch(name)] if m)


def save_checkpoint(output_dir, model, optimizer=None, step=0, un_state=None,
                    max_keep=None, dist=None):
    """Write ``model``'s (and ``optimizer``'s, and the self-balancing
    lambda's) state as snapshot ``step``; returns the path.  The file
    appears whole or not at all.  ``max_keep`` keeps only that many of the
    newest snapshots.  Under a process group (``dist``, a
    ``parallel.Dist``) rank 0 writes and every rank returns once it has:
    the ranks hold the same state, and none reads a snapshot before it is
    whole."""
    path = checkpoint_path(output_dir, step)
    if dist is not None and dist.group is not None:
        if dist.rank == 0:
            save_checkpoint(output_dir, model, optimizer, step, un_state,
                            max_keep)
        barrier(dist)
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"step": int(step), "model": model.state_dict(),
               "optimizer": optimizer.state_dict() if optimizer is not None
               else None,
               "un_state": None if un_state is None else
               {"lam": un_state.lam.detach().cpu(),
                "n": un_state.n.detach().cpu()}}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if max_keep:
        for old in _steps(output_dir)[:-max_keep]:
            os.remove(checkpoint_path(output_dir, old))
    return path


def latest_checkpoint(output_dir):
    """The largest step with a port snapshot under ``output_dir``, or None."""
    steps = _steps(output_dir)
    return steps[-1] if steps else None


def read_checkpoint(output_dir, step=None):
    """The payload of snapshot ``step`` (None: the latest) under
    ``output_dir``, on the CPU; ``FileNotFoundError`` when there is none."""
    if step is None:
        step = latest_checkpoint(output_dir)
        if step is None:
            raise FileNotFoundError(f"no port checkpoints (weights/"
                                    f"checkpoint_<step>.pt) under "
                                    f"{output_dir}")
    return torch.load(checkpoint_path(output_dir, step), map_location="cpu",
                      weights_only=True)


def load_weights(model, state_dict):
    """Load ``state_dict`` into ``model``: strictly when their keys and
    shapes agree, else by key intersection (logged).  Returns {"fresh":
    model keys kept at their values, "mismatched": keys of another shape
    (also kept), "dropped": snapshot keys without a counterpart}."""
    own = model.state_dict()
    fresh = [k for k in own if k not in state_dict]
    mismatched = [k for k in own if k in state_dict
                  and state_dict[k].shape != own[k].shape]
    dropped = [k for k in state_dict if k not in own]
    report = {"fresh": fresh, "mismatched": mismatched, "dropped": dropped}
    if not (fresh or mismatched or dropped):
        model.load_state_dict(state_dict)
        return report
    log.warning("the checkpoint's tensors differ from this model's: "
                "key-intersection warm start")
    keep = set(fresh) | set(mismatched)
    model.load_state_dict({k: own[k] if k in keep else state_dict[k]
                           for k in own})
    if fresh:
        log.warning("%d tensors absent from the checkpoint keep their "
                    "fresh init (e.g. %s)", len(fresh), fresh[0])
    if mismatched:
        log.warning("%d tensors kept fresh due to shape mismatch: %s",
                    len(mismatched),
                    [f"{k} {tuple(state_dict[k].shape)}->"
                     f"{tuple(own[k].shape)}" for k in mismatched[:3]])
    if dropped:
        log.warning("%d checkpoint tensors have no counterpart here and "
                    "were dropped (e.g. %s)", len(dropped), dropped[0])
    return report


def _load_optimizer(optimizer, state, where):
    if state is None:
        return "absent"
    try:
        optimizer.load_state_dict(state)
    except (ValueError, KeyError) as e:
        log.warning("the optimizer state in %s does not match this run's "
                    "optimizer (%s); restoring weights only, the optimizer "
                    "starts fresh", where, e)
        return "fresh"
    return "restored"


def restore_checkpoint(output_dir, model, optimizer=None, step=None,
                       restore_optimizer=True):
    """Load snapshot ``step`` (None: the latest) into ``model`` (see
    ``load_weights``) and, when ``restore_optimizer`` and the file holds
    one that fits, into ``optimizer``.  Returns the step."""
    payload = read_checkpoint(output_dir, step)
    load_weights(model, payload["model"])
    if restore_optimizer and optimizer is not None:
        _load_optimizer(optimizer, payload["optimizer"], output_dir)
    return payload["step"]


def restore_train_state(output_dir, state, step=None, restore_optimizer=True):
    """Restore a ``trainer.TrainState`` in place from snapshot ``step``
    (None: the latest): the model, the optimizer (when asked and it fits),
    the self-balancing lambda and the step.  Returns ``load_weights``'
    report with "step" and "optimizer" ("restored", "fresh", "absent" or
    "skipped") added."""
    payload = read_checkpoint(output_dir, step)
    report = load_weights(state.model, payload["model"])
    report["optimizer"] = "skipped"
    if restore_optimizer and state.optimizer is not None:
        report["optimizer"] = _load_optimizer(
            state.optimizer, payload["optimizer"], output_dir)
    un = payload.get("un_state")
    if un is not None:
        device = state.un_state.lam.device
        state.un_state = UncertaintyState(lam=un["lam"].to(device),
                                          n=un["n"].to(device))
    state.step = report["step"] = payload["step"]
    return report
