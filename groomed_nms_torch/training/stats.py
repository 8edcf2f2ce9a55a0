"""The train loop's log line, its metrics file and debugging summaries
(counterpart of ``groomed_nms_tpu/training/stats.py``).

``StatTracker.update`` keeps each step's stats as they come (0-dim tensors
on the device, or host floats) and never reads one back: ``means()`` copies
the whole display window to the host in one ``torch.stack(...).cpu()``, so
the host does not wait on the card every step.  The log line and the CSV
rows are the JAX package's, character for character.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

import numpy as np
import torch


class StatTracker:
    def __init__(self, max_iter, display=100, start_iter=0):
        self.max_iter = max_iter
        self.display = display
        # dt and the ETA measure this process's progress: a resumed run
        # starts its clock at start_iter
        self.start_iter = start_iter
        self.start = time.time()
        self.reset()

    def reset(self):
        self._pending = defaultdict(list)

    def update(self, stats: dict):
        for k, v in stats.items():
            self._pending[k].append(v)

    def means(self):
        """{key: mean over the window} in f64, one device-to-host copy for
        every tensor of the window."""
        tensors = [v for vs in self._pending.values() for v in vs
                   if isinstance(v, torch.Tensor)]
        host = iter(torch.stack([t.detach().reshape(()).to(torch.float64)
                                 for t in tensors]).cpu().numpy()) \
            if tensors else iter(())
        out = {}
        for k, vs in self._pending.items():
            vals = [next(host) if isinstance(v, torch.Tensor)
                    else np.float64(v) for v in vs]
            out[k] = float(np.mean(np.asarray(vals, np.float64))) \
                if vals else 0.0
        return out

    def log_line_and_means(self, iteration, lr=None):
        """One means() pull shared by the log line and the CSV row."""
        means = self.means()
        return self._render(iteration, means, lr), means

    def eta(self, iteration):
        done = max(iteration - self.start_iter, 1)
        dt = (time.time() - self.start) / done
        remaining = dt * (self.max_iter - iteration)
        h, rem = divmod(int(remaining), 3600)
        m, s = divmod(rem, 60)
        return f"{h}h{m}m{s}s", dt

    def log_line(self, iteration, lr=None):
        return self._render(iteration, self.means(), lr)

    def _render(self, iteration, means, lr=None):
        eta, dt = self.eta(iteration)
        parts = [f"iter: {iteration}"]
        for k in sorted(means):
            parts.append(f"{k}: {means[k]:.4f}")
        if lr is not None:
            parts.append(f"lr: {lr:.6f}")
        parts.append(f"dt: {dt:.3f}")
        parts.append(f"eta: {eta}")
        return ", ".join(parts)


def param_summary(model, with_grads=False):
    """One line per parameter: its name, shape and mean (and mean |grad|
    where it has a gradient)."""
    lines = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            line = f"{name}: shape={tuple(p.shape)} " \
                   f"mean={p.float().mean().item():+.5f}"
            if with_grads and p.grad is not None:
                line += f" |grad|={p.grad.float().abs().mean().item():.6f}"
            lines.append(line)
    return lines


def live_buffer_stats(device=None):
    """Device memory held by PyTorch's allocator: {"bytes", "peak_bytes"}
    (``torch.cuda.memory_allocated`` / ``max_memory_allocated``); zeros
    without CUDA."""
    if not torch.cuda.is_available():
        return {"bytes": 0, "peak_bytes": 0}
    return {"bytes": torch.cuda.memory_allocated(device),
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


class MetricsCSV:
    """Append-only CSV of the display windows' means."""

    def __init__(self, path):
        self.path = path
        self._keys = None

    def append(self, iteration, stats: dict):
        keys = sorted(stats)
        if self._keys is None:
            if os.path.exists(self.path):
                with open(self.path) as f:
                    header = f.readline().strip().split(",")
                if header[:1] == ["iter"] and header[1:] == keys:
                    self._keys = keys   # resuming with the same stat set
                else:
                    # another stat set: rotate the old file so rows never
                    # sit under a header of other columns
                    n = 1
                    while os.path.exists(f"{self.path}.{n}"):
                        n += 1
                    os.replace(self.path, f"{self.path}.{n}")
            if self._keys is None:
                self._keys = keys
                with open(self.path, "w") as f:
                    f.write("iter," + ",".join(keys) + "\n")
        with open(self.path, "a") as f:
            # the header's columns; a key missing from this window is left
            # empty, a key the header lacks is dropped
            row = ",".join(f"{float(stats[k]):.6f}" if k in stats else ""
                           for k in self._keys)
            f.write(f"{iteration},{row}\n")
