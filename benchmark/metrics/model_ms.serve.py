"""Device ms of the model's forward (``RPN3D`` over the DenseNet trunk), from
CUDA events in a forward pre-hook and a forward hook the harness registers
on the model.  Median over the window's batches."""

import statistics


def read(r):
    v = r.get("events_ms", {}).get("model")
    return statistics.median(v) if v else None
