"""Device ms from the step's "loss" stage to its end (backward and the optimizer), from CUDA events at
``make_train_step``'s ``on_stage`` hooks.  Median over the window's steps."""

import statistics


def read(r):
    v = r.get("events_ms", {}).get("bwd")
    return statistics.median(v) if v else None
