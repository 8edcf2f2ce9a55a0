"""Device ms from the step's "forward" stage to its "loss" stage, from CUDA events at
``make_train_step``'s ``on_stage`` hooks.  Median over the window's steps."""

import statistics


def read(r):
    v = r.get("events_ms", {}).get("loss")
    return statistics.median(v) if v else None
