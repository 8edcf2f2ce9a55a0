"""Device ms from the step's start (the fused preprocess included) to the step's "forward" stage, from CUDA events at
``make_train_step``'s ``on_stage`` hooks.  Median over the window's steps."""

import statistics


def read(r):
    v = r.get("events_ms", {}).get("fwd")
    return statistics.median(v) if v else None
