"""Host ms from the start of a batch's submission (its frames' copy
enqueued) to the return of ``infer``: the serving entry's launch cost.
Median over the window's batches."""

import statistics


def read(r):
    v = r.get("enqueue_s")
    return statistics.median(v) * 1e3 if v else None
