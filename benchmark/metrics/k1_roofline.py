"""K1's share of its roofline: the least time of its work at the cell's
shapes (``work/k1.py``) over its mean kernel time in the trace, in percent."""

KERNELS = ("head_scores",)


def read(r):
    t = r.get("trace")
    if not t:
        return None
    ds = [e - s for n, s, e in t["kernels"] if any(k in n for k in KERNELS)]
    if not ds:
        return None
    work = r["work"]("k1")
    ops, nbytes = work.work(**r["shapes"])
    least = r["peaks"].least_time(ops, nbytes, work.PEAK)
    return 100.0 * least / (sum(ds) / len(ds))
