"""K2's share of its roofline: the least time of its work at [B, pre-NMS
top-k] (``work/k2.py``) over the mean time of a call, both of its kernels
(the mask, then the sweep) together, in percent."""


def read(r):
    t = r.get("trace")
    if not t:
        return None
    calls = sum("nms_sweep" in n for n, _, _ in t["kernels"])
    if not calls:
        return None
    total = sum(e - s for n, s, e in t["kernels"]
                if "nms_mask" in n or "nms_sweep" in n)
    work = r["work"]("k2")
    ops, nbytes = work.work(**r["shapes"])
    least = r["peaks"].least_time(ops, nbytes, work.PEAK)
    return 100.0 * least / (total / calls)
