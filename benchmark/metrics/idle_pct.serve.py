"""Share of the traced window in which no kernel, copy or set ran on the
device (the gaps in the union of their intervals), in percent."""


def read(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
