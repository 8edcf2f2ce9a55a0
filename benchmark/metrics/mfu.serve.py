"""Model FLOPs of the units the traced window ran (counted once from the
configuration's shapes over the plain reference, 3x the forward for a
training step) over the window's seconds times the card's peak for products
at f32 accuracy (3xTF32, 164.9 TFLOP/s), in percent."""


def read(r):
    t = r.get("trace")
    if not t or not r.get("units") or not r.get("flops_per_unit"):
        return None
    return 100.0 * r["units"] * r["flops_per_unit"] / (
        t["window_s"] * r["peaks"].PEAK_F32_PRODUCTS)
