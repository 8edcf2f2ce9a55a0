"""The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).

Products at f32 accuracy are held against the fastest route to them: three
TF32 tensor-core products for one (3xTF32, the TF32 rate over three), which
beats f32 on the CUDA cores.  Copied from the port's
``utils/measure.py`` so that the yardstick stays with the benchmark.
"""

PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_TF32 = 494.7e12        # FLOP/s, TF32 tensor cores
PEAK_F32 = 67e12            # FLOP/s, f32 outside the tensor cores
PEAK_F32_PRODUCTS = max(PEAK_TF32 / 3, PEAK_F32)   # 164.9e12
PEAK_BYTES = 3.35e12        # device-memory bytes/s


def least_time(ops, nbytes, peak_ops):
    """The least seconds for ``ops`` operations at ``peak_ops`` and
    ``nbytes`` bytes at the memory rate: the larger of the two."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)
