"""Data parallelism over processes (counterpart of
``groomed_nms_tpu/parallel``): one process a rank, the batch split over the
ranks, and the numerics of one process on the global batch (``dist.py``).
``dryrun.dryrun_multichip`` checks the path in n processes."""

from .dist import (Dist, all_gather, all_reduce, barrier, close_distributed,
                   global_counts, init_distributed, local_rows, spawn,
                   wrap_model)

__all__ = ["Dist", "all_gather", "all_reduce", "barrier",
           "close_distributed", "global_counts", "init_distributed",
           "local_rows", "spawn", "wrap_model"]
