"""Evaluation layer: the serving entry point, the KITTI evaluation loop and
KITTI AP through the repository's one C++ evaluator (``eval/``)."""

from .kitti_eval import (ap_from_precision, ensure_binary,
                         evaluate_kitti_results_verbose, kitti_roc_table,
                         parse_stats_file, run_kitti_eval)

__all__ = ["ensure_binary", "run_kitti_eval", "parse_stats_file",
           "ap_from_precision", "evaluate_kitti_results_verbose",
           "kitti_roc_table", "test_kitti_3d"]


def __getattr__(name):
    # lazy: the loop pulls in torch and the model code the light evaluator
    # helpers do not need
    if name == "test_kitti_3d":
        from .tester import test_kitti_3d
        return test_kitti_3d
    raise AttributeError(name)
