"""Training runtime: LR schedules, the optimizer, the train step
(counterpart of ``groomed_nms_tpu/training``)."""
