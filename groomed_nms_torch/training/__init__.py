"""Training runtime: LR schedules, the optimizer, the train step and the
checkpoint format (counterpart of ``groomed_nms_tpu/training``)."""
