"""Training losses (counterpart of ``groomed_nms_tpu/losses``)."""
