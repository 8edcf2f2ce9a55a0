"""eval subpackage of groomed_nms_torch."""
