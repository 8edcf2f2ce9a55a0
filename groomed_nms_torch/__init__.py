"""GrooMeD-NMS monocular 3D detection in PyTorch for NVIDIA Hopper.

The PyTorch port of ``groomed_nms_tpu`` (the JAX reference, which it never
imports).  It holds the still-image inference path: config, anchors, the
DenseNet-121 3D RPN, device-side preprocessing, the detection decode and two
hand-written kernels (``ops/kernels.py``: head scoring in Triton, greedy NMS
in CUDA C++).  The serving entry point is ``eval.tester.make_infer``;
``flagship.build_flagship`` builds the KITTI-resolution workload.
"""

__version__ = "0.1.0"
