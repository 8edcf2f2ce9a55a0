"""AOT export of the serving program on ``torch.export`` (counterpart of
``groomed_nms_tpu/export.py``).

The whole serving program -- the uint8 preprocess, the model (under bf16
autocast when asked), K1, the decode, the NMS (K2, or GrooMeD-NMS with K3
and the grouping) and the top-k -- is staged out with ``torch.export`` into
one ``ExportedProgram`` that holds the weights, anchors and statistics, and
serialized with ``torch.export.save`` to bytes (a ``.pt2`` archive).  The
kernels are custom ops (``ops/kernels.py``), so each stays one node of the
graph.  Loading needs torch and this package's kernel library: no module,
config, checkpoint or anchors.

Typical use::

    serve = build_serving_fn(model, rois, rois_3d, bbox_means, bbox_stds,
                             image_means, image_stds, dcfg, target_h=512,
                             crop_w=1760, bf16_input=True)
    blob = export_serving(serve, batch=8, src_h=375, src_w=1242)
    open("model.pt2", "wb").write(blob)
    # ... later, in a process that never builds the model:
    loaded = load_serving(open("model.pt2", "rb").read())
    dets, valid = loaded(images_u8, p2, p2_inv, scale)

Export on the device you serve on: the program's tensors and kernels are
that device's, the artifact records it, and loading it for another device
raises.  Shapes are static; a call with other shapes or dtypes raises
``ValueError``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import zipfile

import torch
from torch import nn

from .data.augment import preprocess_images
from .inference import im_detect_3d, rpn_outputs_dict
from .models.kalman import Tracks
from .models.video import extract_measurements, video_track
# registers the torch.ops.groomed_nms custom ops the artifacts call
from .ops import kernels  # noqa: F401

TRACKS_NAME = "groomed_nms_torch.models.kalman.Tracks"
_DEVICE_FILE = "device"


@functools.cache
def register_tracks():
    """Let ``Tracks`` cross the export boundary under a fixed name (once a
    process, on the exporting and the loading side)."""
    torch.export.register_dataclass(Tracks, serialized_type_name=TRACKS_NAME)


class _Serving(nn.Module):
    """A model and the constants its serving program closes over, as
    buffers on the model's device."""

    def __init__(self, model, bf16_input, **constants):
        super().__init__()
        self.model = model.eval()
        param = next(model.parameters())
        self.compute_dtype = torch.bfloat16 if bf16_input else param.dtype
        for name, value in constants.items():
            value = torch.as_tensor(value, device=param.device).clone()
            if value.dtype == torch.float64 and param.dtype != torch.float64:
                value = value.float()
            self.register_buffer(name, value)

    def _autocast(self, device):
        if self.compute_dtype != torch.bfloat16:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    def _preprocess(self, images_u8):
        return preprocess_images(
            images_u8, None, self.image_means, self.image_stds,
            target_h=self.target_h, crop_w=self.crop_w,
            out_dtype=self.compute_dtype)


class DetectionServing(_Serving):
    """``serve(images_u8, p2, p2_inv, scale) -> (dets, valid)``: the
    program of ``eval/tester.py::make_infer`` with its constants inside."""

    def __init__(self, model, rois, rois_3d, bbox_means, bbox_stds,
                 image_means, image_stds, dcfg, *, target_h, crop_w,
                 bf16_input):
        super().__init__(model, bf16_input, rois=rois, rois_3d=rois_3d,
                         bbox_means=bbox_means, bbox_stds=bbox_stds,
                         image_means=image_means, image_stds=image_stds)
        self.dcfg, self.target_h, self.crop_w = dcfg, target_h, crop_w

    def forward(self, images_u8, p2, p2_inv, scale):
        images = self._preprocess(images_u8)
        with self._autocast(images.device):
            out = self.model(images)
        return im_detect_3d(rpn_outputs_dict(out), self.rois, self.rois_3d,
                            p2, p2_inv, scale, self.bbox_means,
                            self.bbox_stds, self.dcfg)


class VideoServing(_Serving):
    """``serve(clip_u8, p2, p2_inv, scale) -> Tracks``: the video model's
    test path over one clip (``scripts/test_kalman_torch.py``)."""

    def __init__(self, model, rois, rois_3d, bbox_means, bbox_stds,
                 image_means, image_stds, vcfg, pose_means, pose_stds, *,
                 target_h, crop_w, bf16_input):
        super().__init__(model, bf16_input, rois=rois, rois_3d=rois_3d,
                         bbox_means=bbox_means, bbox_stds=bbox_stds,
                         image_means=image_means, image_stds=image_stds,
                         pose_means=pose_means, pose_stds=pose_stds)
        self.vcfg, self.target_h, self.crop_w = vcfg, target_h, crop_w

    def forward(self, clip_u8, p2, p2_inv, scale):
        f = clip_u8.shape[0]
        flat = self._preprocess(clip_u8)
        with self._autocast(flat.device):
            out = self.model(flat[None])
        meas, valid = extract_measurements(
            out.frame_outputs, self.rois, self.rois_3d, p2.expand(f, 4, 4),
            scale, self.bbox_means, self.bbox_stds, self.vcfg)
        poses = out.poses[0] * self.pose_stds + self.pose_means
        poses = torch.cat([poses.new_zeros((1, 6)), poses]).to(meas.dtype)
        final, _ = video_track(meas, valid, poses, p2.to(meas.dtype),
                               self.vcfg)
        return final


def build_serving_fn(model, rois, rois_3d, bbox_means, bbox_stds,
                     image_means, image_stds, dcfg, *, target_h, crop_w,
                     bf16_input=True):
    """Close the uint8-in / detections-out program over its constants.

    ``model`` is an ``RPN3D`` on the serving device (put in eval mode).
    Returns ``serve(images_u8, p2, p2_inv, scale) -> (dets, valid)``:
    ``images_u8`` [B, H0, W0, 3] uint8, ``p2`` / ``p2_inv`` [B, 4, 4] f32,
    ``scale`` [B] f32 (the source-to-network resize factor), ``dets``
    [B, topN_post, 17] and ``valid`` [B, topN_post] bool.  ``bf16_input``
    feeds the model bf16 and runs it under bf16 autocast (BatchNorm and the
    head's splits stay f32); otherwise it runs in its parameters' dtype.
    ``dcfg.use_differentiable_nms`` serves GrooMeD-NMS (K3, the grouping)
    in place of greedy NMS (K2).  Call it under ``torch.no_grad()``.
    """
    return DetectionServing(model, rois, rois_3d, bbox_means, bbox_stds,
                            image_means, image_stds, dcfg, target_h=target_h,
                            crop_w=crop_w, bf16_input=bf16_input)


def build_video_serving_fn(model, rois, rois_3d, bbox_means, bbox_stds,
                           image_means, image_stds, vcfg, pose_means,
                           pose_stds, *, target_h, crop_w, bf16_input=True):
    """Serving closure of the video model: one clip in, tracks out.

    ``serve(clip_u8, p2, p2_inv, scale) -> Tracks``: ``clip_u8`` [F, H0, W0,
    3] uint8 (frame 0 the oldest), ``p2`` / ``p2_inv`` [4, 4] f32, ``scale``
    [F] f32 (each frame's resize factor: history frames may have been fitted
    at another ratio).  The fixed-slot ``Tracks`` holds the final state.  A
    ``VideoRPN3D`` in f64 runs the measurements and the tracker in f64.
    """
    return VideoServing(model, rois, rois_3d, bbox_means, bbox_stds,
                        image_means, image_stds, vcfg, pose_means, pose_stds,
                        target_h=target_h, crop_w=crop_w,
                        bf16_input=bf16_input)


def _export_staged(serve, example_inputs):
    """Stage ``serve`` out on its example inputs and serialize it."""
    register_tracks()
    with torch.no_grad():
        program = torch.export.export(serve, example_inputs, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={_DEVICE_FILE: str(serve.rois.device)})
    return buf.getvalue()


def _planes(serve, n, lead, src_h, src_w):
    dev = serve.rois.device
    p2 = torch.eye(4, device=dev).expand(*lead, 4, 4).contiguous()
    return (torch.zeros((n, src_h, src_w, 3), dtype=torch.uint8, device=dev),
            p2, p2.clone(), torch.ones((n,), device=dev))


def export_serving(serve, *, batch, src_h, src_w):
    """Stage a ``build_serving_fn`` closure out at ``images_u8`` [batch,
    src_h, src_w, 3] uint8, ``p2`` / ``p2_inv`` [batch, 4, 4] f32 and
    ``scale`` [batch] f32, on its device; returns the artifact's bytes."""
    return _export_staged(serve, _planes(serve, batch, (batch,), src_h,
                                         src_w))


def export_video_serving(serve, *, n_frames, src_h, src_w):
    """Stage a ``build_video_serving_fn`` closure out at ``clip_u8``
    [n_frames, src_h, src_w, 3] uint8, ``p2`` / ``p2_inv`` [4, 4] f32 and
    ``scale`` [n_frames] f32, on its device; returns the bytes."""
    return _export_staged(serve, _planes(serve, n_frames, (), src_h, src_w))


def _artifact_device(blob):
    """The device an artifact was exported on, read without loading it."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        name = next(n for n in z.namelist()
                    if n.endswith(f"/extra/{_DEVICE_FILE}"))
        return torch.device(z.read(name).decode())


def load_serving(blob, device=None):
    """Deserialize an artifact; returns ``call(images_u8, p2, p2_inv,
    scale)`` (detections) or ``call(clip_u8, p2, p2_inv, scale)`` (tracks),
    run under ``torch.inference_mode()``.

    The artifact runs on the device it was exported on; ``device``, when
    given, must be that one, and a CUDA artifact needs CUDA.  The inputs
    must have the exported shapes and dtypes and lie on that device, or the
    call raises ``ValueError``.  ``call.program`` is the
    ``ExportedProgram``.
    """
    exported_on = _artifact_device(blob)
    if device is not None:
        device = torch.device(device)
        if device.type != exported_on.type or device.index not in (
                None, exported_on.index):
            raise ValueError(f"the artifact was exported on {exported_on}; "
                             f"it cannot be served on {device}")
    if exported_on.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the artifact was exported on CUDA, which is "
                           "not available here")
    register_tracks()
    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    nodes = {n.name: n for n in program.graph.nodes}
    specs = [nodes[name].meta["val"]
             for name in program.graph_signature.user_inputs]

    def call(*inputs):
        if len(inputs) != len(specs):
            raise ValueError(f"the artifact takes {len(specs)} inputs, got "
                             f"{len(inputs)}")
        for i, (x, want) in enumerate(zip(inputs, specs)):
            if not isinstance(x, torch.Tensor) or x.shape != want.shape \
                    or x.dtype != want.dtype or x.device != exported_on:
                got = (f"{tuple(x.shape)} {x.dtype} on {x.device}"
                       if isinstance(x, torch.Tensor) else type(x).__name__)
                raise ValueError(
                    f"input {i} must be {tuple(want.shape)} {want.dtype} on "
                    f"{exported_on}, got {got}")
        with torch.inference_mode():
            return module(*inputs)

    call.program = program
    return call
