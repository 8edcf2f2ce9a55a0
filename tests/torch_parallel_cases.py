"""The rank side of ``test_torch_parallel.py``: train-step cases run on a
process group's ranks and, as the reference, in one process on the global
batch.  Imports torch, numpy and the port only: spawned ranks import this
module afresh and must not import jax.

A case is a plain dict (pickled to the ranks): the model's ``RPNConfig``
keywords and whether it is the video model, its ``state_dict`` as numpy
arrays, the ``LossConfig`` keywords, the optimizer's, the anchors, the
fused preprocess's keywords (None: the batch holds normalised NCHW
``images``), the global batch as numpy arrays and the number of steps.
"""

import numpy as np
import torch
import torch.distributed

from groomed_nms_torch.config import with_remat
from groomed_nms_torch.losses.rpn_3d import (GTBatch, LossConfig,
                                             UncertaintyState, rpn_3d_loss)
from groomed_nms_torch.models.densenet import (FlaxBatchNorm2d,
                                               tiny_densenet_config)
from groomed_nms_torch.models.rpn_3d import RPN3D, RPNConfig
from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D
from groomed_nms_torch.parallel import Dist, dryrun, local_rows, wrap_model
from groomed_nms_torch.training.schedules import build_lr_schedule
from groomed_nms_torch.training.trainer import (TrainState, build_optimizer,
                                                fuse_preprocess,
                                                make_train_step,
                                                make_video_train_step,
                                                unused_parameters)

MEANS, STDS = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def build_model(case):
    rpn = RPNConfig(backbone=with_remat(tiny_densenet_config(),
                                        case.get("remat")), **case["rpn"])
    return VideoRPN3D(VideoConfig(rpn=rpn)) if case["video"] else RPN3D(rpn)


def run_case(case, dtype, dist):
    """``case['steps']`` steps on ``dist``'s rows of the global batch (all
    of it in a single process) in ``dtype``; returns the state_dict after
    the last step, each step's stats and the self-balancing lambda."""
    device = dist.device
    model = build_model(case)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in case["sd"].items()})
    model = model.to(device, dtype)
    lcfg = LossConfig(**case["loss"])
    opt = build_optimizer(list(model.parameters()), "sgd",
                          build_lr_schedule(case["lr"], 100),
                          batch_skip=case.get("batch_skip", 1))

    def dev(x, dt=dtype):
        t = torch.as_tensor(np.asarray(x), device=device)
        return t if dt is None else t.to(dt)

    make = make_video_train_step if case["video"] else make_train_step
    step = make(lcfg, dev(case["rois"]), dev(case["rois_3d"]),
                dev(case["means"]), dev(case["stds"]), dist=dist)
    if case["fused"] is not None:
        step = fuse_preprocess(step, dev(MEANS, torch.float32),
                               dev(STDS, torch.float32),
                               out_dtype=None if dtype == torch.float32
                               else dtype, dist=dist, **case["fused"])
    state = TrainState(model, opt, UncertaintyState.init(device))
    if dist.group is not None:
        state.ddp = wrap_model(model, dist,
                               ignore=unused_parameters(model, lcfg))
    n = len(case["batch"]["gts_2d"])
    rows = local_rows(n, dist.rank, dist.world) if dist.active \
        else slice(None)
    batch = {}
    for k, v in case["batch"].items():
        v = np.ascontiguousarray(v[rows])
        batch[k] = dev(v) if v.dtype.kind == "f" else dev(v, None)
    if case["fused"] is None:
        batch["images"] = batch["images"].permute(0, 3, 1, 2)
    stats = []
    for _ in range(case["steps"]):
        s = step(state, batch)
        stats.append({k: float(v) for k, v in s.items()})
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return dict(sd=sd, stats=stats, lam=float(state.un_state.lam))


def batchnorm_case(spec, dist):
    """One ``FlaxBatchNorm2d`` in train mode on this rank's rows, under the
    group's global statistics: this rank's output and input gradient, its
    share of the affine gradients (their sum over the ranks is the whole
    batch's) and the running statistics after the step."""
    x = torch.from_numpy(spec["x"])
    c = x.shape[1]
    bn = FlaxBatchNorm2d(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["weight"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    bn.train()
    if dist.active:
        bn.process_group = dist.group
    rows = local_rows(len(x), dist.rank, dist.world) if dist.active \
        else slice(None)
    xr = x[rows].clone().requires_grad_(True)
    y = bn(xr)
    (y * torch.from_numpy(spec["cot"])[rows]).sum().backward()
    return dict(y=y.detach(), dx=xr.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())


def loss_case(spec, dist):
    """``rpn_3d_loss`` on this rank's rows of head tensors (the model's
    split of them, as ``test_torch_loss._outputs`` makes it): the global
    stats and lambda, and the gradient of the rank's share of the loss
    with respect to its rows of the heads: their gradient in the global
    loss (the shares sum to it, and a row feeds no other rank's share but
    through the ``all_gather`` of a whole-batch AP loss, whose backward
    sums every rank's part; the trainer's factor of ``world`` is for
    DDP's average over the ranks' parameter gradients)."""
    rows = local_rows(len(spec["gt"]["gts_2d"]), dist.rank, dist.world) \
        if dist.active else slice(None)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rows]))
    heads = {k: t(v).requires_grad_() for k, v in spec["heads"].items()}
    b3 = heads["bbox_3d"]
    out = {"cls": heads["cls"], "prob": torch.softmax(heads["cls"], -1),
           "bbox_2d": heads["bbox_2d"],
           "bbox_3d": torch.cat([b3[..., :8], torch.sigmoid(b3[..., 8:10]),
                                 b3[..., 10:]], -1)}
    cfg = LossConfig(**spec["cfg"])
    if "accept" in heads:
        if cfg.acceptance_prob_mode == "classify":
            out["accept_cls"] = torch.sigmoid(heads["accept"])
        else:
            out["accept_prob"] = torch.sigmoid(heads["accept"][..., 0])
    if "un" in heads:
        out["uncertainty"] = torch.sigmoid(heads["un"])
    whole = lambda a: torch.from_numpy(np.asarray(a))
    loss, stats, un = rpn_3d_loss(
        out, whole(spec["rois"]), whole(spec["rois_3d"]),
        GTBatch(**{k: t(v) for k, v in spec["gt"].items()}),
        whole(spec["means"]), whole(spec["stds"]),
        UncertaintyState(whole(np.float32(spec["un"][0])),
                         whole(np.int32(spec["un"][1]))), cfg, dist=dist)
    loss.backward()
    return dict(stats={k: v.item() for k, v in stats.items()},
                lam=float(un.lam), n=int(un.n),
                grads={k: v.grad for k, v in heads.items()})


def rank_cases(ctx, cases, bn_spec, loss_specs):
    """The spawned ranks' work: every case of ``cases`` ({name: (case,
    dtype name)}), the BatchNorm check and the loss specs."""
    out = {name: run_case(case, getattr(torch, dtype), ctx)
           for name, (case, dtype) in cases.items()}
    out["batchnorm"] = batchnorm_case(bn_spec, ctx)
    out["losses"] = [loss_case(spec, ctx) for spec in loss_specs]
    return out


def remat_ranks(ctx, modes):
    """The dryrun's GrooMeD step (acceptance, jitter, a global batch of 8)
    in f64 for each ``backbone_remat`` mode of ``modes``, 2 steps, the
    BatchNorm perturbed from one seed: {mode: run_case's result and the
    ``torch.distributed.all_reduce`` calls of the run (DDP's buckets go
    around it)}."""
    setup = dryrun._setup(8)
    rois = setup["rois"]
    out = {}
    for mode in modes:
        case = dict(
            rpn=dict(num_classes=4, num_anchors=dryrun.NUM_ANCHORS,
                     prop_features=64, predict_acceptance_prob=True),
            remat=mode, video=False, lr=0.004, rois=rois,
            rois_3d=setup["priors"][rois[:, 4].astype(np.int64), 4:],
            loss=dict(use_nms_in_loss=True, predict_acceptance_prob=True,
                      max_nms_boxes=32, max_ap_boxes=64),
            means=np.zeros(13), stds=np.ones(13), batch=setup["batch"],
            fused=dict(target_h=dryrun.B_H, crop_w=dryrun.B_W,
                       distort_prob=0.5, rng_seed=0), steps=2)
        case["sd"] = {k: v.numpy().copy() for k, v in dryrun.perturb_batchnorm(
            build_model(case), 3).state_dict().items()}
        real, calls = torch.distributed.all_reduce, []

        def counted(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        torch.distributed.all_reduce = counted
        try:
            out[mode] = dict(run_case(case, torch.float64, ctx),
                             all_reduces=len(calls))
        finally:
            torch.distributed.all_reduce = real
    return out


def single_process(fn, *args):
    """The reference: ``fn(*args, Dist())`` in this process on the whole
    batch, on one thread as each rank runs (a CPU reduction's order, the
    jitter's image means among them, depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, Dist())
    finally:
        torch.set_num_threads(threads)
