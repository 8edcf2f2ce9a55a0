"""Process groups, rank slices and the data-parallel wrapper (counterpart of
``groomed_nms_tpu/parallel/mesh.py``).

JAX's ``shard_train_step`` jits the step with the batch sharded over a
device mesh and the parameters replicated; XLA keeps one device's numerics,
so the batch's statistics, the loss's normalisers and the gradient are the
global batch's.  The port runs one process a rank (``torchrun``) and keeps
the same numerics by hand:

* ``init_distributed`` (``create_mesh``): the process group from torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or from an explicit rank,
  world and ``init_method``; without either, the single-process context,
  which costs nothing.
* ``local_rows`` (``shard_batch``): rank r's contiguous block of a batch.
* ``wrap_model`` (``shard_train_step`` + ``replicate``):
  ``DistributedDataParallel`` with the parameters broadcast from rank 0 and
  buffers left alone (each rank updates its running statistics from the
  same global statistics), and every ``FlaxBatchNorm2d`` normalising with
  the global batch's statistics.
* ``global_counts``: detached counts and sums of a step, packed into one
  tensor and summed over the ranks in one ``all_reduce``.
* ``all_reduce`` / ``all_gather``: sums and concatenations over the ranks
  that carry gradients (``torch.distributed.nn.functional``).
* ``spawn``: run a function on ``world`` fresh processes joined by a
  ``file://`` store (the tests, ``dryrun_multichip``).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Dist:
    """Where this process stands: its rank among ``world`` processes, its
    device and the process group (None in a single process)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    backend: str | None = None

    @property
    def active(self):
        """True when the ranks must agree: a group of more than one."""
        return self.group is not None and self.world > 1


def _rank_device(device, local_rank, local_world, backend):
    """This rank's device: ``cuda:<local rank>`` (modulo the cards when
    gloo lets ranks share one), else ``device`` as given."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > cards:
        raise ValueError(
            f"nccl needs a card of its own for each rank: {local_world} "
            f"ranks on this host, {cards} card(s); pass --dist-backend gloo "
            "to let ranks share a card")
    index = local_rank % cards if device.index is None else device.index
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_distributed(backend=None, device="cuda", *, rank=None, world=None,
                     init_method=None):
    """Join the process group and return this process's ``Dist``.

    With ``rank`` and ``world`` given, joins through ``init_method`` (a
    ``file://`` or ``tcp://`` URL); otherwise reads ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` as torchrun sets them, and without ``WORLD_SIZE``
    returns the single-process context (no group).  ``backend`` is "nccl"
    (the default on a card: one card a rank, and two ranks on one card
    raise) or "gloo" (the CPU, and ranks that share a card).  A failed
    join raises."""
    if rank is None:
        if "WORLD_SIZE" not in os.environ:
            return Dist(device=torch.device(device))
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        init_method = init_method or "env://"
    else:
        local_rank, local_world = rank, world
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; known: {BACKENDS}")
    dev = _rank_device(device, local_rank, local_world, backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return Dist(rank=rank, world=world, device=dev,
                group=dist.group.WORLD, backend=backend)


def close_distributed(ctx):
    """Leave the process group of ``ctx`` (nothing in a single process)."""
    if ctx.group is not None:
        dist.destroy_process_group()


def local_rows(b, rank, world):
    """The slice of a batch of ``b`` rows that rank ``rank`` of ``world``
    holds: the contiguous block ``shard_batch`` gives device ``rank``.
    Raises ``ValueError`` when ``b`` does not split evenly, as a sharding
    of the batch axis does."""
    if b % world:
        raise ValueError(f"a batch of {b} does not split over {world} "
                         "ranks; make the global batch a multiple of the "
                         "world size")
    n = b // world
    return slice(rank * n, (rank + 1) * n)


def barrier(ctx):
    """Wait for every rank of ``ctx`` (nothing in a single process)."""
    if ctx.group is None:
        return
    if ctx.backend == "nccl":
        dist.barrier(group=ctx.group, device_ids=[ctx.device.index])
    else:
        dist.barrier(group=ctx.group)


def wrap_model(model, ctx, ignore=()):
    """``model`` as the train step runs it under ``ctx``: itself in a
    single process; else ``DistributedDataParallel`` (parameters broadcast
    from rank 0 now, gradients averaged over the ranks in every backward,
    buffers not broadcast), with each ``FlaxBatchNorm2d`` of ``model`` set
    to the group's global statistics when the world is larger than one.

    ``ignore`` names trainable parameters the loss does not reach
    (``trainer.unused_parameters``): no rank gets a gradient for them, so
    DDP leaves them out of its reduction (they are broadcast here), where
    ``find_unused_parameters`` would search the graph every step and miss a
    parameter that feeds an output the loss does not read.  The wrapper
    keeps them as ``ignored_params`` ({name: parameter}); the train step
    raises when one of them gets a gradient, which DDP would not reduce."""
    if ctx.group is None:
        return model
    from torch.nn.parallel import DistributedDataParallel

    from ..models.densenet import FlaxBatchNorm2d

    if ctx.world > 1:
        for m in model.modules():
            if isinstance(m, FlaxBatchNorm2d):
                m.process_group = ctx.group
    params = dict(model.named_parameters())
    for name in ignore:
        dist.broadcast(params[name].data, 0, group=ctx.group)
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        model, list(ignore))
    cuda = ctx.device.type == "cuda"
    ddp = DistributedDataParallel(
        model, device_ids=[ctx.device.index] if cuda else None,
        broadcast_buffers=False, process_group=ctx.group)
    ddp.ignored_params = {name: params[name] for name in ignore}
    return ddp


def all_reduce(t, group):
    """The sum of ``t`` over the ranks of ``group``, differentiable: the
    gradient of each rank's input is the sum of the ranks' gradients of
    the result."""
    from torch.distributed.nn.functional import all_reduce as _all_reduce
    return _all_reduce(t, group=group)


def all_gather(t, ctx):
    """Every rank's ``t`` concatenated along axis 0 in rank order,
    differentiable: each rank's input gets the sum over the ranks of the
    gradient of its block.  An ``all_reduce`` of ``t`` placed in its
    rank's block of zeros, so it takes any backend and dtype (a sum of one
    value and zeros is exact)."""
    parts = [torch.zeros_like(t)] * ctx.world
    parts[ctx.rank] = t
    return all_reduce(torch.cat(parts), ctx.group)


def global_counts(ctx, *tensors):
    """The sums over the ranks of ``ctx`` of counts and sums every rank
    must agree on, in one collective: the tensors, detached, are packed
    into one f64 tensor (integer counts stay exact to 2^53) for one
    ``all_reduce``, and come back in order, each in its own dtype and
    shape.  Without an active group (``ctx`` None, or a world of one)
    they are returned as given."""
    if ctx is None or not ctx.active or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    dist.all_reduce(flat, group=ctx.group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _spawned(rank, fn, world, init_method, backend, device, args, out_dir):
    torch.set_num_threads(1)
    ctx = init_distributed(backend, device, rank=rank, world=world,
                           init_method=init_method)
    try:
        result = fn(ctx, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close_distributed(ctx)


def spawn(fn, world, *args, backend="gloo", device="cpu"):
    """Run ``fn(ctx, *args)`` on ``world`` new processes (the ``spawn``
    start method: each imports ``fn``'s module afresh) joined through a
    ``file://`` store in a temporary directory; returns each rank's result
    in rank order (``torch.save``d by the rank, so tensors, numbers and
    dicts of them).  A rank that raises or dies raises here once every
    rank has ended.  Each rank runs torch on one thread (many ranks share
    the host's cores)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="groomed_nms_dist_") as d:
        init = "file://" + os.path.join(d, "store")
        mp.start_processes(_spawned, args=(fn, world, init, backend, device,
                                           args, d),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
