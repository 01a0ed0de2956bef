"""Data parallelism over processes (counterpart of ``create_mesh`` /
``shardings`` of ``rs_detection_tpu/parallel/train_step.py``): one
process a card joined by NCCL, or gloo on the CPU, each holding the
rows ``[rank * n, (rank + 1) * n)`` of every global batch of ``world * n``
images, the parameters replicated.

The helpers below make a step over W processes compute what one process
computes on the global batch, as the JAX mesh does (XLA partitions the
single-device program there):

* ``rows`` / ``rand_rows``: the rank's rows of a global-batch tensor,
  and a draw made at the global batch's shape and cut to them (DropPath's
  mask, the samplers' scores);
* ``all_reduce_sum``: a sum over ranks that autograd differentiates
  (the backward sums the gradients over ranks), for BatchNorm's
  statistics;
* ``global_count`` and ``divide_by_count``: a loss normalized by a count
  over the batch divides its local sum by the global count and is
  multiplied by W, so that the ranks' mean gradient is the gradient of
  the global loss;
* ``global_max``: a maximum over the global batch (the RPN's border);
* ``all_gather_rows``: the ranks' rows in rank order;
* ``pad_to_global_shape``: a rank's own collated rows padded to the
  global batch's image shape.

With no process group, or a group of one, every helper is the identity
and the one-process program is unchanged bit for bit.

A world of W that does not divide the batch trains as the JAX runner
does, on the most devices that divide it (``step_world``): the first d
ranks form the step's group (``use_step_group``), and inside
``step_scope`` every helper above reads and reduces over that group; the
other ranks take no rows and wait at the next collective of the whole
world (``broadcast_tensors_`` hands them rank 0's trained weights).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.distributed as dist


# the step's group when it is smaller than the world: (group, size)
_STEP = None
# the group the helpers read and reduce over: None is the default group
_ACTIVE = None


def world() -> int:
    """The number of processes of the group in use (1 without one): the
    default group, or the step's inside ``step_scope``."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(_ACTIVE)


def rank() -> int:
    """This process's rank in the group in use (0 without one)."""
    return dist.get_rank(_ACTIVE) if dist.is_initialized() else 0


def step_world(batch: int) -> int:
    """The largest divisor of ``batch`` that is at most the default
    group's size: the ranks a step of ``batch`` rows runs on."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    while n > 1 and batch % n:
        n -= 1
    return n


def use_step_group(batch: int) -> int:
    """Make the first ``step_world(batch)`` ranks the step's group (a
    collective: every rank of the default group calls it); returns its
    size. With a world that divides ``batch`` the step's group is the
    default one."""
    global _STEP
    d = step_world(batch)
    _STEP = None
    if dist.is_initialized() and d < dist.get_world_size():
        _STEP = (dist.new_group(ranks=list(range(d))), d)
    return d


def in_step_group() -> bool:
    """Whether this rank takes rows of the training step's batch."""
    return _STEP is None or dist.get_rank() < _STEP[1]


@contextlib.contextmanager
def step_scope():
    """The training step's helpers over the step's group (a no-op when it
    is the default group)."""
    global _ACTIVE
    if _STEP is None:
        yield
        return
    if not in_step_group():
        raise RuntimeError("a rank outside the step's group takes no rows")
    prev, _ACTIVE = _ACTIVE, _STEP[0]
    try:
        yield
    finally:
        _ACTIVE = prev


@torch.no_grad()
def broadcast_tensors_(tensors, src: int = 0) -> None:
    """Rank ``src``'s ``tensors`` in place on every rank of the default
    group (a module's parameters and buffers, for the ranks outside a
    smaller step's group after training), one collective a tensor."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t.data, src=src)


def is_main() -> bool:
    """Rank 0, the process that logs, saves and evaluates."""
    return rank() == 0


def env_world() -> int:
    """The world size a launcher (``torchrun``) announces, 1 without
    one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_process_group(device=None, backend: Optional[str] = None
                       ) -> torch.device:
    """Join the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) and
    return this rank's device: ``device``, or ``cuda:LOCAL_RANK`` when
    None. The backend is NCCL on a card and gloo on the CPU; ``backend``
    overrides it (gloo on a card: two ranks sharing one card, which NCCL
    refuses). A failure to join raises: nothing drops to one process."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: data-parallel training runs one process "
                "a card over NCCL unless the caller asks for the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    kw = dict(backend=backend, init_method="env://",
              rank=int(os.environ["RANK"]),
              world_size=int(os.environ["WORLD_SIZE"]))
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return device


def destroy_process_group() -> None:
    global _STEP, _ACTIVE
    _STEP = _ACTIVE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def rows(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a global-batch tensor (its leading axis); the
    world size must divide it."""
    w = world()
    if w == 1:
        return x
    n = x.shape[0]
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"a world of {w} processes")
    k = n // w
    return x[rank() * k:(rank() + 1) * k]


def global_rows(n_local: int) -> int:
    """The global batch of which this rank holds ``n_local`` rows."""
    return n_local * world()


def pad_to_global_shape(images: torch.Tensor) -> torch.Tensor:
    """A rank's collated images ``[n, H, W, C]`` padded with zeros at the
    bottom and right to the largest H and W over ranks: the shape that
    collating the whole global batch gives, as one process collates it
    (a loader that reads only the rank's rows pads them to their own
    largest image)."""
    if world() == 1:
        return images
    hw = torch.tensor(images.shape[1:3], device=images.device)
    dist.all_reduce(hw, op=dist.ReduceOp.MAX, group=_ACTIVE)
    h, w = hw.tolist()
    if (h, w) == tuple(images.shape[1:3]):
        return images
    return torch.nn.functional.pad(
        images, (0, 0, 0, w - images.shape[2], 0, h - images.shape[1]))


def rand_rows(shape, generator=None, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows: drawn at the global
    batch's shape (``shape[0]`` rows a rank) and cut to the rank's rows,
    so that every rank draws what one process draws on the global batch.
    Every rank must draw from a generator in the same state."""
    shape = tuple(shape)
    if world() == 1:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((global_rows(shape[0]),) + shape[1:],
                      generator=generator, device=device)
    return rows(full)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable: the backward sums the
    incoming gradients over ranks."""
    if world() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, op=dist.ReduceOp.SUM,
                      group=_ACTIVE or dist.group.WORLD)


@torch.no_grad()
def global_count(count) -> torch.Tensor:
    """A count over the local rows summed over ranks, without a
    gradient."""
    if world() == 1:
        return count
    c = torch.as_tensor(count).detach().clone()
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=_ACTIVE)
    return c


@torch.no_grad()
def global_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ranks, without a gradient
    (the RPN's border: the largest image of the global batch)."""
    if world() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_ACTIVE)
    return x


def divide_by_count(total: torch.Tensor, count) -> torch.Tensor:
    """``total / max(count, 1)`` with ``count`` taken over the global
    batch: the local sum divided by the global count, times the world
    size (the ranks' mean of it is the global loss, and so is the mean of
    their gradients)."""
    avg = torch.as_tensor(count, dtype=total.dtype, device=total.device)
    if world() == 1:
        return total / avg.clamp(min=1.0)
    return total / global_count(avg).clamp(min=1.0) * world()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on the leading axis
    in rank order; no gradient."""
    w = world()
    if w == 1:
        return x
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(out, x, group=_ACTIVE)
    return torch.cat(out, 0)


def all_reduce_mean_(tensors) -> None:
    """Average same-dtype tensors over ranks in place, in one flat
    collective a dtype (the gradients after a backward)."""
    w = world()
    if w == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_ACTIVE)
        flat.div_(w)
        start = 0
        for t in group:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled; a checkpoint read
    by rank 0 alone)."""
    if world() == 1:
        return obj
    box = [obj if rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=_ACTIVE)
    return box[0]
