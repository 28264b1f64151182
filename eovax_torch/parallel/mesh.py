"""Data parallelism on ``torch.distributed``: one process per card, parameters
replicated, each process training on its rows of the global batch.

Port of ``eovax/parallel/mesh.py``. The JAX package builds a 1-D ``data``
mesh, shards the batch on axis 0 and lets XLA insert the gradient ``psum``
and the cross-replica sums of the latent BatchNorm. Here a process holds one
card (``cuda:LOCAL_RANK``, as ``torchrun`` launches it) and the collectives
are written out: the trainers' optimizer averages the gradients over the
ranks (:func:`average_gradients`), the latent BatchNorm takes the ranks'
mean of its statistics (:func:`rank_mean`) through :func:`all_sum`, whose
backward sums the gradients too, the focal frequency loss's batch maximum is
the ranks' (:func:`rank_max`), the logged
scalars are means over the ranks, and the preemption guard takes the MAX of
the ranks' stop flags. ``DistributedDataParallel`` is not used: its reducer
runs on ``.backward()`` hooks, and the adversarial step takes
``torch.autograd.grad`` and restricts its backward with ``inputs=``.

The global batch is the ranks' local batches in rank order, and every rank
holds the same number of rows (a JAX global array cannot hold unequal
shards): :func:`place_batch` refuses a batch whose rows differ across ranks.
A draw over the batch (the posterior sample, the latent noise, the SR
trainer's t, noise and sampler start) is drawn at the global shape from a
generator in the same state on every rank, and each rank keeps its rows
(:func:`global_rows`): every rank's generator then stays in the state of a
one-process run on the global batch.

The backend is the caller's, never swapped behind its back:
:func:`init_distributed` takes NCCL for CUDA, where every rank needs its own
card, and gloo for the CPU; gloo on CUDA tensors only when the caller names
it. A failed initialisation raises.

Serving runs the other way: one process drives several cards
(:class:`DeviceMesh`, the JAX package's ``make_mesh`` over a process's local
devices), and ``ServedModel.with_mesh`` splits a request batch into row
blocks, one a device. The JAX package's training-side ``shard_batch`` has no
counterpart: with one process per card a training process never places a
batch on several devices.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from eovax_torch.core.device import (
    grouped,
    local_card,
    process_count,
    process_index,
    resolve_device,
)

#: Leaf names that are per-modality constants, the same on every rank (not
#: per-sample data): kept whole on every rank. The ``device_prep`` collate's
#: descriptors are per-sample ([B, ·]) and split with the image.
REPLICATED_BATCH_KEYS = ("wvs",)


def init_distributed(device: str | torch.device | None = None, **kwargs) -> bool:
    """Initialise the default process group when the launch asks for one
    (idempotent); otherwise a no-op. Returns whether this call initialised it
    (its caller then owns the group and destroys it).

    A launch asks for a group with explicit ``kwargs`` (those of
    ``torch.distributed.init_process_group``: ``init_method``, ``world_size``,
    ``rank``, ``backend``, ``store``) or with ``WORLD_SIZE`` > 1 in the
    environment, as ``torchrun`` sets it. The backend defaults to NCCL when
    ``device`` (CUDA when None) is a CUDA device, and then the rank's card,
    ``cuda:LOCAL_RANK``, becomes the current device; to gloo otherwise. An
    error of the initialisation propagates.
    """
    if grouped():
        return False
    if not kwargs and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    on_cuda = torch.device("cuda" if device is None else device).type == "cuda"
    backend = kwargs.pop("backend", None) or ("nccl" if on_cuda else "gloo")
    if backend == "nccl":  # a rank without its card raises here
        torch.cuda.set_device(local_card(kwargs.get("rank", int(os.environ.get("RANK", 0)))))
    dist.init_process_group(backend=backend, **kwargs)
    return True


def destroy_distributed(created: bool) -> None:
    """Destroy the default group if ``created`` (``init_distributed``'s result)."""
    if created and grouped():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The 1-D data mesh of this process: its device, its rank and the world
    size (the collectives use the default group)."""

    device: torch.device
    rank: int = 0
    world_size: int = 1


def make_mesh(device: str | torch.device | None = None) -> DataMesh:
    """The data mesh over every process of the group (or this process alone);
    ``device`` is resolved as ``resolve_device`` does, the rank's card under a
    group."""
    return DataMesh(device=resolve_device(device), rank=process_index(),
                    world_size=process_count())


#: The name of a one-process mesh's single axis, the JAX package's ``DATA_AXIS``.
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices of one process, laid out on named axes (row-major ``devices``,
    ``shape`` the size of each axis), the JAX package's ``Mesh`` for serving.
    A device may appear more than once: the CPU tests hold an 8-way mesh of
    the host, and one card repeated runs the split path."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or int(np.prod(self.shape)) != len(
                self.devices) or not self.devices:
            raise ValueError(f"mesh of {len(self.devices)} devices cannot take the shape "
                             f"{self.shape} on axes {self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_device_mesh(devices=None, axis: str = DATA_AXIS) -> DeviceMesh:
    """1-D mesh over every visible card (``cuda:0 … cuda:n-1``) or the given
    devices (strings or ``torch.device``; an unindexed ``cuda`` is ``cuda:0``).
    Raises without a card when none are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_device_mesh: no CUDA device is available; pass the "
                               "devices (e.g. ['cpu'] * 8) to build a mesh of others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device("cuda", 0) if torch.device(d) == torch.device("cuda")
                    else torch.device(d) for d in devices)
    return DeviceMesh(devices, (len(devices),), (axis,))


def _collective_device() -> torch.device:
    """Where a small collective's tensor lives: the current card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def place_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's local batch as tensors on its device, by
    ``global_batch_from_local``'s leaf rules: a leaf of ndim ≥ 2 is this rank's
    rows of the global batch, a scalar or a leaf named in
    ``REPLICATED_BATCH_KEYS`` is the same on every rank, and any other 1-D leaf is refused. Every rank
    must hold the same number of rows; a batch whose rows differ across ranks
    raises on every rank."""
    out, rows = {}, set()
    for name, x in batch.items():
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        if t.ndim >= 2:
            rows.add(t.shape[0])
        elif t.ndim == 1 and name not in REPLICATED_BATCH_KEYS:
            raise ValueError(
                f"place_batch: 1-D batch leaf {name!r} is neither a known replicated key "
                f"{REPLICATED_BATCH_KEYS} nor image-like; refusing to guess whether it is "
                "per-sample (split) or the same on every rank (replicate)")
        out[name] = t.to(mesh.device)
    if len(rows) > 1:
        raise ValueError(f"place_batch: the batch's leaves hold different rows {sorted(rows)}")
    if rows and mesh.world_size > 1:
        _check_equal_rows(rows.pop())
    return out


def _check_equal_rows(b: int) -> None:
    t = torch.tensor([b, -b], device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    most, least = t[0].item(), -t[1].item()
    if most != least:
        raise ValueError(f"the ranks' batches hold {least} to {most} rows: every rank must "
                         "hold the same number of rows of the global batch")


def local_numpy(x: torch.Tensor) -> np.ndarray:
    """This rank's rows as a host numpy array: a rank holds only its own rows,
    so this is the tensor itself."""
    return x.detach().cpu().numpy()


def global_rows(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of a draw over the global batch:
    ``draw`` is called at the global shape [R·b, …] and rank r keeps rows
    [r·b, (r + 1)·b). Without a group of several processes it is ``draw(shape)``."""
    shape = tuple(shape)
    world = process_count()
    if world == 1:
        return draw(shape)
    b, r = shape[0], process_index()
    return draw((world * b, *shape[1:]))[r * b:(r + 1) * b]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward is the sum of the ranks' gradients,
    so that a parameter gradient averaged over the ranks is the gradient of the
    mean of their losses."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (``x`` itself without a group)."""
    return _AllReduceSum.apply(x) if grouped() else x


def rank_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiably (``x`` itself without a
    group)."""
    if not grouped():
        return x
    return all_sum(x) / dist.get_world_size()


@torch.no_grad()
def rank_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (``x`` itself without a group)."""
    if not grouped():
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


@torch.no_grad()
def average_gradients(grads: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one all-reduce
    per dtype over the tensors flattened into one buffer, in list order (every
    rank passes the same tensors in the same order). A no-op without a group."""
    if not grouped():
        return
    world = dist.get_world_size()
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        flat.div_(world)
        torch._foreach_copy_(group, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in group]), group)])


def mean_over_ranks(values: dict[str, Any]) -> dict[str, Any]:
    """The values (0-d tensors and Python floats) averaged over the ranks in one
    float64 all-reduce, each given back in its own type, device and dtype;
    ``values`` itself without a group. Every rank passes the same keys. A
    tensor on the collective's device stays there (the host does not wait for
    the step); a float is read back."""
    if not grouped() or not values:
        return values
    dev = _collective_device()
    stacked = torch.stack([torch.as_tensor(v, dtype=torch.float64).reshape(()).to(dev)
                           for v in values.values()])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    out = {}
    for (k, v), m in zip(values.items(), stacked.unbind()):
        out[k] = m.to(dtype=v.dtype, device=v.device) if torch.is_tensor(v) else m.item()
    return out


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (a MAX all-reduce); ``flag`` without a group."""
    if not grouped():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if not grouped():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if not grouped():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
