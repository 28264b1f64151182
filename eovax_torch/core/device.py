"""The device the port runs on: CUDA unless the caller asks for another; the
rank and the number of processes of the run.

Under a ``torch.distributed`` group (one process per card, as ``torchrun``
launches it) an unindexed ``cuda`` is the rank's own card,
``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os

import torch


def grouped() -> bool:
    """Whether a ``torch.distributed`` group is initialised (even of one
    process): the collectives run exactly when it is."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def local_card(rank: int) -> int:
    """The index of this process's card, ``LOCAL_RANK`` (``rank`` when the launch
    set none); raises when the machine has no such card."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card: this machine has "
            f"{torch.cuda.device_count()} CUDA device(s); launch at most one process per card")
    return local


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a ``torch.device``, CUDA when None; raises for CUDA without
    a card instead of falling back to the CPU. Under a group an unindexed CUDA
    device is ``cuda:LOCAL_RANK`` (the group rank when the launch set no
    ``LOCAL_RANK``), and a rank without its card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "eovax_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if device.index is None and grouped():
        device = torch.device("cuda", local_card(torch.distributed.get_rank()))
    return device


def process_count() -> int:
    """The world size of the initialised ``torch.distributed`` group, else 1."""
    return torch.distributed.get_world_size() if grouped() else 1


def process_index() -> int:
    """This process's rank in the initialised ``torch.distributed`` group, else 0."""
    return torch.distributed.get_rank() if grouped() else 0
