"""The device the port runs on: CUDA unless the caller asks for another; the
number of processes of the run."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a ``torch.device``, CUDA when None; raises for CUDA without
    a card instead of falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "eovax_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def process_count() -> int:
    """The world size of the initialised ``torch.distributed`` group, else 1."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
