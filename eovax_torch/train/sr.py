"""Stage 3 — latent-diffusion super-resolution.

Port of ``eovax/train/sr.py``'s sampling side: ``DiffusionSuperRes`` with the
fields sampling reads, its sampler, ``init_state`` and ``sample``. There is no
mesh: the port runs on one device. The training hyperparameters, ``fit``,
``validate`` and the checkpoint methods come with SR training (``ROADMAP.md``
Queue 1 item 6b).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
from torch import nn

from eovax_torch.models.sr_diffusion import make_sampler

@dataclasses.dataclass
class SRTrainState:
    """The step and the denoiser's backbone, which holds the parameters (the
    JAX package's ``params``); the optimizer state comes with training."""

    step: int
    model: nn.Module


@dataclasses.dataclass
class DiffusionSuperRes:
    """Stage-3 model: a denoiser (``SimpleDenoiser``/``KarrasDenoiser``), its
    backbone ``init_params`` (the UNet holding the initial parameters) and a
    sampler by name (DDIM-50 by default)."""

    denoiser: Any
    init_params: nn.Module
    sampler_steps: int = 50
    # "ddim" (reference parity) or "dpm++2m" (second order, about half the steps).
    sampler_type: str = "ddim"

    def __post_init__(self):
        self.sampler = make_sampler(self.sampler_type, self.denoiser, steps=self.sampler_steps)

    def init_state(self) -> SRTrainState:
        """Step 0 on a copy of ``init_params`` (training will not move the initial
        parameters), in eval mode."""
        return SRTrainState(step=0, model=copy.deepcopy(self.init_params).eval())

    @torch.inference_mode()
    def sample(self, state: SRTrainState, shape, cond, seed: int = 0) -> torch.Tensor:
        """Sample [B, C, H, W] latents for ``cond`` [B, Cc, H, W] (NCHW) from x1
        drawn with ``torch.Generator(device).manual_seed(seed)`` on the model's
        device (super_res.py:146-158)."""
        device = next(state.model.parameters()).device
        cond = torch.as_tensor(cond, dtype=torch.float32, device=device).contiguous()
        if cond.shape[0] != shape[0]:
            raise ValueError(
                f"sample batch mismatch: shape[0]={shape[0]} vs cond batch {cond.shape[0]}")
        generator = torch.Generator(device).manual_seed(seed)
        x1 = self.sampler.init(generator, (cond.shape[0], *shape[1:]))
        return self.sampler(state.model, x1, cond=cond)

