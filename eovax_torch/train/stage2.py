"""Stage 2 — multi-modal VAE finetuning: the generator train step.

Port of the step functions of ``eovax/train/stage2.py``: the optimizer (Adam
after a global-norm clip, on the reference's cosine-warmup schedule), the
``freeze_body`` mask, the train step, the EQ-VAE target, the eval step and
the host-side EQ-VAE mode roll. The model's parameters and latent BatchNorm
statistics live in the ``EOVAECore``; a step updates them in place.

Optax's semantics are kept where they differ from torch's habits: the clip
scales by max/norm only when the norm exceeds max (no +1e-6), the learning
rate of step t is ``schedule(t)`` with t counted from 0, and
``train/grad_norm`` is the norm after the freeze mask and before the clip.

The trainer loop (``Stage2Trainer``), checkpoints, logging, the train CLI,
TerraMesh data and data parallelism are not ported yet.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable

import torch

from eovax_torch.core.config import VAEConfig
from eovax_torch.models.backbone import EOVAECore
from eovax_torch.train.schedule import STAGE2_STEPS_PER_EPOCH, cosine_warmup_schedule
from eovax_torch.utils.resize import resize_nhwc

SCALE_BINS = (0.375, 0.5, 0.75)


@dataclasses.dataclass
class TrainState:
    """The step counter; parameters, statistics and Adam's moments live in
    the model and the optimizer."""

    step: int = 0


def _freeze_mask(core: torch.nn.Module, freeze_body: bool) -> dict[str, bool]:
    """Trainable parameters by name: with ``freeze_body`` only the dynamic stems."""

    def trainable(name: str) -> bool:
        if not freeze_body:
            return True
        keys = name.split(".")
        return ("encoder" in keys and "conv_in" in keys) or (
            "decoder" in keys and "conv_out" in keys)

    return {name: trainable(name) for name, _ in core.named_parameters()}


def _mask_grads(core: torch.nn.Module, mask: dict[str, bool]) -> None:
    """Zero the gradients of frozen parameters in place."""
    for name, p in core.named_parameters():
        if not mask[name] and p.grad is not None:
            p.grad.zero_()


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(clip_grad), adam(schedule))`` on
    ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8, as optax's defaults)."""

    def __init__(self, params, schedule: Callable[[int], float] | float,
                 clip_grad: float | None):
        self.params = list(params)
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def lr(self, step: int) -> float:
        return self.schedule(step) if callable(self.schedule) else self.schedule

    def step(self, step: int) -> torch.Tensor:
        """Clip, then one Adam update at ``lr(step)``; returns the global norm of
        the gradients before the clip."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        if self.clip_grad:
            # optax: g where norm < max, else g / norm · max.
            torch._foreach_mul_(grads, torch.clamp(self.clip_grad / norm, max=1.0))
        for group in self.adam.param_groups:
            group["lr"] = self.lr(step)
        self.adam.step()
        return norm


def make_optimizer(cfg: VAEConfig, params, total_steps: int | None = None,
                   accumulate_steps: int = 1) -> tuple[ClippedAdam, Callable[[int], float] | float]:
    """Adam + cosine warmup + global-norm clip, as the JAX package's
    ``make_optimizer``; returns (optimizer, schedule)."""
    if accumulate_steps > 1:
        raise NotImplementedError(
            "accumulate_steps > 1 (optax.MultiSteps) is not ported yet: ROADMAP Queue 1 item 3b")
    if all(v is not None for v in (cfg.final_lr, cfg.warmup_epochs, cfg.decay_end_epoch)):
        schedule = cosine_warmup_schedule(
            cfg.base_lr, cfg.final_lr, cfg.warmup_epochs * STAGE2_STEPS_PER_EPOCH,
            total_steps or cfg.decay_end_epoch * STAGE2_STEPS_PER_EPOCH,
        )
    else:
        schedule = cfg.base_lr
    return ClippedAdam(params, schedule, cfg.clip_grad), schedule


def _eqvae_target(image: torch.Tensor, recon: torch.Tensor, scale, angle) -> torch.Tensor:
    """Area-downscale (and rotate) the input to the reconstruction's geometry."""
    target = image
    if scale is not None:
        target = resize_nhwc(target.permute(0, 2, 3, 1), tuple(recon.shape[2:]), mode="area")
        target = target.permute(0, 3, 1, 2)
    if angle is not None:
        target = torch.rot90(target, k=angle, dims=(3, 2))  # the JAX package's NHWC axes (2, 1)
    return target.detach()


def make_train_step(core: EOVAECore, loss_obj, optimizer: ClippedAdam, cfg: VAEConfig, *,
                    schedule=None):
    """The generator train step (non-adversarial losses):

        train_step(state, image, wvs, generator=None, *, scale=None, angle=None) → logs

    ``image`` is an NCHW fp32 batch on the model's device; ``generator`` feeds
    the posterior sample and the latent noise. The model, its statistics, the
    optimizer and ``state.step`` are updated in place.
    """
    mask = _freeze_mask(core, cfg.freeze_body)

    def train_step(state: TrainState, image: torch.Tensor, wvs: torch.Tensor,
                   generator: torch.Generator | None = None, *, scale=None,
                   angle=None) -> dict[str, Any]:
        core.train()  # train-mode dropout in the stem generators that carry it
        optimizer.zero_grad()
        recon, _ = core(image, wvs, generator=generator, sample_posterior=cfg.sample_posterior,
                        scale=scale, angle=angle, train=True,
                        latent_noise_p=cfg.latent_noise_p, noise_tau=cfg.noise_tau)
        target = _eqvae_target(image, recon, scale, angle)
        loss, logs = loss_obj(target, wvs, recon, global_step=state.step, split="train")
        loss.backward()
        _mask_grads(core, mask)
        logs["train/grad_norm"] = optimizer.step(state.step)
        if callable(schedule):
            logs["train/lr"] = schedule(state.step)
        state.step += 1
        return logs

    return train_step


def make_eval_step(core: EOVAECore, loss_obj):
    """The validation step: a sampled forward and the loss, with no update.

        eval_step(state, image, wvs, generator=None) → logs
    """

    @torch.no_grad()
    def eval_step(state: TrainState, image: torch.Tensor, wvs: torch.Tensor,
                  generator: torch.Generator | None = None) -> dict[str, Any]:
        core.eval()
        recon, _ = core(image, wvs, generator=generator, sample_posterior=True)
        _, logs = loss_obj(image, wvs, recon, global_step=state.step, split="val")
        return logs

    return eval_step


def roll_mode(rng: random.Random, cfg: VAEConfig):
    """Host-side EQ-VAE (scale, angle) of one step, as ``Stage2Trainer._roll_mode``."""
    scale = angle = None
    if rng.random() < cfg.p_prior:
        angle = rng.choice([1, 2, 3])
        scale = ((rng.choice(SCALE_BINS), rng.choice(SCALE_BINS)) if cfg.anisotropic
                 else rng.choice(SCALE_BINS))
    elif rng.random() < cfg.p_prior_s:
        scale = rng.choice(SCALE_BINS)
    return scale, angle
