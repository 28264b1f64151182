"""Stage 2 — multi-modal VAE finetuning: the train step and the trainer.

Port of ``eovax/train/stage2.py``: the optimizer (Adam after a global-norm
clip, on the reference's cosine-warmup schedule, with optional gradient
accumulation), the ``freeze_body`` mask, the train step, the EQ-VAE target,
the eval step, the host-side EQ-VAE mode roll, and ``Stage2Trainer``, the
host-side loop with validation, checkpoints, resume and preemption. The
model's parameters and latent BatchNorm statistics live in the
``EOVAECore``; a step updates them in place.

Optax's semantics are kept where they differ from torch's habits: the clip
scales by max/norm only when the norm exceeds max (no +1e-6), the learning
rate of the n-th applied update is ``schedule(n)`` with n counted from 0,
``train/grad_norm`` is the norm after the freeze mask and before the clip,
and accumulation is ``optax.MultiSteps``' (see :class:`ClippedAdam`).

Not ported yet: the adversarial branch (ROADMAP Queue 1 item 4), the
TerraMesh batches and their on-device preparation (item 3c) and data
parallelism (item 3d).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from eovax_torch.core.config import VAEConfig
from eovax_torch.core.device import resolve_device
from eovax_torch.models.backbone import EOVAECore
from eovax_torch.train.schedule import STAGE2_STEPS_PER_EPOCH, cosine_warmup_schedule
from eovax_torch.utils.checkpoint import TrainCheckpointer, host_copy
from eovax_torch.utils.preemption import PreemptionGuard
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
    """``optax.chain(clip_by_global_norm(clip_grad), adam(schedule))`` in torch
    foreach ops, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and its
    arithmetic: mu ← (1 − b1)·g + b1·mu, nu ← (1 − b2)·g² + b2·nu, the bias
    corrections 1 − bᵗ in float32, and the update −lr·m̂/(√n̂ + eps).
    ``torch.optim.Adam`` takes the bias corrections in float64, where
    1 − float32(0.999) is 1.3e-5 off 0.001, and so moved the first update by
    6.4e-6 of itself away from the JAX package's.

    With ``accumulate_steps`` k > 1 it is ``optax.MultiSteps`` of that chain:
    each micro-step folds its gradients into a running mean,
    ``acc + (g − acc)/(n + 1)``; every k-th micro-step the clip and Adam run
    once on the mean and the mean is zeroed; on the others the parameters
    do not move. ``count``, the number of updates applied, is Adam's step
    and the schedule's count. This is not torch's habit of summing ``.grad``
    over k backwards: the mean, the clip of the mean and the count differ.

    As in optax, a parameter without a gradient has a zero one.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, schedule: Callable[[int], float] | float,
                 clip_grad: float | None, accumulate_steps: int = 1):
        self.params = list(params)
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.accumulate_steps = accumulate_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params] if accumulate_steps > 1
                    else [])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def lr(self, step: int) -> float:
        return self.schedule(step) if callable(self.schedule) else self.schedule

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One micro-step on the parameters' ``.grad``; returns the global norm of
        its gradients before any clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.nn.utils.get_total_norm(grads)
        if self.accumulate_steps == 1:
            self._apply(grads, norm)
            return norm
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, self.mini_step + 1)
        torch._foreach_add_(self.acc, delta)
        self.mini_step += 1
        if self.mini_step == self.accumulate_steps:
            torch._foreach_copy_(grads, self.acc)
            self._apply(grads, torch.nn.utils.get_total_norm(grads))
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        return norm

    def _apply(self, grads: list[torch.Tensor], norm: torch.Tensor) -> None:
        """Clip, then one Adam update at ``lr(count)``."""
        if self.clip_grad:
            # optax: g where norm < max, else g / norm · max.
            torch._foreach_mul_(grads, torch.clamp(self.clip_grad / norm, max=1.0))
        lr = self.lr(self.count)
        self.count += 1
        bc1 = float(1 - np.float32(self.B1) ** self.count)
        bc2 = float(1 - np.float32(self.B2) ** self.count)
        # In place, with one temporary list: each foreach op costs the host a
        # pass over every parameter, and the host paces the step.
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.B2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / bc1)

    def state_dict(self) -> dict[str, Any]:
        """Adam's moments and update count, and the accumulator with its micro-step."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu),
                "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        if len(state["acc"]) != len(self.acc):
            raise ValueError(f"the state holds an accumulator of {len(state['acc'])} tensors, "
                             f"this optimizer has {len(self.acc)} (another accumulate_steps?)")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for ours, saved in zip(self.mu + self.nu + self.acc,
                               state["mu"] + state["nu"] + state["acc"], strict=True):
            ours.copy_(saved)


def make_optimizer(cfg: VAEConfig, params, total_steps: int | None = None,
                   accumulate_steps: int = 1) -> tuple[ClippedAdam, Callable[[int], float] | float]:
    """Adam + cosine warmup + global-norm clip, accumulated over
    ``accumulate_steps`` micro-steps, as the JAX package's ``make_optimizer``;
    returns (optimizer, schedule)."""
    if all(v is not None for v in (cfg.final_lr, cfg.warmup_epochs, cfg.decay_end_epoch)):
        schedule = cosine_warmup_schedule(
            cfg.base_lr, cfg.final_lr, cfg.warmup_epochs * STAGE2_STEPS_PER_EPOCH,
            total_steps or cfg.decay_end_epoch * STAGE2_STEPS_PER_EPOCH,
        )
    else:
        schedule = cfg.base_lr
    return ClippedAdam(params, schedule, cfg.clip_grad, accumulate_steps), schedule


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
        logs["train/grad_norm"] = optimizer.step()
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


@dataclasses.dataclass
class Stage2Trainer:
    """Host-side training loop: EQ-VAE mode rolls, host-to-device batch
    copies, metric logging, validation with the image grid and the best
    checkpoint, background step checkpoints, resume and preemption.

    ``model`` is an ``EOFluxVAE``; its core trains in place on its device,
    and the state that the loop passes around is the step counter. A
    checkpoint holds what the JAX package's ``TrainState`` holds: the step,
    the parameters and latent BatchNorm statistics (the core's state dict)
    and the optimizer's state with the accumulator. On resume the mode roll's
    ``random.Random(seed)`` and the torch generator start again from the
    seed, as the JAX trainer's do.
    """

    model: Any
    loss_obj: Any
    cfg: VAEConfig
    max_steps: int = 1000
    val_every: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    val_max_batches: int = 100
    # The best checkpoint is the one with the least validation mean of this.
    monitor: str = "val/loss_rec"
    log_every: int = 100
    logger: Any = None
    image_logger: Any = None  # utils.image_logger.ImageLogger (val batch 0)
    norm_scheme: str = "legacy"  # display denormalization of the image grid
    accumulate_steps: int = 1
    seed: int = 0

    def __post_init__(self):
        if hasattr(self.loss_obj, "generator_loss"):
            raise NotImplementedError(
                "adversarial losses (a discriminator alternating with the generator) are not "
                "ported yet: ROADMAP Queue 1 item 4")
        self.device = resolve_device(self.model.device)
        self.core = self.model.core
        self.optimizer, self.schedule = make_optimizer(
            self.cfg, self.core.parameters(), total_steps=self.max_steps,
            accumulate_steps=self.accumulate_steps)
        self._train_step = make_train_step(self.core, self.loss_obj, self.optimizer, self.cfg,
                                           schedule=self.schedule)
        self._eval_step = make_eval_step(self.core, self.loss_obj)
        self._rng = random.Random(self.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._ckptr = None

    # -- loops -----------------------------------------------------------------

    def fit(self, train_iter: Iterator[dict],
            val_iter_factory: Callable[[], Iterator[dict]] | None = None,
            state: TrainState | None = None) -> TrainState:
        if state is None and self.ckpt_dir:
            # Resume from the latest saved step (preemption recovery).
            state = self.restore_checkpoint()
            if state is not None:
                print(f"[stage2] resumed from checkpoint at step {state.step}")
        state = state if state is not None else TrainState()
        t0 = time.time()
        with PreemptionGuard() as guard:
            for i, batch in enumerate(train_iter):
                if state.step >= self.max_steps:
                    # max_steps is the global budget: a resumed run finishes the
                    # remaining steps (the schedule was built for max_steps).
                    break
                logs = self.train_on_batch(state, batch)
                if guard.should_stop(state.step):
                    # Checked before the periodic saves and validation, so that
                    # the work after a signal is one step; the tail save below
                    # makes this step the resume point.
                    print(f"[stage2] preemption signal — stopping at step {state.step} "
                          "(checkpoint will be saved)")
                    break
                if self.log_every and (i + 1) % self.log_every == 0:
                    self._log(state.step, logs, t0, i + 1)
                if self.ckpt_every and self.ckpt_dir and (i + 1) % self.ckpt_every == 0:
                    self.save_checkpoint(state)
                if self.val_every and val_iter_factory and (i + 1) % self.val_every == 0:
                    self.validate(state, val_iter_factory(), self.val_max_batches)
        if self.ckpt_dir:
            self.save_checkpoint(state)
            self.checkpointer.wait()
        return state

    def train_on_batch(self, state: TrainState, batch: dict) -> dict[str, Any]:
        """One micro-step on a host batch: roll the EQ-VAE mode, copy the batch
        to the device, take the train step. Returns its logs (tensors)."""
        scale, angle = roll_mode(self._rng, self.cfg)
        image, wvs = self._place(batch)
        return self._train_step(state, image, wvs, self._generator, scale=scale, angle=angle)

    def _place(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The NHWC numpy batch as a contiguous NCHW tensor on the model's
        device (the kernels take contiguous NCHW only), and its wavelengths."""
        image = torch.from_numpy(np.asarray(batch["image"], np.float32)).to(self.device)
        wvs = torch.from_numpy(np.asarray(batch["wvs"], np.float32)).to(self.device)
        return image.permute(0, 3, 1, 2).contiguous(), wvs

    def validate(self, state: TrainState, val_iter: Iterator[dict],
                 max_batches: int = 100) -> dict[str, float]:
        """Mean validation logs over at most ``max_batches`` batches; logs them,
        writes the image grid of batch 0 and saves the best checkpoint."""
        agg: dict[str, list[float]] = {}
        for i, batch in enumerate(val_iter):
            if i >= max_batches:
                break
            image, wvs = self._place(batch)
            if i == 0 and self.image_logger is not None:
                with torch.no_grad():
                    self.core.eval()
                    recon, _ = self.core(image, wvs, sample_posterior=False)
                self.image_logger.log(
                    _host_nhwc(image), _host_nhwc(recon),
                    modality=batch.get("modality", "S2RGB"), norm_scheme=self.norm_scheme,
                    step=state.step)
            logs = self._eval_step(state, image, wvs, self._generator)
            for name, v in logs.items():
                agg.setdefault(name, []).append(float(v))
        # Sorted, as the JAX package's logs come out of its jitted steps.
        means = {k: float(np.mean(v)) for k, v in sorted(agg.items())}
        if self.logger is not None and means:
            self.logger.log(state.step, means)
        if self.ckpt_dir and self.monitor and self.monitor in means:
            if self.checkpointer.save_best(state.step, self._checkpoint(state),
                                            means[self.monitor], monitor=self.monitor):
                print(f"[stage2] new best {self.monitor}={means[self.monitor]:.6g} "
                      f"at step {state.step}")
        return means

    # -- io ----------------------------------------------------------------------

    @property
    def checkpointer(self) -> TrainCheckpointer:
        """The run's checkpoints under ``ckpt_dir``: ``wait()`` joins a write in
        flight, ``best_info()`` describes the best checkpoint."""
        if self._ckptr is None:
            self._ckptr = TrainCheckpointer(self.ckpt_dir)
        return self._ckptr

    def _checkpoint(self, state: TrainState) -> dict[str, Any]:
        return {"step": state.step, "model": self.core.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def _load(self, checkpoint: dict[str, Any] | None) -> TrainState | None:
        if checkpoint is None:
            return None
        self.core.load_state_dict(checkpoint["model"])
        self.optimizer.load_state_dict(checkpoint["optimizer"])
        return TrainState(step=int(checkpoint["step"]))

    def save_checkpoint(self, state: TrainState) -> bool:
        """Blocks for the copy into host memory; the write overlaps the next
        steps. Returns whether a save was started (a step already saved is not)."""
        return self.checkpointer.save(state.step, self._checkpoint(state))

    def restore_checkpoint(self) -> TrainState | None:
        """Load the latest saved step into the model and the optimizer (None if
        there is none)."""
        return self._load(self.checkpointer.restore_latest())

    def restore_best(self) -> TrainState | None:
        """Load the best checkpoint by ``monitor`` into the model and the optimizer
        (None if validation never saved one)."""
        return self._load(self.checkpointer.restore_best())

    def _log(self, step: int, logs: dict, t0: float, steps_this_run: int) -> None:
        scalars = {k: float(v) for k, v in sorted(logs.items())}
        # The rate over this run only: after a resume, `step` counts earlier runs too.
        scalars["train/steps_per_sec"] = steps_this_run / max(time.time() - t0, 1e-9)
        if self.logger is not None:
            self.logger.log(step, scalars)
        else:
            msg = ", ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items()))
            print(f"[stage2 step {step}] {msg}")

    def export_variables(self) -> dict[str, torch.Tensor]:
        """The model's state dict (parameters and BatchNorm statistics) on the host."""
        return host_copy(self.core.state_dict())


def _host_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()
