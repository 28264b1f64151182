"""Stage 2 — multi-modal VAE finetuning: the train step and the trainer.

Port of ``eovax/train/stage2.py``: the optimizer (Adam after a global-norm
clip, on the reference's cosine-warmup schedule, with optional gradient
accumulation), the ``freeze_body`` mask, the train step, the adversarial
generator and discriminator steps, the EQ-VAE target, the eval step, the
host-side EQ-VAE mode roll, and ``Stage2Trainer``, the host-side loop with
validation, checkpoints, resume and preemption. The model's parameters and
latent BatchNorm statistics live in the ``EOVAECore``, the discriminator's
parameters and spectral-norm statistics in its module; a step updates them in
place.

Optax's semantics are kept where they differ from torch's habits: the clip
scales by max/norm only when the norm exceeds max (no +1e-6), the learning
rate of the n-th applied update is ``schedule(n)`` with n counted from 0,
``train/grad_norm`` is the norm after the freeze mask and before the clip,
and accumulation is ``optax.MultiSteps``' (see :class:`ClippedAdam`).

A batch collated in ``device_prep`` mode (the TerraMesh pipeline's, with
per-sample normalization and D4 descriptors) is copied to the device in its
stored dtype and prepared there by ``data.device_prep.device_prepare``.

Data parallel (``parallel.mesh``), one process per card: each rank trains on
its rows of the global batch; :class:`ClippedAdam` averages each micro-step's
gradients over the ranks before its norm, so the norm, the clip, Adam and the
accumulation see the global gradient, as under XLA's psum; the steps' logged
scalars and the validation means are means over the ranks; rank 0 writes the
checkpoints (and, given its loggers alone, the image grid and the CSV rows).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from eovax_torch.core.config import VAEConfig
from eovax_torch.core.device import process_count, resolve_device
from eovax_torch.data.device_prep import device_prepare
from eovax_torch.models.backbone import EOVAECore
from eovax_torch.parallel.mesh import (
    DataMesh,
    average_gradients,
    make_mesh,
    mean_over_ranks,
    place_batch,
)
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

    As in optax, a parameter without a gradient has a zero one. Under a
    process group the micro-step's gradients are then averaged over the ranks
    (``parallel.mesh.average_gradients``, every rank the same tensors in the
    same order), before the norm.
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
        average_gradients(grads)
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
        logs = mean_over_ranks(logs)
        if callable(schedule):
            logs["train/lr"] = schedule(state.step)
        state.step += 1
        return logs

    return train_step


def make_adversarial_steps(core: EOVAECore, loss_obj, optimizer: ClippedAdam,
                           discriminator: torch.nn.Module, disc_optimizer: ClippedAdam,
                           cfg: VAEConfig, *, schedule=None):
    """The generator/discriminator alternation of an adversarial loss:

        gen_step(state, image, wvs, generator=None, *, scale=None, angle=None)
            → (logs, recon, target)
        disc_step(state, target, wvs, recon) → logs

    ``gen_step`` runs ``forward_gan`` so that the loss's adaptive weight can
    differentiate its terms with respect to the generated output-stem kernel
    (``conv_out``'s weight for a static decoder), and updates the model only:
    its backward leaves no gradient in the discriminator. It returns the
    detached reconstruction and the EQ-VAE target for ``disc_step``, which
    stores one spectral-norm power-iteration step, then takes the
    discriminator's loss on them and one Adam step of its own optimizer.
    """
    mask = _freeze_mask(core, cfg.freeze_body)
    params = list(core.parameters())

    def gen_step(state: TrainState, image: torch.Tensor, wvs: torch.Tensor,
                 generator: torch.Generator | None = None, *, scale=None,
                 angle=None) -> tuple[dict[str, Any], torch.Tensor, torch.Tensor]:
        core.train()
        optimizer.zero_grad()
        recon, _, _, kernel, _ = core.forward_gan(
            image, wvs, generator=generator, sample_posterior=cfg.sample_posterior, scale=scale,
            angle=angle, train=True, latent_noise_p=cfg.latent_noise_p,
            noise_tau=cfg.noise_tau)
        if kernel is None:  # a static decoder: its conv_out weight
            kernel = core.decoder.conv_out.weight
        target = _eqvae_target(image, recon, scale, angle)
        loss, logs = loss_obj.generator_loss(discriminator, target, wvs, recon,
                                             global_step=state.step, kernel=kernel,
                                             split="train")
        loss.backward(inputs=params)
        _mask_grads(core, mask)
        logs["train/grad_norm"] = optimizer.step()
        logs = mean_over_ranks(logs)
        if callable(schedule):
            logs["train/lr"] = schedule(state.step)
        state.step += 1
        return logs, recon.detach(), target

    def disc_step(state: TrainState, target: torch.Tensor, wvs: torch.Tensor,
                  recon: torch.Tensor) -> dict[str, Any]:
        disc_optimizer.zero_grad()
        if hasattr(discriminator, "update_spectral_stats"):
            discriminator.update_spectral_stats()
        d_loss, logs = loss_obj.discriminator_loss(discriminator, target, wvs, recon,
                                                   split="train")
        d_loss.backward()
        disc_optimizer.step()
        return mean_over_ranks(logs)

    return gen_step, disc_step


def make_eval_step(core: EOVAECore, loss_obj, discriminator: torch.nn.Module | None = None):
    """The validation step: a sampled forward and the loss, with no update. An
    adversarial loss scores the reconstruction with the discriminator at a
    weight of 1.

        eval_step(state, image, wvs, generator=None) → logs
    """

    @torch.no_grad()
    def eval_step(state: TrainState, image: torch.Tensor, wvs: torch.Tensor,
                  generator: torch.Generator | None = None) -> dict[str, Any]:
        core.eval()
        recon, _ = core(image, wvs, generator=generator, sample_posterior=True)
        if hasattr(loss_obj, "generator_loss"):
            _, logs = loss_obj.generator_loss(discriminator, image, wvs, recon,
                                              global_step=state.step, split="val")
        else:
            _, logs = loss_obj(image, wvs, recon, global_step=state.step, split="val")
        return logs

    return eval_step


def loss_networks(loss_obj) -> list[torch.nn.Module]:
    """The modules a loss holds in its fields: its frozen feature networks."""
    if not dataclasses.is_dataclass(loss_obj):
        return []
    return [v for f in dataclasses.fields(loss_obj)
            if isinstance(v := getattr(loss_obj, f.name), torch.nn.Module)]


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
    and the optimizer's state with the accumulator; with an adversarial loss
    also the discriminator's parameters and spectral-norm statistics and its
    Adam state. On resume the mode roll's ``random.Random(seed)`` and the
    torch generator start again from the seed, as the JAX trainer's do.

    An adversarial loss (one with ``generator_loss``) needs ``discriminator``,
    which is moved to the model's device and kept in eval mode (no stem
    dropout, as in the JAX package). It trains with its own Adam at
    ``base_lr`` (no clip, no schedule) on every micro-step at and after the
    loss's discriminator start while ``disc_weight`` > 0; the generator's
    optimizer accumulates as without it. ``seed_disc_stem`` copies the
    encoder's ``conv_in`` parameters into the discriminator's
    ``dynamic_input`` (the reference's stem injection).

    A frozen network that the loss holds as a module (the factory's DOFA
    ``DOFALPIPS`` or ``DOFAFeatures``) is moved to the model's device once,
    here; it takes no optimizer and no place in the checkpoints.

    ``mesh`` (``parallel.mesh.make_mesh`` on the model's device by default)
    is the data mesh: under a process group every rank runs the same fit on
    its rows of each global batch (every rank the same number), the preemption
    guard agrees on a stop step every 10 steps, validation averages its means
    over the ranks (the best checkpoint follows the global monitor), rank 0
    alone writes the checkpoints and every rank resumes from the same file.
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
    # Under a process group, give the loggers on rank 0 alone (None elsewhere).
    logger: Any = None
    discriminator: Any = None  # an nn.Module; required for adversarial losses
    seed_disc_stem: bool = False  # copy encoder conv_in → discriminator dynamic_input
    image_logger: Any = None  # utils.image_logger.ImageLogger (val batch 0)
    norm_scheme: str = "legacy"  # display denormalization of the image grid
    accumulate_steps: int = 1
    seed: int = 0
    mesh: DataMesh | None = None

    def __post_init__(self):
        self.device = resolve_device(self.model.device)
        self.mesh = self.mesh or make_mesh(self.device)
        self.core = self.model.core
        self.optimizer, self.schedule = make_optimizer(
            self.cfg, self.core.parameters(), total_steps=self.max_steps,
            accumulate_steps=self.accumulate_steps)
        for net in loss_networks(self.loss_obj):
            net.to(self.device)
        self.adversarial = hasattr(self.loss_obj, "generator_loss")
        self.disc_optimizer = None
        if self.adversarial:
            if self.discriminator is None:
                raise ValueError("adversarial loss requires a discriminator module")
            self.discriminator.to(self.device).eval()
            if self.seed_disc_stem:
                self.discriminator.dynamic_input.load_state_dict(
                    self.core.encoder.conv_in.state_dict())
            self.disc_optimizer = ClippedAdam(self.discriminator.parameters(), self.cfg.base_lr,
                                              clip_grad=None)
            self._gen_step, self._disc_step = make_adversarial_steps(
                self.core, self.loss_obj, self.optimizer, self.discriminator,
                self.disc_optimizer, self.cfg, schedule=self.schedule)
        else:
            self._train_step = make_train_step(self.core, self.loss_obj, self.optimizer,
                                               self.cfg, schedule=self.schedule)
        self._eval_step = make_eval_step(self.core, self.loss_obj, self.discriminator)
        self._rng = random.Random(self.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._ckptr = None
        self._wvs_cache: dict[str, torch.Tensor] = {}  # device_prep: wvs per modality

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
        # sync_every=10: under a group the ranks' agreement waits for the queued
        # device work; every 10 steps bounds the stop's delay without a stall a step.
        with PreemptionGuard(sync_every=10) as guard:
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
        to the device, take the train step (with an adversarial loss the
        generator step, then the discriminator step once it has started).
        Returns its logs (tensors) in the JAX trainer's order: the generator
        step's sorted, then the discriminator step's sorted."""
        scale, angle = roll_mode(self._rng, self.cfg)
        image, wvs = self._place(batch)
        if not self.adversarial:
            logs = self._train_step(state, image, wvs, self._generator, scale=scale,
                                    angle=angle)
            return dict(sorted(logs.items()))
        step = state.step
        logs, recon, target = self._gen_step(state, image, wvs, self._generator, scale=scale,
                                             angle=angle)
        logs = dict(sorted(logs.items()))
        # The discriminator starts at disc_start (EOPatchLoss) or
        # disc_update_start_step (EOGenerativeLoss).
        start = getattr(self.loss_obj, "disc_start",
                        getattr(self.loss_obj, "disc_update_start_step", 0))
        if step >= start and self.loss_obj.disc_weight > 0.0:
            logs.update(sorted(self._disc_step(state, target, wvs, recon).items()))
        return logs

    def _place(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's NHWC numpy batch as a contiguous NCHW fp32 tensor on its
        device (the kernels take contiguous NCHW only), and its wavelengths.

        A ``device_prep`` batch (one with ``norm_mean``) is copied in its
        stored dtype (int16 stays int16, half the bytes of an fp32 copy) with
        its per-sample descriptors, and normalized and augmented on the device
        by ``device_prepare``, which reads the ``d4`` draw on the host; its
        ``wvs`` are placed once per modality. Eval batches carry no ``d4`` and
        are not augmented. With several processes the raw image is made fp32
        first, as the JAX trainer does across hosts: the collate keeps the
        stored dtype where it resized nothing and gives fp32 where it resized,
        and the ranks' batches must agree."""
        if "norm_mean" not in batch:
            placed = place_batch({"image": np.asarray(batch["image"], np.float32),
                                  "wvs": np.asarray(batch["wvs"], np.float32)}, self.mesh)
            return placed["image"].permute(0, 3, 1, 2).contiguous(), placed["wvs"]
        modality = batch.get("modality", "?")
        wvs = self._wvs_cache.get(modality)
        if wvs is None:
            wvs = place_batch({"wvs": np.asarray(batch["wvs"], np.float32)}, self.mesh)["wvs"]
            self._wvs_cache[modality] = wvs
        image = batch["image"]
        if process_count() > 1 and image.dtype != np.float32:
            image = np.asarray(image, np.float32)
        placed = place_batch({"image": image, **{k: batch[k] for k in (
            "norm_mean", "norm_std", "norm_clip")}}, self.mesh)
        image = device_prepare(placed["image"], placed["norm_mean"], placed["norm_std"],
                               placed["norm_clip"], batch.get("d4"))  # the D4 draw stays on the host
        return image.permute(0, 3, 1, 2).contiguous(), wvs

    def validate(self, state: TrainState, val_iter: Iterator[dict],
                 max_batches: int = 100) -> dict[str, float]:
        """Mean validation logs over at most ``max_batches`` batches (and over
        the ranks); logs them, writes the image grid of batch 0 and saves the
        best checkpoint."""
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
        means = mean_over_ranks({k: float(np.mean(v)) for k, v in sorted(agg.items())})
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
        checkpoint = {"step": state.step, "model": self.core.state_dict(),
                      "optimizer": self.optimizer.state_dict()}
        if self.adversarial:
            checkpoint["discriminator"] = self.discriminator.state_dict()
            checkpoint["disc_optimizer"] = self.disc_optimizer.state_dict()
        return checkpoint

    def _load(self, checkpoint: dict[str, Any] | None) -> TrainState | None:
        if checkpoint is None:
            return None
        self.core.load_state_dict(checkpoint["model"])
        self.optimizer.load_state_dict(checkpoint["optimizer"])
        if self.adversarial:
            self.discriminator.load_state_dict(checkpoint["discriminator"])
            self.disc_optimizer.load_state_dict(checkpoint["disc_optimizer"])
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
        scalars = {k: float(v) for k, v in logs.items()}
        # The rate over this run only: after a resume, `step` counts earlier runs too.
        scalars["train/steps_per_sec"] = steps_this_run / max(time.time() - t0, 1e-9)
        if self.logger is not None:
            self.logger.log(step, scalars)
        elif self.mesh.rank == 0:  # one console line a step, not one a rank
            msg = ", ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items()))
            print(f"[stage2 step {step}] {msg}")

    def export_variables(self) -> dict[str, torch.Tensor]:
        """The model's state dict (parameters and BatchNorm statistics) on the host."""
        return host_copy(self.core.state_dict())


def _host_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()
