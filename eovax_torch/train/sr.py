"""Stage 3 — latent-diffusion super-resolution: training and sampling.

Port of ``eovax/train/sr.py``: ``DiffusionSuperRes`` trains a conditional
denoiser on (LR latent → HR latent) pairs with t ~ U(0, 1) per sample,
validates by full sampling and the MSE against the HR latent, and samples.
Under a process group (``parallel.mesh``, one process per card) each rank
trains on its rows of the global batch: t, the noise and the validation's x1
are drawn at the global batch's shape and each rank keeps its rows, the
optimizer averages the gradients over the ranks, the logged loss and the
validation MSE are means over the ranks, and rank 0 alone writes the
checkpoints (and, given its loggers alone, the image grid and the CSV rows).

The optimizer is stage 2's ``ClippedAdam`` (optax's clip, then Adam) on the
reference's cosine warmup with ``SR_STEPS_PER_EPOCH``. t, the noise and the
validation's x1 are drawn from the trainer's ``torch.Generator`` (seeded with
``seed`` on the model's device), in the order the JAX trainer splits its key:
t, then the noise. A checkpoint holds the step, the UNet, the optimizer's
state and the generator's state, and a step's validation runs before its
save, so a run resumed from a step that ``val_every`` divides takes the draws
a run without a stop would have taken (``val_every`` and ``ckpt_every``
count the steps of the current run, as in the JAX fit).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn

from eovax_torch.models.sr_diffusion import make_sampler
from eovax_torch.parallel.mesh import (
    DataMesh,
    global_rows,
    make_mesh,
    mean_over_ranks,
    place_batch,
)
from eovax_torch.train.schedule import SR_STEPS_PER_EPOCH, cosine_warmup_schedule
from eovax_torch.train.stage2 import ClippedAdam
from eovax_torch.utils.checkpoint import TrainCheckpointer
from eovax_torch.utils.preemption import PreemptionGuard


@dataclasses.dataclass
class SRTrainState:
    """The step, the denoiser's backbone (which holds the parameters, the JAX
    package's ``params``) and the optimizer over its parameters."""

    step: int
    model: nn.Module
    optimizer: ClippedAdam


@dataclasses.dataclass
class DiffusionSuperRes:
    """Stage-3 trainer: a denoiser (``SimpleDenoiser``/``KarrasDenoiser``), its
    backbone ``init_params`` (the UNet holding the initial parameters, on the
    device to train on), a sampler by name (DDIM-50 by default) and the
    reference's optimizer settings (super_res.py:42-75)."""

    denoiser: Any
    init_params: nn.Module
    sampler_steps: int = 50
    # "ddim" (reference parity) or "dpm++2m" (second order, about half the steps).
    sampler_type: str = "ddim"
    base_lr: float = 1e-4
    final_lr: float | None = None
    warmup_epochs: int | None = None
    decay_end_epoch: int | None = None
    grad_clip: float | None = 1.0  # trainer.gradient_clip_val (eo_vae_latent.yaml:20)
    log_every: int = 20
    # Under a process group, give the loggers on rank 0 alone (None elsewhere).
    logger: Any = None
    image_logger: Any = None  # utils.image_logger.SuperResImageLogger
    # Step checkpoints every ckpt_every steps under ckpt_dir, resume from the
    # latest in fit(), the best by `monitor` under ckpt_dir/best.
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    val_max_batches: int = 10  # Lightning's limit_val_batches
    monitor: str = "val_mse"
    seed: int = 0
    mesh: DataMesh | None = None  # parallel.mesh.make_mesh on the UNet's device by default

    def __post_init__(self):
        if all(v is not None for v in (self.final_lr, self.warmup_epochs,
                                       self.decay_end_epoch)):
            self.schedule = cosine_warmup_schedule(
                self.base_lr, self.final_lr, self.warmup_epochs * SR_STEPS_PER_EPOCH,
                self.decay_end_epoch * SR_STEPS_PER_EPOCH)
        else:
            self.schedule = self.base_lr
        self.sampler = make_sampler(self.sampler_type, self.denoiser, steps=self.sampler_steps)
        self.device = next(self.init_params.parameters()).device
        self.mesh = self.mesh or make_mesh(self.device)
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self._ckptr = None

    def init_state(self) -> SRTrainState:
        """Step 0 on a copy of ``init_params`` (training does not move the
        initial parameters), in eval mode, with a fresh optimizer."""
        model = copy.deepcopy(self.init_params).eval()
        return SRTrainState(step=0, model=model,
                            optimizer=ClippedAdam(model.parameters(), self.schedule,
                                                  self.grad_clip))

    # -- steps -------------------------------------------------------------------

    def train_step(self, state: SRTrainState, hr: torch.Tensor, lr_cond: torch.Tensor, *,
                   t: torch.Tensor | None = None, eps: torch.Tensor | None = None
                   ) -> dict[str, Any]:
        """One update on an NCHW fp32 batch on the model's device; t ~ U(0, 1)
        and the noise come from the trainer's generator unless given. Updates
        the model, the optimizer and ``state.step`` in place; returns
        ``train_loss`` (and ``lr`` on a schedule) as tensors/floats."""
        if t is None:  # over the global batch, each rank keeping its rows
            t = global_rows(lambda shape: torch.rand(shape, generator=self.generator,
                                                     device=self.device), hr.shape[:1])
        state.optimizer.zero_grad()
        loss = self.denoiser.loss(state.model, hr, t, cond=lr_cond, eps=eps,
                                  generator=self.generator)
        loss.backward()
        state.optimizer.step()
        logs = mean_over_ranks({"train_loss": loss.detach()})
        if callable(self.schedule):
            logs["lr"] = self.schedule(state.step)  # LearningRateMonitor (train_super_res.py:77)
        state.step += 1
        return dict(sorted(logs.items()))  # in the order of the JAX step's outputs

    @torch.inference_mode()
    def _val_step(self, state: SRTrainState, hr: torch.Tensor, lr_cond: torch.Tensor
                 ) -> torch.Tensor:
        """fp32 MSE of a full sampler run from an x1 drawn from the trainer's
        generator (over the global batch, this rank's rows) against ``hr``."""
        x1 = global_rows(lambda shape: self.sampler.init(self.generator, shape), hr.shape)
        x0 = self.sampler(state.model, x1, cond=lr_cond)
        return torch.mean((x0 - hr.float()) ** 2)

    def _place(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's NHWC (hr, lr) pair as contiguous NCHW fp32 tensors on its
        device (the kernels take contiguous NCHW only): numpy arrays are copied
        there, tensors already there (the flow-refine adapter's) stay."""
        placed = place_batch({k: batch[k].float() if torch.is_tensor(batch[k])
                              else np.asarray(batch[k], np.float32)
                              for k in ("image_hr", "image_lr")}, self.mesh)
        return tuple(placed[k].permute(0, 3, 1, 2).contiguous()
                     for k in ("image_hr", "image_lr"))

    # -- loops -------------------------------------------------------------------

    def fit(self, train_iter: Iterator[dict],
            val_iter_factory: Callable[[], Iterator[dict]] | None = None,
            max_steps: int = 1000, val_every: int = 0,
            state: SRTrainState | None = None) -> SRTrainState:
        if state is None and self.ckpt_dir:
            # Resume from the latest saved step (preemption recovery).
            state = self.restore_checkpoint()
            if state is not None:
                print(f"[sr] resumed from checkpoint at step {state.step}")
        state = state if state is not None else self.init_state()
        t0 = time.time()
        # sync_every=10: under a group the ranks' agreement waits for the queued
        # device work; every 10 steps bounds the stop's delay without a stall a step.
        with PreemptionGuard(sync_every=10) as guard:
            for i, batch in enumerate(train_iter):
                # max_steps is the global budget: a run resumed at step N takes
                # the remaining max_steps − N steps.
                if state.step >= max_steps:
                    break
                logs = self.train_step(state, *self._place(batch))
                if guard.should_stop(state.step):
                    # Checked before the periodic saves and validation, so that the
                    # work after a signal is one step; the tail save below makes
                    # this step the resume point.
                    print(f"[sr] preemption signal — stopping at step {state.step} "
                          "(checkpoint will be saved)")
                    break
                if self.log_every and (i + 1) % self.log_every == 0:
                    scalars = {k: float(v) for k, v in logs.items()}
                    # The rate over this run only; rows keyed by the global step.
                    scalars["steps_per_sec"] = (i + 1) / max(time.time() - t0, 1e-9)
                    if self.logger is not None:
                        self.logger.log(state.step, scalars)
                # Validation before the step's save (the JAX fit saves first): its x1
                # draws advance the generator, and the checkpoint holds the state the
                # next step starts from.
                if val_every and val_iter_factory and (i + 1) % val_every == 0:
                    self.validate(state, val_iter_factory(), self.val_max_batches)
                if self.ckpt_every and self.ckpt_dir and (i + 1) % self.ckpt_every == 0:
                    self.save_checkpoint(state)
        if self.ckpt_dir:
            self.save_checkpoint(state)
            self.checkpointer.wait()
        return state

    def validate(self, state: SRTrainState, val_iter: Iterator[dict],
                 max_batches: int = 10) -> dict[str, float]:
        """Mean ``val_mse`` over at most ``max_batches`` batches (and over the
        ranks); logs it, writes the LR | prediction | HR grid of batch 0
        (sampled with ``seed``) and saves the best checkpoint by
        ``monitor``."""
        mses = []
        for i, batch in enumerate(val_iter):
            if i >= max_batches:
                break
            hr, lr_cond = self._place(batch)
            if i == 0 and self.image_logger is not None:
                pred = self.sample(state, hr.shape, lr_cond, seed=self.seed)
                self.image_logger.log(*(_host_nhwc(x) for x in (lr_cond, pred, hr)),
                                      step=state.step)
            mses.append(float(self._val_step(state, hr, lr_cond)))
        result = mean_over_ranks({"val_mse": float(np.mean(mses))} if mses else {})
        if self.logger is not None and result:
            self.logger.log(state.step, result)
        if self.ckpt_dir and self.monitor and self.monitor in result:
            if self.checkpointer.save_best(state.step, self._checkpoint(state),
                                            result[self.monitor], monitor=self.monitor):
                print(f"[sr] new best {self.monitor}={result[self.monitor]:.6g} "
                      f"at step {state.step}")
        return result

    @torch.inference_mode()
    def sample(self, state: SRTrainState, shape, cond, seed: int = 0) -> torch.Tensor:
        """Sample [B, C, H, W] latents for ``cond`` [B, Cc, H, W] (NCHW) from x1
        drawn with ``torch.Generator(device).manual_seed(seed)`` on the model's
        device (super_res.py:146-158); under a process group x1 is this rank's
        rows of a draw over the global batch."""
        device = next(state.model.parameters()).device
        cond = torch.as_tensor(cond, dtype=torch.float32, device=device).contiguous()
        if cond.shape[0] != shape[0]:
            raise ValueError(
                f"sample batch mismatch: shape[0]={shape[0]} vs cond batch {cond.shape[0]}")
        generator = torch.Generator(device).manual_seed(seed)
        x1 = global_rows(lambda s: self.sampler.init(generator, s), (cond.shape[0], *shape[1:]))
        return self.sampler(state.model, x1, cond=cond)

    # -- io ----------------------------------------------------------------------

    @property
    def checkpointer(self) -> TrainCheckpointer:
        """The run's checkpoints under ``ckpt_dir``: ``wait()`` joins a write in
        flight, ``best_info()`` describes the best checkpoint."""
        if self._ckptr is None:
            self._ckptr = TrainCheckpointer(self.ckpt_dir)
        return self._ckptr

    def _checkpoint(self, state: SRTrainState) -> dict[str, Any]:
        return {"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def _load(self, checkpoint: dict[str, Any] | None) -> SRTrainState | None:
        if checkpoint is None:
            return None
        state = self.init_state()
        state.model.load_state_dict(checkpoint["model"])
        state.optimizer.load_state_dict(checkpoint["optimizer"])
        state.step = int(checkpoint["step"])
        self.generator.set_state(checkpoint["generator"])
        return state

    def save_checkpoint(self, state: SRTrainState) -> bool:
        """Blocks for the copy into host memory; the write overlaps the next
        steps. Returns whether a save was started (a step already saved is not)."""
        return self.checkpointer.save(state.step, self._checkpoint(state))

    def restore_checkpoint(self) -> SRTrainState | None:
        """The latest saved step, with the generator's state (None if there is none)."""
        return self._load(self.checkpointer.restore_latest())

    def restore_best(self) -> SRTrainState | None:
        """The best state by ``monitor`` (None if validation never saved one)."""
        return self._load(self.checkpointer.restore_best())


def _host_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()
