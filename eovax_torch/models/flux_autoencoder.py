"""Predecessor model classes kept for config and checkpoint compatibility.

Port of ``eovax/models/flux_autoencoder.py``:

- ``FluxAutoencoderKL``: the reference's older three-mode module
  (``training_mode`` ∈ {distill, finetune, flow-refine}) on the ``EOFluxVAE``
  latent pipeline and inference surface. Each mode maps onto a trainer of the
  port: ``distill`` onto ``eovax_torch.train.distill``, ``finetune`` onto
  ``Stage2Trainer``, ``flow-refine`` onto a rectified-flow UNet trained with
  ``DiffusionSuperRes`` to refine the frozen VAE's reconstructions.
- ``AutoencoderKL``: the first-generation LDM autoencoder, the same backbone
  with static conv stems (``use_dynamic_ops=False``).

The flow-refine adapter keeps the reconstruction on the device: the frozen
VAE reconstructs each batch there and the refiner's trainer receives the
device tensors, with no copy through the host.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping

import torch

from eovax_torch.core.config import DecoderConfig, EncoderConfig, VAEConfig
from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.models.eo_flux_vae import EOFluxVAE

TRAINING_MODES = ("distill", "finetune", "flow-refine")


class FluxAutoencoderKL(EOFluxVAE):
    """Three-mode autoencoder (distill / finetune / flow-refine)."""

    def __init__(self, config: VAEConfig, variables: Mapping[str, torch.Tensor] | None = None,
                 *, training_mode: str = "finetune", policy: Policy = FULL_PRECISION,
                 device: str | torch.device | None = None, seed: int = 0) -> None:
        if training_mode not in TRAINING_MODES:
            raise ValueError(f"Unknown training_mode: {training_mode}")
        super().__init__(config, variables, policy=policy, device=device, seed=seed)
        self.training_mode = training_mode

    def make_distill_runner(self, teacher_path: str, **cfg_kwargs):
        """Stage-1 distillation of this model's stems against a teacher file;
        returns ``run(log_fn=None)``, which trains them in place and returns the
        last step's logs."""
        from eovax_torch.train.distill import DistillConfig, load_teacher_stems, run_distillation

        teacher = load_teacher_stems(teacher_path)
        cfg = DistillConfig(**cfg_kwargs)

        def run(log_fn=None) -> dict[str, float]:
            return run_distillation(self.core, teacher, cfg, log_fn=log_fn)

        return run

    def make_finetune_trainer(self, loss_obj, **trainer_kwargs):
        """The stage-2 finetune trainer."""
        from eovax_torch.train.stage2 import Stage2Trainer

        return Stage2Trainer(model=self, loss_obj=loss_obj, cfg=self.config, **trainer_kwargs)

    def make_flow_refine_trainer(self, *, hid_channels: tuple[int, ...] = (128, 128, 128),
                                 hid_blocks: tuple[int, ...] = (2, 2, 2), sampler_steps: int = 50,
                                 seed: int = 0, **trainer_kwargs):
        """A ``DiffusionSuperRes`` over a fresh rectified-flow UNet on this model's
        device, conditioned on the frozen VAE's reconstruction; in, out and
        condition channels are ``decoder.out_ch``. The trainer's
        ``refine_batches(batches, wvs)`` turns image batches into its pairs."""
        from eovax_torch.cli.train_super_res import build_denoiser_from_config
        from eovax_torch.train.sr import DiffusionSuperRes

        c = self.config.decoder.out_ch
        denoiser, unet = build_denoiser_from_config(
            {"denoiser": {"_target_": "SimpleDenoiser",
                          "backbone": {"in_channels": c, "out_channels": c, "cond_channels": c,
                                       "hid_channels": list(hid_channels),
                                       "hid_blocks": list(hid_blocks)},
                          "schedule": {"_target_": "RectifiedSchedule"}}},
            policy=self.policy, seed=seed, device=self.device)
        trainer = DiffusionSuperRes(denoiser=denoiser, init_params=unet,
                                    sampler_steps=sampler_steps, **trainer_kwargs)
        trainer.refine_batches = self.refine_batches
        return trainer

    def refine_batches(self, batches: Iterable[dict], wvs) -> Iterator[dict]:
        """NHWC image batches → the refiner's pairs: ``image_lr`` the frozen VAE's
        fp32 reconstruction (the condition), ``image_hr`` the image (the target),
        both NHWC views of NCHW tensors on this model's device. A batch's own
        ``wvs`` win over ``wvs``."""
        for batch in batches:
            x = self._tensor(batch["image"]).permute(0, 3, 1, 2).contiguous()
            with torch.no_grad():
                recon = self.core.reconstruct(x, self._tensor(batch.get("wvs", wvs)))
            yield {"image_hr": x.permute(0, 2, 3, 1),
                   "image_lr": recon.float().permute(0, 2, 3, 1)}


class AutoencoderKL(EOFluxVAE):
    """Legacy LDM autoencoder: static conv stems, GAN finetuning through the
    stage-2 adversarial alternation. Without ``config``, the default
    architecture with ``embed_dim`` latent channels."""

    def __init__(self, config: VAEConfig | None = None,
                 variables: Mapping[str, torch.Tensor] | None = None, *, embed_dim: int = 4,
                 policy: Policy = FULL_PRECISION, device: str | torch.device | None = None,
                 seed: int = 0) -> None:
        if config is None:
            config = VAEConfig(
                encoder=EncoderConfig(z_channels=embed_dim, use_dynamic_ops=False, stem=None),
                decoder=DecoderConfig(z_channels=embed_dim, use_dynamic_ops=False, stem=None))
        if config.encoder.use_dynamic_ops or config.decoder.use_dynamic_ops:
            raise ValueError("AutoencoderKL is the static-stem legacy model")
        super().__init__(config, variables, policy=policy, device=device, seed=seed)

    def make_gan_trainer(self, loss_obj, discriminator, **trainer_kwargs):
        """Generator and discriminator training: the stage-2 adversarial alternation."""
        from eovax_torch.train.stage2 import Stage2Trainer

        return Stage2Trainer(model=self, loss_obj=loss_obj, cfg=self.config,
                             discriminator=discriminator, **trainer_kwargs)

