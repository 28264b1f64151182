"""Stage-3 latent-SR training CLI (reference: train_super_res.py).

Port of ``eovax/cli/train_super_res.py``. Usage:

    python -m eovax_torch.cli.train_super_res --config configs_superres/eo_vae_latent.yaml \
        [--debug] [--max-steps N] [--seed S] [--resume-dir DIR] [--device cuda]

On N cards, one process each (data parallel, NCCL):
    python -m torch.distributed.run --nproc_per_node N -m eovax_torch.cli.train_super_res ...
The datamodule's ``batch_size`` is per process: process r trains on its rows
of each global batch of N·batch_size pairs, and rank 0 writes the files.

Writes ``<exp_dir>/<name>_<stamp>/{config.yaml, metrics.csv, checkpoints/,
image_log/val/*.png, sr-final.pt, sr-best.pt}``: ``sr-final.pt`` and
``sr-best.pt`` are the UNet's torch state dict, which
``eval_metric_super_res --sr-ckpt`` loads (the JAX CLI writes ``.msgpack``).
"""

from __future__ import annotations

import argparse
import os

import torch

from eovax_torch.cli.common import add_distributed_args, start_distributed


def build_denoiser_from_config(cfg: dict, *, policy=None, seed: int = 0,
                               device: str | torch.device | None = None):
    """UNet, schedule and denoiser from a reference-format config block
    (configs_superres/eo_vae_latent.yaml:32-48). Returns ``(denoiser, unet)``:
    the UNet, with weights drawn from ``seed``, is on ``device`` (CUDA unless
    told otherwise; raises without a card) in eval mode."""
    from eovax_torch.core.device import resolve_device
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.models.sr_diffusion import (
        DecaySchedule,
        KarrasDenoiser,
        RectifiedSchedule,
        SimpleDenoiser,
        VPSchedule,
    )
    from eovax_torch.models.unet import UNet
    from eovax_torch.nn.init import init_parameters

    policy = policy or DEFAULT_POLICY
    device = resolve_device(device)
    policy.activate()
    den_cfg = cfg["denoiser"]
    bb = den_cfg["backbone"]
    unet = UNet(
        in_channels=bb.get("in_channels", 32),
        out_channels=bb.get("out_channels", 32),
        cond_channels=bb.get("cond_channels", 0),
        hid_channels=tuple(bb.get("hid_channels", (256, 128, 64))),
        hid_blocks=tuple(bb.get("hid_blocks", (3, 3, 3))),
        policy=policy,
    )
    init_parameters(unet, torch.Generator().manual_seed(seed))
    unet.to(device).eval()

    sched_target = den_cfg.get("schedule", {}).get("_target_", "RectifiedSchedule")
    if "VPSchedule" in sched_target:
        schedule = VPSchedule()
    elif "DecaySchedule" in sched_target:
        schedule = DecaySchedule()
    else:
        schedule = RectifiedSchedule()

    den_target = den_cfg.get("_target_", "SimpleDenoiser")
    cls = KarrasDenoiser if "Karras" in den_target else SimpleDenoiser
    return cls(schedule=schedule), unet


def _datasets(dm_cfg: dict):
    """(train, val) datasets by the datamodule's ``_target_``: the latent pairs
    that ``encode_latents`` writes, or the pixel baseline's tif pairs
    (reference pixel.yaml:50-51), z-scored and bicubic-upsampled by its collate."""
    from eovax_torch.data import sen2naip

    target = dm_cfg.get("_target_", "Sen2NaipLatentCrossSensorDataModule").split(".")[-1]
    if "Latent" in target:
        kw = dict(latent_scale_factor=dm_cfg.get("latent_scale_factor", 1.0),
                  normalize=dm_cfg.get("normalize", True))
        return tuple(sen2naip.Sen2NaipCrossSensorLatent(dm_cfg["root"], split, **kw)
                     for split in ("train", "val"))
    collate = (sen2naip.sen2naip_domain_adapted_collate if dm_cfg.get("domain_adapted")
               else sen2naip.sen2naip_collate)
    kw = dict(collate=collate, lr_size=dm_cfg.get("lr_size", 128),
              hr_size=dm_cfg.get("hr_size", 512))
    return tuple(sen2naip.Sen2NaipCrossSensor(dm_cfg["root"], split, **kw)
                 for split in ("train", "val"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="EO-VAE stage-3 latent SR training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume-dir", default=None,
                        help="existing experiment dir: reuse it and resume from its latest "
                             "checkpoint (preemption recovery)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    add_distributed_args(parser)
    args = parser.parse_args(argv)

    from eovax_torch.parallel.mesh import destroy_distributed

    created = start_distributed(args)
    try:
        _run(args)
    finally:
        destroy_distributed(created)


def _run(args: argparse.Namespace) -> None:
    from eovax_torch.cli.common import create_experiment_dir, snapshot_config
    from eovax_torch.core.config import load_yaml
    from eovax_torch.core.device import process_count, process_index
    from eovax_torch.train.schedule import SR_STEPS_PER_EPOCH
    from eovax_torch.train.sr import DiffusionSuperRes
    from eovax_torch.utils.image_logger import SuperResImageLogger
    from eovax_torch.utils.logging import CSVLogger

    raw = load_yaml(args.config)
    lm = raw["lightning_module"]
    denoiser, unet = build_denoiser_from_config(lm, seed=args.seed, device=args.device)
    trainer_cfg = raw.get("trainer", {})
    max_steps = args.max_steps or trainer_cfg.get("max_epochs", 750) * SR_STEPS_PER_EPOCH

    exp_dir = logger = image_logger = None
    if not args.debug:
        exp = raw.get("experiment", {})
        if args.resume_dir:
            exp_dir = args.resume_dir
            os.makedirs(exp_dir, exist_ok=True)
        else:
            exp_dir = create_experiment_dir(exp.get("exp_dir", "results/exps/sr"),
                                            exp.get("experiment_name", "eo-vae-sr"))
    primary = process_index() == 0  # rank 0 alone writes files and logs
    if exp_dir and primary:
        snapshot_config(args.config, exp_dir)
        logger = CSVLogger(exp_dir)
        image_logger = SuperResImageLogger(exp_dir)

    dm_cfg = raw["datamodule"]
    train_ds, val_ds = _datasets(dm_cfg)
    bs = dm_cfg.get("batch_size", 16)
    sampler_cfg = lm.get("sampler", {})
    trainer = DiffusionSuperRes(
        denoiser=denoiser, init_params=unet,
        sampler_steps=sampler_cfg.get("steps", 50),
        # The config's `_target_` names the sampler (DDIMSampler by default).
        sampler_type=sampler_cfg.get("_target_", "ddim").split(".")[-1],
        base_lr=lm.get("base_lr", 1e-4), final_lr=lm.get("final_lr"),
        warmup_epochs=lm.get("warmup_epochs"), decay_end_epoch=lm.get("decay_end_epoch"),
        grad_clip=trainer_cfg.get("gradient_clip_val", 1.0),
        log_every=trainer_cfg.get("log_every_n_steps", 20),
        logger=logger, image_logger=image_logger,
        ckpt_dir=os.path.join(exp_dir, "checkpoints") if exp_dir else None,
        ckpt_every=trainer_cfg.get("ckpt_every", SR_STEPS_PER_EPOCH),
        val_max_batches=trainer_cfg.get("limit_val_batches", 10),
        seed=args.seed,
    )
    shard = dict(process_index=process_index(), process_count=process_count())
    state = trainer.fit(train_ds.batches(bs, shuffle=True, seed=args.seed, repeat=True, **shard),
                        lambda: val_ds.batches(bs, **shard), max_steps=max_steps,
                        val_every=trainer_cfg.get("val_every", SR_STEPS_PER_EPOCH))
    if exp_dir:
        from eovax_torch.utils.checkpoint import host_copy

        final = os.path.join(exp_dir, "sr-final.pt")
        if primary:
            torch.save(host_copy(state.model.state_dict()), final)
            print(f"Saved SR model to {final}")
        # Also the best parameters by val_mse (ModelCheckpoint monitor='val_mse',
        # save_top_k=1, train_super_res.py:65-78); restored on every rank.
        best = trainer.restore_best()
        if best is not None and primary:
            info = trainer.checkpointer.best_info()
            path = os.path.join(exp_dir, "sr-best.pt")
            torch.save(host_copy(best.model.state_dict()), path)
            print(f"Saved best SR model (val_mse={info['metric']:.6g} @ step {info['step']}) "
                  f"to {path}")


if __name__ == "__main__":
    main()
