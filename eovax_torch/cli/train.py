"""Stage-2 training CLI (reference: train.py).

Port of ``eovax/cli/train.py``; runs on the card unless ``--device`` says
otherwise.

Usage:
    python -m eovax_torch.cli.train --config configs/eo-vae.yaml [--synthetic-data] \
        [--distilled-ckpt distilled_final.pt] [--flux-ckpt ae.safetensors] \
        [--max-steps N] [--debug] [--resume-dir DIR] [--device cuda]

On N cards, one process each (data parallel, NCCL):
    python -m torch.distributed.run --nproc_per_node N -m eovax_torch.cli.train ...
The datamodule's ``batch_size`` is per process (the global batch is N times
it); each process reads its share of the TerraMesh shards, and rank 0 writes
the experiment directory.

Builds the model from the config, loads the stage-1 distilled stems and/or
the Flux body, builds the loss (and, for an adversarial loss, its
discriminator), and runs ``Stage2Trainer`` with
CSV (and optional W&B) logging, validation image grids and checkpoints in a
timestamped experiment directory. It ends with ``eo-vae-final.pt`` and, once
validation has run, ``eo-vae-best.pt`` (each ``{"state_dict": ...}``).
``--debug`` turns logging and checkpoints off. A config with
``model.training_mode: flow-refine`` (unless ``--distilled-ckpt`` comes
without ``--vae-ckpt``, which forces finetune) trains the refiner of
``FluxAutoencoderKL`` on the frozen VAE instead and ends with its UNet's
state dict, ``refiner-final.pt`` (the JAX CLI writes ``.msgpack``). The
batches come from the TerraMesh tar shards under the config's
``datamodule.data_path`` (``TerraMeshPipeline``, with the ``datamodule``
block's keys and the JAX CLI's defaults; ``device_prep: true`` normalizes
and augments on the device); ``--synthetic-data`` trains on random batches
instead.
"""

from __future__ import annotations

import argparse
import os
from typing import Any

from eovax_torch.cli.common import add_distributed_args


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="EO-VAE stage-2 training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--distilled-ckpt", default=None)
    parser.add_argument("--flux-ckpt", default=None)
    parser.add_argument("--ckpt", default=None, help="full checkpoint to start from")
    parser.add_argument(
        "--vae-ckpt", default=None,
        help="pretrained VAE checkpoint for flow-refine mode (frozen VAE + fresh refiner)",
    )
    parser.add_argument(
        "--resume-dir", default=None,
        help="existing experiment dir: reuse it and resume from its latest checkpoint",
    )
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--synthetic-data", action="store_true")
    parser.add_argument("--precision", default="bf16-mixed")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    add_distributed_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from eovax_torch.cli.common import start_distributed
    from eovax_torch.core.config import load_yaml
    from eovax_torch.parallel.mesh import destroy_distributed

    args = parse_args(argv)
    created = start_distributed(args)  # first, as the JAX CLI's init_distributed
    try:
        run(args, load_yaml(args.config))
    finally:
        destroy_distributed(created)


def run(args: argparse.Namespace, raw_cfg: dict[str, Any]) -> str | None:
    """The CLI's body on a parsed config; returns the experiment directory
    (None under ``--debug``)."""
    from eovax_torch.cli.common import create_experiment_dir, snapshot_config
    from eovax_torch.core.config import VAEConfig
    from eovax_torch.core.device import process_index
    from eovax_torch.core.precision import policy_from_name
    from eovax_torch.losses.factory import build_loss_from_config
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.train.schedule import STAGE2_STEPS_PER_EPOCH
    from eovax_torch.train.stage2 import Stage2Trainer
    from eovax_torch.utils.checkpoint import save_variables
    from eovax_torch.utils.image_logger import ImageLogger
    from eovax_torch.utils.logging import CSVLogger

    cfg = VAEConfig.from_dict(raw_cfg)
    if str(args.precision).lower() in ("int8", "w8a8"):
        raise SystemExit(
            f"--precision {args.precision!r} selects the inference-only "
            "int8 conv path (zero gradient through the round() "
            "quantization) — train with '32-true' or '16-mixed' and "
            "export with the quantized policy afterwards."
        )
    policy = policy_from_name(args.precision)
    training_mode = raw_cfg.get("model", {}).get("training_mode")
    if args.distilled_ckpt and not args.vae_ckpt:
        training_mode = "finetune"
    refine = training_mode == "flow-refine"
    if refine:
        from eovax_torch.models.flux_autoencoder import FluxAutoencoderKL

        model = FluxAutoencoderKL(cfg, training_mode="flow-refine", policy=policy,
                                  device=args.device, seed=args.seed)
    else:
        model = EOFluxVAE(cfg, policy=policy, device=args.device, seed=args.seed)
    # Component-wise loading: the Flux body, then the distilled stems.
    if args.flux_ckpt:
        model.load_checkpoint(args.flux_ckpt, strict=False)
    if args.distilled_ckpt:
        model.load_checkpoint(args.distilled_ckpt)
    if args.ckpt:
        model.load_checkpoint(args.ckpt)
    if args.vae_ckpt:
        model.load_checkpoint(args.vae_ckpt, strict=False)
    # Flow-refine trains the refiner alone: no loss or discriminator is built.
    loss_obj = discriminator = seed_disc_stem = None
    if not refine:
        loss_obj, discriminator, seed_disc_stem = build_loss_from_config(
            raw_cfg.get("model", {}).get("loss_fn", {}), cfg, policy=policy, seed=args.seed)

    trainer_cfg = raw_cfg.get("trainer", {})
    max_epochs = trainer_cfg.get("max_epochs", 100)
    limit_train = trainer_cfg.get("limit_train_batches", STAGE2_STEPS_PER_EPOCH)
    max_steps = args.max_steps or max_epochs * limit_train

    exp_dir = logger = image_logger = None
    if not args.debug:
        exp = raw_cfg.get("experiment", {})
        if args.resume_dir:
            exp_dir = args.resume_dir
            os.makedirs(exp_dir, exist_ok=True)
        else:
            exp_dir = create_experiment_dir(
                exp.get("exp_dir", "results/exps"), exp.get("experiment_name", "eo-vae")
            )
    primary = process_index() == 0  # rank 0 alone writes files and logs
    if exp_dir and primary:
        snapshot_config(args.config, exp_dir)
        logger = CSVLogger(exp_dir)
        image_logger = ImageLogger(exp_dir)
        wandb_cfg = raw_cfg.get("wandb")
        if wandb_cfg and wandb_cfg.get("mode", "online") != "disabled":
            from eovax_torch.utils.logging import MultiLogger, WandbLogger

            logger = MultiLogger(
                logger,
                WandbLogger(
                    project=wandb_cfg.get("project", "eovax"),
                    entity=wandb_cfg.get("entity"),
                    config=raw_cfg,
                    mode=wandb_cfg.get("mode", "online"),
                ),
            )

    dm_cfg = raw_cfg.get("datamodule", {})
    train_iter, val_factory = _batches(dm_cfg, args)
    if refine:
        try:
            _flow_refine(model, raw_cfg, max_steps, logger, exp_dir if primary else None,
                         train_iter, seed=args.seed)
        finally:
            train_iter.close()
        return exp_dir

    trainer = Stage2Trainer(
        model=model,
        loss_obj=loss_obj,
        cfg=cfg,
        max_steps=max_steps,
        val_every=limit_train,
        ckpt_dir=os.path.join(exp_dir, "checkpoints") if exp_dir else None,
        ckpt_every=limit_train if exp_dir else 0,
        val_max_batches=trainer_cfg.get("limit_val_batches", 100),
        log_every=trainer_cfg.get("log_every_n_steps", 100),
        logger=logger,
        discriminator=discriminator,
        seed_disc_stem=seed_disc_stem,
        image_logger=image_logger,
        norm_scheme=dm_cfg.get("norm_scheme", "legacy"),
        seed=args.seed,
    )
    try:
        trainer.fit(train_iter, val_factory)
    finally:
        train_iter.close()  # stops the reader's threads

    if exp_dir:
        if primary:
            save_variables(os.path.join(exp_dir, "eo-vae-final.pt"), trainer.export_variables())
            print(f"Saved final model to {exp_dir}/eo-vae-final.pt")
        # The best-by-val/loss_rec model, the reference's artifact of record
        # (restored on every rank: the read waits for every rank).
        if trainer.restore_best() is not None and primary:
            info = trainer.checkpointer.best_info()
            save_variables(os.path.join(exp_dir, "eo-vae-best.pt"), trainer.export_variables())
            print(
                f"Saved best model ({trainer.monitor}={info['metric']:.6g} "
                f"@ step {info['step']}) to {exp_dir}/eo-vae-best.pt"
            )
    return exp_dir


def _flow_refine(model, raw_cfg: dict[str, Any], max_steps: int, logger, out_dir: str | None,
                 train_iter, seed: int) -> None:
    """Flow-refine mode: train a fresh rectified-flow UNet (the ``model.refiner``
    block's ``hid_channels``, ``hid_blocks``, ``sampler_steps``) on the frozen
    VAE's reconstructions of the train batches (wavelengths of the
    ``val_collate_mode`` where a batch has none) and write its state dict to
    ``<out_dir>/refiner-final.pt``."""
    import torch

    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.utils.checkpoint import host_copy

    refine_cfg = raw_cfg.get("model", {}).get("refiner", {})
    trainer = model.make_flow_refine_trainer(
        hid_channels=tuple(refine_cfg.get("hid_channels", (128, 128, 128))),
        hid_blocks=tuple(refine_cfg.get("hid_blocks", (2, 2, 2))),
        sampler_steps=refine_cfg.get("sampler_steps", 50), seed=seed,
        base_lr=model.config.base_lr,
        log_every=raw_cfg.get("trainer", {}).get("log_every_n_steps", 100), logger=logger)
    wvs = wavelengths_for(raw_cfg.get("datamodule", {}).get("val_collate_mode", "S2L2A"))
    state = trainer.fit(trainer.refine_batches(train_iter, wvs), max_steps=max_steps)
    if out_dir:
        path = os.path.join(out_dir, "refiner-final.pt")
        torch.save(host_copy(state.model.state_dict()), path)
        print(f"Saved refiner to {path}")


def _batches(dm_cfg: dict[str, Any], args: argparse.Namespace):
    """The train batch generator and the validation iterator factory: the
    TerraMesh pipeline of the ``datamodule`` block (this process's shards), or
    synthetic batches (``batch_size`` a process, from the same seed on every
    process, as the JAX CLI's)."""
    size = dm_cfg.get("target_size", (256, 256))
    size = (size, size) if isinstance(size, int) else tuple(size)
    if args.synthetic_data:
        from eovax_torch.data.synthetic import synthetic_terramesh_batches

        mods = tuple(m for m in dm_cfg.get("modalities", ["S2L2A", "S1RTC", "S2RGB"])
                     if m != "S1GRD")
        train_iter = synthetic_terramesh_batches(
            batch_size=dm_cfg.get("batch_size", 16), target_size=size, modalities=mods,
            seed=args.seed,
        )

        def val_factory():
            return synthetic_terramesh_batches(
                batch_size=dm_cfg.get("eval_batch_size", 32), target_size=size,
                modalities=("S2L2A",), mode="S2L2A", seed=args.seed + 1, num_batches=10,
            )

        return train_iter, val_factory

    from eovax_torch.core.device import process_count, process_index
    from eovax_torch.data.terramesh import TerraMeshPipeline

    pipeline = TerraMeshPipeline(
        data_path=dm_cfg["data_path"],
        modalities=dm_cfg.get("modalities", ["S2L2A", "S1RTC", "S2RGB"]),
        batch_size=dm_cfg.get("batch_size", 16),
        eval_batch_size=dm_cfg.get("eval_batch_size", 32),
        train_collate_mode=dm_cfg.get("train_collate_mode", "random"),
        val_collate_mode=dm_cfg.get("val_collate_mode", "S2L2A"),
        normalize=dm_cfg.get("normalize", True),
        norm_scheme=dm_cfg.get("norm_scheme", "legacy"),
        target_size=size,
        seed=args.seed,
        num_workers=dm_cfg.get("num_workers", 4),
        process_index=process_index(),
        process_count=process_count(),
        device_prep=dm_cfg.get("device_prep", False),
    )
    return pipeline.train_batches(), pipeline.val_batches


if __name__ == "__main__":
    main()
