"""Stage-1 weight-distillation CLI (reference: weight_distill_train.py).

Port of ``eovax/cli/weight_distill.py``. Usage:

    python -m eovax_torch.cli.weight_distill --config configs/weight_distill.yaml \
        --teacher ae.safetensors --output distilled_final.pt \
        [--max-steps 5000] [--lr 1e-4] [--seed 0] [--device cuda]

The output is the reference's distilled ``.pt`` (the JAX CLI writes ``.msgpack``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="EO-VAE stage-1 distillation")
    parser.add_argument("--config", required=True)
    parser.add_argument("--teacher", required=True, help="Flux ae.safetensors / ckpt")
    parser.add_argument("--output", default="distilled_final.pt")
    parser.add_argument("--max-steps", type=int, default=5000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.core.config import load_model_config
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.train.distill import (
        DistillConfig,
        load_teacher_stems,
        run_distillation,
        save_distilled_checkpoint,
    )

    # Stage 1 runs in fp32 (weight_distill_train.py:540): the default FULL_PRECISION.
    model = EOFluxVAE(load_model_config(args.config), seed=args.seed, device=args.device)
    teacher = load_teacher_stems(args.teacher)
    cfg = DistillConfig(max_steps=args.max_steps, lr=args.lr)

    def log(step, scalars):
        msg = ", ".join(f"{k}={v:.3e}" for k, v in sorted(scalars.items()))
        print(f"[distill {step}/{cfg.max_steps}] {msg}")

    logs = run_distillation(model.core, teacher, cfg, log_fn=log)
    save_distilled_checkpoint(args.output, model.core, cfg, final_loss=logs["total_loss"])
    print(f"Saved distilled stems to {args.output} (final loss {logs['total_loss']:.3e})")


if __name__ == "__main__":
    main()
