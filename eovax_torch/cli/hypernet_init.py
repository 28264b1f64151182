"""Standalone hypernetwork pre-initialization CLI (reference:
eo_vae/utils/hypernet_init_weights.py): distill the dynamic stems against a
freshly initialized static conv (a random teacher), so that the
hypernetworks start from a sane kernel distribution before the real stage-1
run.

Port of ``eovax/cli/hypernet_init.py``. Usage:

    python -m eovax_torch.cli.hypernet_init --config model_config.yaml \
        --output hypernet_init.pt [--steps 1000] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Hypernetwork pre-init")
    parser.add_argument("--config", required=True)
    parser.add_argument("--output", default="hypernet_init.pt")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.core.config import load_model_config
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.train.distill import DistillConfig, run_distillation, save_distilled_checkpoint

    cfg = load_model_config(args.config)
    model = EOFluxVAE(cfg, seed=args.seed, device=args.device)

    # Random teacher: kaiming-uniform conv stems, like a fresh nn.Conv2d
    # (hypernet_init_weights.py trains against a newly built conv's weight/bias).
    g = np.random.default_rng(args.seed)
    ch, cin, cout, k = cfg.encoder.ch, cfg.encoder.in_channels, cfg.decoder.out_ch, 3

    def kaiming(shape, fan_in):
        bound = float(np.sqrt(1.0 / fan_in))
        return torch.from_numpy(g.uniform(-bound, bound, shape).astype(np.float32))

    teacher = {
        "encoder_weight": kaiming((ch, cin, k, k), cin * k * k),
        "encoder_bias": kaiming((ch,), cin * k * k),
        "decoder_weight": kaiming((cout, ch, k, k), ch * k * k),
        "decoder_bias": kaiming((cout,), ch * k * k),
    }
    dcfg = DistillConfig(max_steps=args.steps, lr=args.lr, log_every_n_steps=100)

    def log(step, scalars):
        print(f"[hypernet-init {step}] total={scalars['total_loss']:.3e}")

    logs = run_distillation(model.core, teacher, dcfg, log_fn=log)
    save_distilled_checkpoint(args.output, model.core, dcfg, final_loss=logs["total_loss"])
    print(f"Saved pre-initialized stems to {args.output}")


if __name__ == "__main__":
    main()
