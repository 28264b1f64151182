"""Visual tokenizer evaluation CLI (reference: visual_eval.py +
eval_viz_tokenizer.py): side-by-side input/reconstruction grids per
modality, plus a latent-PCA visualization (eval_viz_tokenizer.py:54-81).

Port of ``eovax/cli/visual_eval.py``; runs on the card unless ``--device``
says otherwise.

Usage:
    python -m eovax_torch.cli.visual_eval --config model_config.yaml --ckpt ckpt \
        --out-dir viz/ [--synthetic-data] [--modalities S2L2A S2RGB] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def latent_pca_rgb(latent_nchw: np.ndarray) -> np.ndarray:
    """Project latent channels onto their top-3 PCA components → RGB
    (eval_viz_tokenizer.py:54-81)."""
    b, c, h, w = latent_nchw.shape
    flat = latent_nchw.transpose(0, 2, 3, 1).reshape(-1, c)
    flat = flat - flat.mean(0)
    # Top-3 principal directions via SVD of the (small) covariance.
    cov = flat.T @ flat / flat.shape[0]
    _, vecs = np.linalg.eigh(cov)
    comps = flat @ vecs[:, -3:]  # [N, 3]
    comps = comps.reshape(b, h, w, 3)
    lo, hi = np.quantile(comps, 0.02), np.quantile(comps, 0.98)
    return np.clip((comps - lo) / (hi - lo + 1e-8), 0, 1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Visual tokenizer eval")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--modalities", nargs="+", default=["S2L2A", "S2RGB"])
    parser.add_argument("--out-dir", default="viz")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--synthetic-data", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.utils.image_logger import ImageLogger, _save_png

    model = EOFluxVAE.from_config(args.config, args.ckpt, policy=DEFAULT_POLICY,
                                  device=args.device)
    logger = ImageLogger(args.out_dir, max_images=args.batch_size)
    os.makedirs(args.out_dir, exist_ok=True)

    for modality in args.modalities:
        if args.synthetic_data:
            from eovax_torch.data.synthetic import synthetic_terramesh_batches

            batch = next(
                synthetic_terramesh_batches(
                    batch_size=args.batch_size, target_size=(256, 256),
                    modalities=(modality,), mode=modality, seed=0, num_batches=1,
                )
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
            batch = collate(next(iter(raw)))

        x = np.transpose(batch["image"], (0, 3, 1, 2))
        recon = model.reconstruct(x, batch["wvs"]).float().cpu().numpy()
        path = logger.log(
            batch["image"], np.transpose(recon, (0, 2, 3, 1)),
            modality=modality, step=0, split="visual_eval",
        )
        print(f"[{modality}] reconstruction grid: {path}")

        latent = model.encode_spatial_normalized(x, batch["wvs"]).float().cpu().numpy()
        pca = latent_pca_rgb(latent)
        pca_grid = np.concatenate(list((pca * 255).astype(np.uint8)), axis=1)
        pca_path = os.path.join(args.out_dir, f"latent_pca_{modality}.png")
        _save_png(pca_grid, pca_path)
        print(f"[{modality}] latent PCA: {pca_path}")


if __name__ == "__main__":
    main()
