"""Single-image reconstruction CLI (reference: reconstruct.py).

Port of ``eovax/cli/reconstruct.py``; runs on the card unless ``--device``
says otherwise.

Usage:
    python -m eovax_torch.cli.reconstruct --config model_config.yaml --ckpt eo-vae.ckpt \
        --image input.npy --modality S2RGB --output recon.npy [--tiled] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="EO-VAE single-image reconstruct")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--image", required=True, help=".npy [C,H,W] or [B,C,H,W]")
    parser.add_argument("--modality", default="S2RGB")
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--output", default="recon.npy")
    parser.add_argument(
        "--tiled", action="store_true",
        help="large-scene mode: fixed 256² tiles with Hann-blended "
        "overlaps (eovax_torch.utils.tiling) — scenes bigger than one crop",
    )
    parser.add_argument("--tile", type=int, default=256)
    parser.add_argument("--overlap", type=int, default=32)
    parser.add_argument("--tile-batch", type=int, default=16)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.data.normalize import make_normalizer
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.models.eo_flux_vae import EOFluxVAE

    model = EOFluxVAE.from_config(args.config, args.ckpt, device=args.device)
    x = np.load(args.image).astype(np.float32)
    if x.ndim == 3:
        x = x[None]
    wvs = wavelengths_for(args.modality)
    if args.normalize:
        norm = make_normalizer(args.modality)
        x = np.transpose(norm(np.transpose(x, (0, 2, 3, 1))), (0, 3, 1, 2))
    if args.tiled:
        from eovax_torch.utils.tiling import tiled_reconstruct

        recon = np.stack([
            tiled_reconstruct(
                model, xi, wvs, tile=args.tile, overlap=args.overlap,
                batch_size=args.tile_batch,
            )
            for xi in x
        ])
    else:
        recon = model.reconstruct(x, wvs).float().cpu().numpy()
    np.save(args.output, recon)
    err = float(np.mean(np.abs(recon - x)))
    print(f"Saved reconstruction to {args.output} (MAE vs input: {err:.4f})")


if __name__ == "__main__":
    main()
