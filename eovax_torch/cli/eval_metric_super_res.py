"""SR quality evaluation CLI (reference: eval_metric_super_res.py).

Port of ``eovax/cli/eval_metric_super_res.py``. Samples the latent-diffusion
SR model over the test split, denormalizes the predicted latents with the
dataset's HR statistics, decodes through the frozen VAE, and reports RMSE /
PSNR / SSIM / SAM on RGB in [0, 1] (eval_metric_super_res.py:48-77,
193-216). Writes all_metrics.json. Latents cross the sampler in NCHW, as the
port's VAE takes them; the dataset's NHWC batches are transposed on the way.

Usage:
    python -m eovax_torch.cli.eval_metric_super_res --vae-config model_config.yaml \
        --vae-ckpt eo-vae.ckpt --sr-ckpt unet.pt --data-root latents/ \
        [--num-batches 8] [--output results/sr-metrics] [--device cuda]

``--sr-ckpt`` is a torch state dict of the port's UNet
(``eovax_torch.models.unet.UNet``; ``sr-final.pt`` of the port's trainer) or
the ``.msgpack`` that the JAX package's SR trainer writes (``sr-best.msgpack``,
its params through ``eovax_torch.utils.convert.state_dict_from_variables``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def evaluate_sr(
    vae,
    sr_trainer,
    sr_state,
    dataset,
    *,
    batch_size: int = 8,
    num_batches: int | None = None,
    use_spatial_norm: bool = True,
) -> dict:
    """Core eval loop, reusable from tests. Returns metric means."""
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.utils.metrics import psnr, rmse, spectral_angle, ssim

    hr_mean = dataset.hr_mean[:, None, None]  # per channel, NCHW
    hr_std = dataset.hr_std[:, None, None]
    agg: dict[str, list[float]] = {"rmse": [], "psnr": [], "ssim": [], "sam": []}

    def to_nchw(z):
        return np.ascontiguousarray(np.transpose(z, (0, 3, 1, 2)))

    for i, batch in enumerate(dataset.batches(batch_size)):
        if num_batches is not None and i >= num_batches:
            break
        hr = to_nchw(batch["image_hr"])
        pred_latent = sr_trainer.sample(sr_state, hr.shape, cond=to_nchw(batch["image_lr"]),
                                        seed=i).float().cpu().numpy()
        # Denormalize latents back to VAE space (eval_metric_super_res.py:48-60).
        pred_latent = pred_latent / dataset.latent_scale_factor * hr_std + hr_mean
        gt_latent = hr / dataset.latent_scale_factor * hr_std + hr_mean

        decode = vae.decode_spatial_normalized if use_spatial_norm else vae.decode_raw
        pred_img = decode(pred_latent, SEN2NAIP_WVS).float().cpu().numpy()
        gt_img = decode(gt_latent, SEN2NAIP_WVS).float().cpu().numpy()

        # RGB in [0,1] via min-max over the GT (eval parity: z-scored images
        # are mapped to the display range before metric computation).
        def to_rgb01(x):
            rgb = np.transpose(x[:, :3], (0, 2, 3, 1))
            lo, hi = gt_rgb_range
            return np.clip((rgb - lo) / (hi - lo + 1e-8), 0, 1)

        gt_rgb = np.transpose(gt_img[:, :3], (0, 2, 3, 1))
        gt_rgb_range = (gt_rgb.min(), gt_rgb.max())
        p, t = (torch.as_tensor(to_rgb01(x), device=vae.device) for x in (pred_img, gt_img))

        agg["rmse"].append(float(rmse(p, t)))
        agg["psnr"].append(float(psnr(p, t, data_range=1.0)))
        agg["ssim"].append(float(ssim(p, t, data_range=1.0)))
        agg["sam"].append(float(spectral_angle(p, t)))

    return {k: float(np.mean(v)) for k, v in agg.items() if v}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Evaluate latent-SR quality")
    parser.add_argument("--vae-config", required=True)
    parser.add_argument("--vae-ckpt", required=True)
    parser.add_argument("--sr-ckpt", required=True)
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--num-batches", type=int, default=None)
    parser.add_argument("--sr-steps", type=int, default=50)
    parser.add_argument("--output", default="results/sr-metrics")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.sen2naip import Sen2NaipCrossSensorLatent
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.train.sr import DiffusionSuperRes
    from eovax_torch.utils.convert import read_state_dict

    vae = EOFluxVAE.from_config(args.vae_config, args.vae_ckpt, policy=DEFAULT_POLICY,
                                device=args.device)
    z = vae.config.encoder.z_channels
    denoiser, unet = build_denoiser_from_config(
        {"denoiser": {"backbone": {"in_channels": z, "out_channels": z, "cond_channels": z}}},
        device=vae.device,
    )
    unet.load_state_dict(read_state_dict(args.sr_ckpt), strict=True)
    trainer = DiffusionSuperRes(
        denoiser=denoiser, init_params=unet, sampler_steps=args.sr_steps,
    )
    state = trainer.init_state()

    dataset = Sen2NaipCrossSensorLatent(args.data_root, args.split)
    metrics = evaluate_sr(
        vae, trainer, state, dataset,
        batch_size=args.batch_size, num_batches=args.num_batches,
    )
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, "all_metrics.json")
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    print(f"Saved to {out_path}")


if __name__ == "__main__":
    main()
