"""Export a trained EO-VAE to a ``torch.export`` serving artifact.

Port of ``eovax/cli/export.py``. Usage:

    python -m eovax_torch.cli.export --config model_config.yaml --ckpt eo-vae.ckpt \
        --output artifact/ [--modalities S2L2A S2RGB] [--resolution 256] [--device cuda]

The artifact (manifest + params.pt + one .pt2 graph per function×modality)
reloads via ``eovax_torch.serving.ServedModel.load`` and serves
``reconstruct`` / ``encode_spatial_normalized`` /
``decode_spatial_normalized`` at any batch size without the model code. With
``--sr-config`` it holds the stage-3 pipeline (encode → sampler → decode) as
one graph instead. The graphs are traced on ``--device`` (CUDA by default).
``--precision int8`` exports the W8A8 graph, its body-conv weights quantized
once; ``--calibrate-npz`` adds static activation ranges.
See eovax_torch/serving/__init__.py.
"""

from __future__ import annotations

import argparse
import os
import time


def _size_line(out: str) -> str:
    return ", ".join(f"{name} {os.path.getsize(os.path.join(out, name)) / 2**20:.1f} MiB"
                     for name in sorted(os.listdir(out)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export EO-VAE serving artifact")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--output", required=True)
    parser.add_argument("--modalities", nargs="+", default=["S2L2A"])
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument(
        "--precision", default="16-mixed",
        help="'32-true', '16-mixed' (bf16, default), or 'int8' — exports the "
        "W8A8 quantized graph (body convs on the int8 conv3x3 kernel)",
    )
    parser.add_argument(
        "--compact-weights", action="store_true",
        help="store float params as bf16 (halves the weights file; BN "
        "running stats stay fp32)",
    )
    parser.add_argument(
        "--calibrate-npz", default=None,
        help="int8 only: .npz with an 'images' array (NCHW, normalized "
        "units) used for percentile activation calibration — the artifact "
        "then carries static act scales instead of per-call abs-max",
    )
    parser.add_argument(
        "--calibrate-percentile", type=float, default=99.9,
        help="|activation| percentile for --calibrate-npz (default 99.9)",
    )
    parser.add_argument(
        "--sr-config", default=None,
        help="superres yaml (configs_superres/*): export the stage-3 "
        "pipeline (encode → sampler → decode) as one graph instead of the "
        "VAE surface",
    )
    parser.add_argument(
        "--sr-ckpt", default=None,
        help="trained SR UNet for --sr-config: the port's state dict (sr-best.pt) or "
        "the JAX package's sr-best.msgpack",
    )
    parser.add_argument(
        "--sr-steps", type=int, default=50, help="sampling steps for --sr-config",
    )
    parser.add_argument(
        "--sr-sampler", default="ddim", choices=("ddim", "dpm++2m"),
        help="'ddim' (reference parity) or 'dpm++2m' (second-order "
        "multistep: comparable error at ~half the steps)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import torch

    from eovax_torch.core.precision import policy_from_name
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.serving import calibrate_activations, export_model, export_sr_pipeline

    if args.sr_config and args.calibrate_npz:
        parser.error("--calibrate-npz is not supported for the SR pipeline export (the int8 "
                     "SR artifact uses dynamic abs-max activation scales)")
    if args.calibrate_npz and policy_from_name(args.precision).conv_algorithm != "int8":
        parser.error("--calibrate-npz requires --precision int8")
    model = EOFluxVAE.from_config(args.config, args.ckpt,
                                  policy=policy_from_name(args.precision), device=args.device)
    params_dtype = torch.bfloat16 if args.compact_weights else None
    t0 = time.perf_counter()
    if args.sr_config:
        from eovax_torch.cli.train_super_res import build_denoiser_from_config
        from eovax_torch.core.config import load_yaml
        from eovax_torch.utils.convert import read_state_dict

        raw = load_yaml(args.sr_config)
        denoiser, unet = build_denoiser_from_config(raw["lightning_module"],
                                                    policy=model.policy, device=model.device)
        if args.sr_ckpt:
            unet.load_state_dict(read_state_dict(args.sr_ckpt), strict=True)
        manifest = export_sr_pipeline(
            model, denoiser, unet, args.output, resolution=args.resolution,
            steps=args.sr_steps, sampler=args.sr_sampler, params_dtype=params_dtype,
            denoiser_policy=model.policy,
        )
        q = manifest.get("quantization")
        if q:
            print(f"int8: {q['quantized_convs']} convs pre-quantized (VAE + UNet trees)")
        print(f"exported SR pipeline ({manifest['steps']} {manifest['sampler']} steps, "
              f"{args.resolution}² LR input) to {args.output} in "
              f"{time.perf_counter() - t0:.1f} s: {_size_line(args.output)}")
        return

    act_scales = None
    if args.calibrate_npz:
        import numpy as np

        images = np.load(args.calibrate_npz)["images"]
        # Calibrate in small batches; a handful of representative tiles
        # pins the bulk activation range.
        bs = min(8, images.shape[0])
        batches = [images[i:i + bs] for i in range(0, images.shape[0], bs)]
        act_scales = calibrate_activations(model, batches, modality=args.modalities[0],
                                           percentile=args.calibrate_percentile)
        print(f"calibrated {len(act_scales)} conv activation scales")
    manifest = export_model(
        model, args.output, modalities=tuple(args.modalities), resolution=args.resolution,
        params_dtype=params_dtype, act_scales=act_scales,
    )
    q = manifest.get("quantization")
    if q:
        print(f"int8: {q['quantized_convs']} convs pre-quantized, activations {q['activations']}")
    print(f"exported {len(manifest['functions'])} functions to {args.output} in "
          f"{time.perf_counter() - t0:.1f} s: {_size_line(args.output)}")


if __name__ == "__main__":
    main()
