"""Distilled-stem vs teacher comparison CLI (reference:
compare_weight_distill.py): loads distilled stems and the Flux teacher,
queries the generators at the RGB wavelengths, and reports per-tensor
MSE/MAE/max error and the cosine similarity.

Port of ``eovax/cli/compare_weight_distill.py``. Usage:

    python -m eovax_torch.cli.compare_weight_distill --config model_config.yaml \
        --distilled distilled_final.pt --teacher ae.safetensors [--device cuda]

``--distilled`` is anything ``EOFluxVAE.load_checkpoint`` reads: a distilled
``.pt`` or a full checkpoint.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


@torch.no_grad()
def compare(model, teacher: dict, rgb_wvs) -> dict:
    wvs = torch.tensor(rgb_wvs, dtype=torch.float32, device=model.device)
    out = {}
    for name, stem in (("encoder", model.core.encoder.conv_in),
                       ("decoder", model.core.decoder.conv_out)):
        sw, sb = (x.cpu().numpy() for x in stem.get_distillation_weight(wvs))
        tw, tb = (np.asarray(teacher[f"{name}_{k}"], np.float32) for k in ("weight", "bias"))
        cos = float(np.dot(sw.ravel(), tw.ravel())
                    / (np.linalg.norm(sw) * np.linalg.norm(tw) + 1e-12))
        out[name] = {
            "weight_mse": float(np.mean((sw - tw) ** 2)),
            "weight_mae": float(np.mean(np.abs(sw - tw))),
            "weight_max_err": float(np.max(np.abs(sw - tw))),
            "weight_cosine": cos,
            "bias_mse": float(np.mean((sb - tb) ** 2)),
        }
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Compare distilled stems vs teacher")
    parser.add_argument("--config", required=True)
    parser.add_argument("--distilled", required=True)
    parser.add_argument("--teacher", required=True)
    parser.add_argument("--rgb-wavelengths", nargs=3, type=float, default=[0.665, 0.560, 0.490])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.core.config import load_model_config
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.train.distill import load_teacher_stems

    model = EOFluxVAE(load_model_config(args.config), device=args.device)
    model.load_checkpoint(args.distilled)
    teacher = load_teacher_stems(args.teacher)
    print(json.dumps(compare(model, teacher, args.rgb_wavelengths), indent=2))


if __name__ == "__main__":
    main()
