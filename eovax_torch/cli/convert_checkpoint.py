"""Checkpoint conversion CLI: reference torch files and the JAX package's
``.msgpack`` files, either way.

Port of ``eovax/cli/convert_checkpoint.py``, with the same flags. The input
is anything ``EOFluxVAE.load_checkpoint`` reads (a Lightning ``.ckpt``, a
stage-1 distilled ``.pt``, a Flux ``.safetensors``, a ``.msgpack``); the
output's extension picks its format: ``.msgpack``/``.eovax`` writes the JAX
package's variables file, anything else a torch file holding
``{"state_dict": ...}`` of the port, which ``load_checkpoint`` reads. A
conversion of files: the model is built on the host, and no card is needed.

Usage:
    python -m eovax_torch.cli.convert_checkpoint --config model_config.yaml \
        --input eo-vae.ckpt --output eo-vae.msgpack [--no-strict]
    python -m eovax_torch.cli.convert_checkpoint --config model_config.yaml \
        --input eo-vae.msgpack --output eo-vae.pt
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Convert checkpoints between formats")
    parser.add_argument("--config", required=True)
    parser.add_argument("--input", required=True,
                        help=".safetensors / .pt distilled / .ckpt full / .msgpack")
    parser.add_argument("--output", required=True,
                        help=".msgpack (the JAX package's) or a torch file (.pt, .ckpt)")
    parser.add_argument("--no-strict", action="store_true")
    parser.add_argument("--ignore-keys", nargs="*", default=[])
    args = parser.parse_args(argv)

    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.utils.checkpoint import save_variables

    model = EOFluxVAE.from_config(args.config, device="cpu")
    model.load_checkpoint(args.input, ignore_keys=tuple(args.ignore_keys),
                          strict=not args.no_strict)
    if args.output.endswith((".msgpack", ".eovax")):
        model.save(args.output)
    else:
        save_variables(args.output, model.core.state_dict())
    print(f"Converted {args.input} → {args.output} ({model.param_count():,} params)")


if __name__ == "__main__":
    main()
