"""Dataset statistics CLI (reference: compute_stats.py +
eo_vae/datasets/compute_stats.py): streaming per-channel mean/std/min/max
over raw TerraMesh shards via the parallel Welford accumulator — where the
hard-coded normalization constants come from (SURVEY.md §2.2).

Port of ``eovax/cli/compute_stats.py``: host code (the shard reader and the
numpy accumulator), no device.

Usage:
    python -m eovax_torch.cli.compute_stats --data-path terramesh/ \
        --modality S2L2A --split val [--max-batches N] [--harmonize]
"""

from __future__ import annotations

import argparse
import json

from eovax_torch.utils.stats import RunningStats


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Streaming dataset statistics")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--modality", default="S2L2A")
    parser.add_argument("--split", default="val")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--harmonize", action="store_true",
                        help="apply the S2L2A +1000 post-baseline offset")
    parser.add_argument("--urls", nargs="+", default=None)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)

    from eovax_torch.data.terramesh import build_terramesh_dataset
    from eovax_torch.data.wavelengths import WAVELENGTHS

    channels = len(WAVELENGTHS.get(args.modality, [])) or None
    stats = None
    batches = build_terramesh_dataset(
        args.data_path, args.modality, args.split,
        urls=args.urls, batch_size=args.batch_size,
        harmonize_s2l2a=args.harmonize and args.modality == "S2L2A",
        partial=True,
    )
    n = 0
    for i, batch in enumerate(batches):
        if args.max_batches is not None and i >= args.max_batches:
            break
        x = batch["image"]  # NHWC
        if stats is None:
            stats = RunningStats((x.shape[-1],), (0, 1, 2))
        stats.update(x)
        n += x.shape[0]

    if stats is None:
        raise SystemExit("No data found")
    result = {args.modality: stats.to_dict(), "samples": n}
    print(json.dumps(result, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
