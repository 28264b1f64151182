"""TerraMesh shard inspector + histogram CLI (reference:
eo_vae/datasets/inspect_terramesh.py + visualize_histogram.py): list shard
contents, decode a few samples, report shapes/dtypes/compressors and value
ranges, optionally accumulate a streaming histogram plot.

Port of ``eovax/cli/inspect_terramesh.py``: host code, no device.

Usage:
    python -m eovax_torch.cli.inspect_terramesh --shard majortom_shard_000001.tar \
        [--max-samples 4] [--histogram hist.png]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def inspect_shard(path: str, max_samples: int = 4) -> list[dict]:
    from eovax_torch.data.terramesh import iter_tar_samples
    from eovax_torch.data.zarrzip import ZarrZipGroup

    reports = []
    for i, sample in enumerate(iter_tar_samples(path)):
        if i >= max_samples:
            break
        rep: dict = {"key": sample.get("__key__")}
        for ext, blob in sample.items():
            if ext == "__key__":
                continue
            if ext.endswith("zarr.zip"):
                group = ZarrZipGroup(blob)
                arrays = {}
                for name in group.keys():
                    arr = group[name]
                    arrays[name] = {
                        "shape": list(np.shape(arr)),
                        "dtype": str(np.asarray(arr).dtype),
                        "min": float(np.min(arr)),
                        "max": float(np.max(arr)),
                    }
                rep[ext] = {"bytes": len(blob), "arrays": arrays}
            else:
                rep[ext] = {"bytes": len(blob)}
        reports.append(rep)
    return reports


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Inspect TerraMesh shards")
    parser.add_argument("--shard", required=True)
    parser.add_argument("--max-samples", type=int, default=4)
    parser.add_argument("--histogram", default=None,
                        help="accumulate a per-channel histogram PNG")
    parser.add_argument("--hist-range", nargs=2, type=float, default=[-1200, 1000])
    args = parser.parse_args(argv)

    reports = inspect_shard(args.shard, args.max_samples)
    print(json.dumps(reports, indent=2))

    if args.histogram:
        from eovax_torch.data.terramesh import decode_sample, iter_tar_samples
        from eovax_torch.utils.histogram import StreamingHistogram

        hist = None
        for i, raw in enumerate(iter_tar_samples(args.shard)):
            sample = decode_sample(raw)
            for k, v in sample.items():
                if isinstance(v, np.ndarray) and v.ndim == 3:
                    if hist is None:
                        hist = StreamingHistogram(
                            v.shape[-1], args.hist_range[0], args.hist_range[1]
                        )
                    hist.update(v[None])
        if hist is not None:
            print(f"Histogram saved to {hist.plot(args.histogram)}")


if __name__ == "__main__":
    main()
