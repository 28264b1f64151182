"""Bulk latent encoding CLI (reference: encode_latents.py).

Port of ``eovax/cli/encode_latents.py``. Encodes the Sen2NAIP LR/HR pairs
into .npz latents + latent_stats.json for stage-3 training: batches are
collated on the host, encoded on the card (bf16 ``DEFAULT_POLICY``), and
running statistics accumulate host-side (Welford).

Usage:
    python -m eovax_torch.cli.encode_latents --config model_config.yaml \
        --ckpt eo-vae.ckpt --data-root sen2naip/cross-sensor \
        --save-dir out/ [--use-spatial-norm] [--batch-size 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def _to_host(tensors: list[torch.Tensor]):
    """Queue fp32 copies of ``tensors`` to the host; returns a function that
    waits for them and gives numpy arrays.

    On the card the copies go into pinned memory with ``non_blocking=True``
    behind the work already queued, and the wait is on an event recorded
    after them, so the host blocks on nothing until it needs the values.
    """
    if tensors[0].device.type != "cuda":
        arrays = [t.float().numpy() for t in tensors]
        return lambda: arrays
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(t.float(), non_blocking=True)
        hosts.append(host)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))

    def wait():
        done.synchronize()
        return [h.numpy() for h in hosts]

    return wait


def encode_split(
    model,
    batches: Iterator[dict],
    output_dir: str,
    *,
    wvs: np.ndarray,
    stats_lr,
    stats_hr,
    use_spatial_norm: bool,
    split_name: str = "",
    compress: bool = True,
) -> int:
    """Encode one split: encode on the card → stats update → npz per AOI
    (encode_latents.py:305-352). Latents stored CHW (reference schema).

    Double-buffered: batch i+1's encode and its copy to the host are queued
    before the host waits for batch i's latents, so host-side collate,
    statistics and compression overlap the card's work; the zlib-bound npz
    writes run in an IO thread pool. ``compress=False`` writes plain .npz
    (np.load reads both) for hosts where single-core DEFLATE dominates.
    """
    savez = np.savez_compressed if compress else np.savez
    os.makedirs(output_dir, exist_ok=True)
    count = 0

    def dispatch(batch):
        # Batches arrive NHWC from the collates; the public API is NCHW.
        lr = np.transpose(np.asarray(batch["image_lr"]), (0, 3, 1, 2))
        hr = np.transpose(np.asarray(batch["image_hr"]), (0, 3, 1, 2))
        if use_spatial_norm:
            z_lr = model.encode_spatial_normalized(lr, wvs)
            z_hr = model.encode_spatial_normalized(hr, wvs)
        else:  # encoder-mean only (encode_latents.py:138-157)
            z_lr = model.encode(lr, wvs).mode()
            z_hr = model.encode(hr, wvs).mode()
        return _to_host([z_lr, z_hr]), lr, hr, batch["aoi"]

    with ThreadPoolExecutor(2) as io_pool:
        save_futures = []

        def finish(pending):
            nonlocal count
            wait, lr, hr, aois = pending
            z_lr, z_hr = wait()
            stats_lr(np.transpose(z_lr, (0, 2, 3, 1)))
            stats_hr(np.transpose(z_hr, (0, 2, 3, 1)))
            for i, aoi in enumerate(aois):
                save_futures.append(
                    io_pool.submit(
                        savez,
                        os.path.join(output_dir, f"{aoi}.npz"),
                        lr_latent=z_lr[i],
                        hr_latent=z_hr[i],
                        lr_image=lr[i],
                        hr_image=hr[i],
                    )
                )
                count += 1

        pending = None
        for batch in batches:
            current = dispatch(batch)  # queued on the card for this batch
            if pending is not None:
                finish(pending)  # fetch the previous batch while this one computes
            pending = current
        if pending is not None:
            finish(pending)
        for f in save_futures:
            f.result()
    return count


def reconstruction_check(
    model, batch: dict, wvs: np.ndarray, save_dir: str,
    *, max_images: int = 4,
) -> tuple[str, float]:
    """Pre-flight sanity check before a multi-hour bulk encode
    (encode_latents.py:204-297): reconstruct the first HR batch, render an
    input | reconstruction | error grid, and return the recon MSE so a
    bad/mismatched checkpoint aborts early instead of silently producing
    garbage latents."""
    from eovax_torch.utils.image_logger import _grid, _save_png, robust_to_uint8

    hr = np.transpose(np.asarray(batch["image_hr"]), (0, 3, 1, 2))[:max_images]
    recon = model.reconstruct(hr, wvs).float().cpu().numpy()
    mse = float(np.mean((recon - hr) ** 2))

    def rgb(x_nchw):
        x = np.transpose(x_nchw, (0, 2, 3, 1))[..., :3].astype(np.float32)
        return robust_to_uint8(np.nan_to_num(x, posinf=0.0, neginf=0.0))

    diff = np.abs(recon - hr).mean(axis=1, keepdims=True)
    diff = np.repeat(np.transpose(diff, (0, 2, 3, 1)), 3, axis=-1)
    diff = np.nan_to_num(
        diff / (diff.max() + 1e-8) * 255.0, posinf=255.0
    ).astype(np.uint8)
    grid = _grid([rgb(hr), rgb(recon), diff])
    path = os.path.join(save_dir, "reconstruction_check.png")
    _save_png(grid, path)
    return path, mse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Bulk-encode Sen2NAIP latents")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--use-spatial-norm", action="store_true")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    parser.add_argument(
        "--max-recon-mse", type=float, default=None,
        help="abort the bulk encode if the pre-flight reconstruction MSE "
        "exceeds this (non-finite MSE always aborts)",
    )
    parser.add_argument(
        "--skip-recon-check", action="store_true",
        help="skip the pre-flight reconstruction figure/gate",
    )
    parser.add_argument(
        "--no-compress", action="store_true",
        help="write plain .npz (skip DEFLATE) — for hosts where single-core "
        "compression bottlenecks the encode pipeline",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.sen2naip import (
        SEN2NAIP_WVS,
        Sen2NaipCrossSensor,
        sen2naip_collate,
    )
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.utils.stats import RunningStats

    model = EOFluxVAE.from_config(args.config, args.ckpt, policy=DEFAULT_POLICY,
                                  device=args.device)
    z = model.config.encoder.z_channels
    stats_lr = RunningStats((z,), (0, 1, 2))
    stats_hr = RunningStats((z,), (0, 1, 2))

    def batches_for(split):
        ds = Sen2NaipCrossSensor(args.data_root, split)
        for i in range(0, len(ds), args.batch_size):
            samples = [ds[j] for j in range(i, min(i + args.batch_size, len(ds)))]
            yield sen2naip_collate(samples)

    os.makedirs(args.save_dir, exist_ok=True)

    if not args.skip_recon_check:
        first_batch = next(batches_for(args.splits[0]), None)
        if first_batch is not None:
            path, mse = reconstruction_check(
                model, first_batch, SEN2NAIP_WVS, args.save_dir
            )
            print(f"Reconstruction check: MSE={mse:.6g} → {path}")
            if not np.isfinite(mse):
                raise SystemExit(
                    f"ABORT: non-finite reconstruction MSE ({mse}) — the "
                    "checkpoint/config pair is broken; inspect "
                    f"{path} before bulk encoding."
                )
            if args.max_recon_mse is not None and mse > args.max_recon_mse:
                raise SystemExit(
                    f"ABORT: reconstruction MSE {mse:.6g} exceeds "
                    f"--max-recon-mse {args.max_recon_mse} — inspect {path}."
                )

    total = 0
    for split in args.splits:
        n = encode_split(
            model,
            batches_for(split),
            os.path.join(args.save_dir, split),
            wvs=SEN2NAIP_WVS,
            stats_lr=stats_lr,
            stats_hr=stats_hr,
            use_spatial_norm=args.use_spatial_norm,
            split_name=split,
            compress=not args.no_compress,
        )
        print(f"Encoded {n} AOIs for split {split}")
        total += n

    stats_path = os.path.join(args.save_dir, "latent_stats.json")
    with open(stats_path, "w") as f:
        json.dump(
            {"lr_latent": stats_lr.to_dict(), "hr_latent": stats_hr.to_dict()},
            f, indent=4,
        )
    shutil.copy(args.config, os.path.join(args.save_dir, "model_config.yaml"))
    print(f"Encoded {total} AOIs; wrote {stats_path}")


if __name__ == "__main__":
    main()
