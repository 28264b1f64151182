"""Full-pipeline benchmark CLI with the reference's JSON result schema
(``benchmark_compute.py``): per-stage encode / SR / decode latency, throughput,
parameter counts, peak memory; ``--all``, one JSON over the hot paths;
``--int8-quality``, the PSNR / MS-SSIM table of int8 against bf16 serving.

Port of ``eovax/cli/benchmark.py``, with the same arguments and JSON keys and
one more argument, ``--device`` (CUDA unless told otherwise; raises without a
card).

Timing: the default mode chains each stage through a data dependency (a scalar
of the previous output fed back into the input): one call to build (the
kernels, cuDNN's choice), one warm, then one chain timed over ``--iters``
iterations with one ``torch.cuda.synchronize`` at the end. ``--all`` takes the
slope of two such chain lengths (``eovax_torch.utils.slopetime``), except the
bulk encode, which is wall clock around ``encode_split``. Peak memory is
``torch.cuda.max_memory_allocated`` since the start of the run (none on the CPU).

Usage:
    python -m eovax_torch.cli.benchmark --name eo-vae [--batch 1] [--iters 50] \\
        [--sr-steps 50] [--output results.json] [--all | --int8-quality] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
import zlib

import numpy as np

# --all's settings. Module names, so that a test can shrink them.
ALL_BATCH = 16
ALL_RESOLUTION = 256
ALL_LO, ALL_HI = 10, 30  # slope chain lengths: reconstruct and the serving artifact
TRAIN_LO, TRAIN_HI = 6, 18  # and the train step
ALL_STEM = {"num_layers": 4, "wv_planes": 256}  # StemConfig of every --all model
ALL_WIDTHS: dict = {}  # Encoder/DecoderConfig widths beyond bands and stem (the defaults)
TRAIN_LOSS = {"pixel_weight": 1.0, "rec_loss_type": "char", "msssim_weight": 1.0,
              "msssim_start_step": 0}
SR_RUNS = (("ddim50", "ddim", 50), ("dpmpp2m25", "dpm++2m", 25))  # tag, sampler, steps
SR_ARGV = ["--batch", "1", "--resolution", "128", "--iters", "20"]  # the SR sub-runs
BULK_RESOLUTION = 512
BULK_RUNS = (("uncompressed", False, 4), ("compressed", True, 2))  # tag, DEFLATE, batches
BULK_WVS = (0.665, 0.56, 0.49, 0.842)

QUALITY_DATA_RANGE = 6.0  # the reference's data_range for normalized units


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_memory_gb(device) -> float | None:
    """Peak allocated device memory since the run's start, GiB (None on the CPU)."""
    import torch

    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device)
    return round(peak / 1024**3, 3) if peak else None


def _chained_ms(body, x0, iters: int) -> float:
    """Average ms of ``body`` per iteration of one chain of ``iters`` calls, each
    input the first plus 1e-20 × the mean of the previous output (a full-tensor
    reduction: the whole output is computed), timed with one synchronize at the
    end, after one call to build (the kernels, cuDNN's choice) and one to warm."""
    import torch

    def loop(n):
        s = torch.zeros((), dtype=torch.float32, device=x0.device)
        for _ in range(n):
            out = body(x0 + s.to(x0.dtype))
            s = out.float().mean() * 1e-20
        return s

    for _ in range(2):  # build, warm
        loop(1)
        _sync(x0.device)
    t0 = time.perf_counter()
    loop(iters)
    _sync(x0.device)
    return (time.perf_counter() - t0) / iters * 1000.0


def _count(module) -> int:
    return sum(p.numel() for p in module.parameters())


def main(argv=None, *, emit_marker: bool = True) -> None:
    parser = argparse.ArgumentParser(description="EO-VAE pipeline benchmark")
    parser.add_argument("--name", default="eo-vae")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--resolution", type=int, default=128, help="LR input size")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--sr-steps", type=int, default=50)
    parser.add_argument(
        "--sr-sampler", default="ddim", choices=("ddim", "dpm++2m"),
        help="'ddim' or 'dpm++2m' (second-order: ~half the steps)",
    )
    parser.add_argument("--output", default=None)
    parser.add_argument("--config", default=None, help="optional model_config.yaml")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument(
        "--precision", default="16-mixed",
        help="'32-true', '16-mixed' (bf16, default), or 'int8' (W8A8 body convs)",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="ONE JSON covering reconstruct bf16/int8, the stage-2 train step, the 512px "
        "SR pipeline (DDIM-50 and DPM++(2M)-25), the exported serving artifact and the "
        "bulk latent encode",
    )
    parser.add_argument(
        "--int8-quality", action="store_true",
        help="emit a per-modality PSNR/MS-SSIM table of int8 vs bf16 "
        "reconstruction (the quality gate for quantized serving) instead "
        "of the timing benchmark",
    )
    parser.add_argument(
        "--modalities", nargs="+",
        default=["S2RGB", "S1RTC", "S2L2A", "S2L1C"],
        help="--int8-quality: modalities to tabulate",
    )
    parser.add_argument(
        "--quality-npz", default=None,
        help="--int8-quality: .npz with one NCHW array per modality "
        "(normalized units); synthetic smooth fields otherwise",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import torch

    from eovax_torch.core.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    if args.all:
        _bench_all(args, device)
        return

    from eovax_torch.core.config import DecoderConfig, EncoderConfig, StemConfig, VAEConfig
    from eovax_torch.core.precision import policy_from_name
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.models.sr_diffusion import RectifiedSchedule, SimpleDenoiser, make_sampler
    from eovax_torch.models.unet import UNet
    from eovax_torch.nn.init import init_parameters

    policy = policy_from_name(args.precision)
    if args.config:
        model = EOFluxVAE.from_config(args.config, args.ckpt, policy=policy, device=device)
    else:
        stem = StemConfig(num_layers=4, wv_planes=256)
        cfg = VAEConfig(
            encoder=EncoderConfig(in_channels=4, stem=stem),
            decoder=DecoderConfig(out_ch=4, stem=stem),
        )
        model = EOFluxVAE(cfg, policy=policy, device=device)

    if args.int8_quality:
        _int8_quality_table(model, args, device)
        return

    z = model.config.encoder.z_channels
    wvs = torch.as_tensor(SEN2NAIP_WVS, device=device)
    lr = torch.from_numpy(
        np.random.default_rng(0).standard_normal(
            (args.batch, 4, args.resolution, args.resolution), dtype=np.float32
        )
    ).to(device)

    # SR denoiser (latent-space UNet per eo_vae_latent.yaml:32-48), weights from seed 0.
    unet = UNet(in_channels=z, out_channels=z, cond_channels=z,
                hid_channels=(256, 128, 64), hid_blocks=(3, 3, 3), policy=policy)
    init_parameters(unet, torch.Generator().manual_seed(0))
    unet.to(device).eval()
    sampler = make_sampler(args.sr_sampler, SimpleDenoiser(RectifiedSchedule()),
                           steps=args.sr_steps)

    with torch.inference_mode():
        z_lr = model.encode_spatial_normalized(lr, wvs)
        x1 = sampler.init(torch.Generator(device).manual_seed(2), z_lr.shape)
        pred = sampler(unet, x1, z_lr)
        out = model.decode_spatial_normalized(pred, wvs)

        avg_encode = _chained_ms(lambda x: model.encode_spatial_normalized(x, wvs), lr,
                                 args.iters)
        avg_sr = _chained_ms(lambda a: sampler(unet, a, z_lr), x1, args.iters)
        avg_decode = _chained_ms(lambda p: model.decode_spatial_normalized(p, wvs), pred,
                                 args.iters)
    avg_total = avg_encode + avg_sr + avg_decode
    throughput = args.batch * 1000.0 / avg_total

    encoder, decoder = _count(model.core.encoder), _count(model.core.decoder)
    result = {
        "name": args.name,
        "model_type": "eo-vae",
        "architecture": {
            "input_shape": list(lr.shape),
            "output_shape": list(out.shape),
            "latent_channels": z,
            "compression_ratio": "64:1",
        },
        "parameters": {
            "sr_model": _count(unet),
            "encoder": encoder,
            "decoder": decoder,
            "total": _count(unet) + encoder + decoder,
        },
        "memory_gb": {"peak_memory": _peak_memory_gb(device)},
        "timing_ms": {
            "encode": round(avg_encode, 2),
            "sr_forward": round(avg_sr, 2),
            "decode": round(avg_decode, 2),
            "total": round(avg_total, 2),
        },
        "throughput_imgs_per_sec": round(throughput, 2),
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    if emit_marker:
        # Exactly ONE JSON_RESULT line per invocation is the stdout contract
        # consumers grep for; --all's nested SR sub-runs pass emit_marker=False
        # so only the final ledger prints it.
        print(f"JSON_RESULT:{json.dumps(result)}")


def _all_config(bands: int):
    from eovax_torch.core.config import DecoderConfig, EncoderConfig, StemConfig, VAEConfig

    stem = StemConfig(**ALL_STEM)
    return VAEConfig(encoder=EncoderConfig(in_channels=bands, stem=stem, **ALL_WIDTHS),
                     decoder=DecoderConfig(out_ch=bands, stem=stem, **ALL_WIDTHS),
                     base_lr=1e-4, clip_grad=1.0)


def _random_core(cfg, policy, rng, device):
    """An ``EOVAECore`` of ``cfg`` under ``policy`` with N(0, 0.02) weights drawn
    on the host from ``rng``, in eval mode on ``device``."""
    from eovax_torch.models.backbone import EOVAECore
    from eovax_torch.utils.slopetime import random_variables

    policy.activate()
    core = EOVAECore(cfg.encoder, cfg.decoder, policy)
    core.load_state_dict(random_variables(core, rng))
    return core.to(device).eval()


def _bench_reconstruct(core, x, wvs) -> float:
    """ms per ``reconstruct`` (the forward on the posterior's mode) by slope."""
    import torch

    from eovax_torch.utils.slopetime import chained_ms

    def body(c, y):
        # Contiguous, as EOFluxVAE takes its input: the decoder's last conv (cuDNN)
        # may return channels-last, and the kernels take contiguous NCHW.
        recon, _ = c(y.contiguous(), wvs, sample_posterior=False)
        return torch.tanh(recon).float()

    with torch.inference_mode():
        return chained_ms(body, x, core, ALL_LO, ALL_HI)


def _bench_train_step(core, cfg, x, wvs) -> float:
    """ms per stage-2 generator step (fwd + bwd + Adam with the clip) by slope, every
    step's draws from one seed (the JAX loop passes one key to every step)."""
    import torch

    from eovax_torch.losses import EOConsistencyLoss
    from eovax_torch.train.stage2 import TrainState, make_optimizer, make_train_step
    from eovax_torch.utils.slopetime import slope_ms

    opt, _ = make_optimizer(cfg, list(core.parameters()))
    step_fn = make_train_step(core, EOConsistencyLoss(**TRAIN_LOSS), opt, cfg)
    generator = torch.Generator(x.device)

    def loop(state, n):
        logs = None
        for _ in range(n):
            generator.manual_seed(0)
            logs = step_fn(state, x, wvs, generator)
        return logs

    return slope_ms(loop, TrainState(), TRAIN_LO, TRAIN_HI)


def _bench_sr_pipeline(device) -> dict:
    """The default mode at the SR runs' settings, through a temporary --output."""
    rows = {}
    for tag, sampler_name, steps in SR_RUNS:
        # Per-invocation temp path: a fixed name would let a concurrent --all run
        # (or a stale file from an aborted one) feed foreign numbers into this ledger.
        fd, sr_out = tempfile.mkstemp(prefix=f"eovax_bench_sr_{tag}_", suffix=".json")
        os.close(fd)
        try:
            main([*SR_ARGV, "--sr-sampler", sampler_name, "--sr-steps", str(steps),
                  "--name", f"sr_{tag}", "--output", sr_out, "--device", str(device)],
                 emit_marker=False)
            with open(sr_out) as f:
                r = json.load(f)
        finally:
            os.unlink(sr_out)
        rows[f"sr_pipeline_512_{tag}"] = {
            "timing_ms": r["timing_ms"],
            "throughput_imgs_per_sec": r["throughput_imgs_per_sec"],
        }
        print(f"sr_pipeline_512_{tag}: {r['timing_ms']['total']} ms", flush=True)
    return rows


def _bench_serving(cfg, rng, x, device) -> float:
    """ms per ``reconstruct`` of an exported bf16 artifact (S2L2A), loaded back, by
    slope. Only the timed function is exported."""
    import torch

    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.serving import ServedModel, export_model
    from eovax_torch.utils.slopetime import chained_ms, random_variables

    model = EOFluxVAE(cfg, policy=DEFAULT_POLICY, device=device)
    model.core.load_state_dict(random_variables(model.core, rng))
    out = tempfile.mkdtemp(prefix="eovax_ledger_artifact_")
    try:
        export_model(model, out, modalities=("S2L2A",), resolution=x.shape[-1],
                     functions=("reconstruct",))
        del model
        served = ServedModel.load(out, device)
        fn = served._fn("reconstruct", "S2L2A")
        with torch.inference_mode():
            return chained_ms(lambda state, y: torch.tanh(fn(state, y.contiguous())).float(), x,
                              served._state, ALL_LO, ALL_HI)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _bench_encode_bulk(rng, device) -> dict:
    """``encode_split`` (double-buffered dispatch, host running statistics, npz
    writes in an IO pool) over recycled Sen2NAIP-shaped pairs, wall clock: the
    host's work is part of the path. One batch is drawn and recycled, so data
    synthesis (the stand-in for rasterio reads) stays out of the measurement."""
    from eovax_torch.cli.encode_latents import encode_split
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.utils.stats import RunningStats

    b, res = ALL_BATCH, BULK_RESOLUTION
    sr_wvs = np.asarray(BULK_WVS, np.float32)
    cfg = _all_config(4)
    bulk_model = EOFluxVAE(cfg, policy=DEFAULT_POLICY, seed=0, device=device)
    lr_b = rng.standard_normal((b, res, res, 4), dtype=np.float32)
    hr_b = rng.standard_normal((b, res, res, 4), dtype=np.float32)

    def pair_batches(n):
        for i in range(n):
            yield {"image_lr": lr_b, "image_hr": hr_b,
                   "aoi": [f"bench_{i:03d}_{j:02d}" for j in range(b)]}

    bulk_out = tempfile.mkdtemp(prefix="eovax_bench_bulk_")
    z = cfg.encoder.z_channels
    row: dict = {"batch": b, "resolution": res, "spatial_norm": True}
    try:
        for tag, compress, n_batches in BULK_RUNS:
            stats_lr = RunningStats((z,), (0, 1, 2))
            stats_hr = RunningStats((z,), (0, 1, 2))
            sub = os.path.join(bulk_out, tag)
            kw = dict(wvs=sr_wvs, stats_lr=stats_lr, stats_hr=stats_hr, use_spatial_norm=True,
                      compress=compress)
            encode_split(bulk_model, pair_batches(1), sub, **kw)  # warm, outside the window
            t0 = time.perf_counter()
            n = encode_split(bulk_model, pair_batches(n_batches), sub, **kw)
            wall = time.perf_counter() - t0
            shutil.rmtree(sub, ignore_errors=True)
            row[f"pairs_per_sec_{tag}"] = round(n / wall, 2)
            # Each AOI pair = two 512² patch encodes (LR upsampled to HR size in the
            # collate, and HR).
            row[f"patches_512_per_sec_{tag}"] = round(2 * n / wall, 2)
            print(f"encode_latents_bulk[{tag}]: {n / wall:.2f} pairs/s "
                  f"({2 * n / wall:.2f} 512² patch encodes/s, {n} pairs)", flush=True)
    finally:
        shutil.rmtree(bulk_out, ignore_errors=True)
    return row


def _bench_all(args, device) -> None:
    """One JSON over the hot paths, each timed by the slope of two chain lengths
    (min of 2 runs each, one synchronize), but the bulk encode (wall clock)."""
    import torch

    from eovax_torch.core.precision import DEFAULT_POLICY, INT8_POLICY
    from eovax_torch.data.wavelengths import wavelengths_for

    b, res = ALL_BATCH, ALL_RESOLUTION
    rng = np.random.default_rng(0)
    ledger: dict = {"mode": "all",
                    "methodology": "slope of two chained-launch lengths, min-of-2, one sync"}
    wvs = torch.as_tensor(wavelengths_for("S2L2A"), device=device)
    x = torch.from_numpy(np.ascontiguousarray(
        rng.standard_normal((b, res, res, 12), dtype=np.float32).transpose(0, 3, 1, 2)
    )).to(device)
    cfg = _all_config(12)

    # ---- reconstruct bf16 / int8 (the headline, both policies) ----------------
    for tag, policy in (("bf16", DEFAULT_POLICY), ("int8", INT8_POLICY)):
        core = _random_core(cfg, policy, rng, device)
        ms = _bench_reconstruct(core, x, wvs)
        del core
        ledger[f"reconstruct_{tag}"] = {
            "batch": b, "ms_per_batch": round(ms, 2),
            "imgs_per_sec": round(b * 1e3 / ms, 1),
        }
        print(f"reconstruct_{tag}: {b * 1e3 / ms:.1f} imgs/s", flush=True)

    # ---- stage-2 train step (char + MS-SSIM, fwd+bwd+Adam) ---------------------
    core = _random_core(cfg, DEFAULT_POLICY, rng, device)
    ms = _bench_train_step(core, cfg, x, wvs)
    del core
    ledger["train_step_bf16"] = {
        "batch": b, "ms_per_step": round(ms, 2),
        "imgs_per_sec": round(b * 1e3 / ms, 1),
        "loss": "char+msssim", "optimizer": "adam+clip",
    }
    print(f"train_step: {ms:.1f} ms ({b * 1e3 / ms:.1f} imgs/s)", flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 512px SR pipeline, DDIM-50 and DPM++(2M)-25 ---------------------------
    ledger.update(_bench_sr_pipeline(device))

    # ---- exported serving artifact (bf16) --------------------------------------
    ms = _bench_serving(cfg, rng, x, device)
    ledger["serving_artifact_bf16"] = {
        "batch": b, "ms_per_batch": round(ms, 2),
        "imgs_per_sec": round(b * 1e3 / ms, 1),
    }
    print(f"serving_artifact_bf16: {b * 1e3 / ms:.1f} imgs/s", flush=True)

    # ---- bulk latent encoding (the encode_latents hot path) --------------------
    ledger["encode_latents_bulk"] = _bench_encode_bulk(rng, device)

    if args.output:
        with open(args.output, "w") as f:
            json.dump(ledger, f, indent=2)
    print(f"JSON_RESULT:{json.dumps(ledger)}")


def synthetic_field(modality: str, batch: int, res: int, channels: int) -> np.ndarray:
    """--int8-quality's smooth stand-in image, NCHW fp32: N(0, 1) noise at res/8
    from a crc32 seed of the modality's name (str hashing is salted per process),
    upsampled by half-pixel bilinear interpolation (``jax.image.resize``'s
    "linear" when upsampling)."""
    from eovax_torch.utils.resize import resize_nhwc

    g = np.random.default_rng(zlib.crc32(modality.encode()))
    lo = g.standard_normal((batch, res // 8, res // 8, channels)).astype(np.float32)
    x = resize_nhwc(lo, (res, res), "bilinear")
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)), dtype=np.float32)


def _int8_quality_table(model, args, device):
    """Per-modality PSNR / MS-SSIM of int8 against bf16 reconstruction, the
    quality gate for quantized serving. With --ckpt the numbers are the real
    serving quality; without, they still bound the quantization error
    mechanism on random weights (stated in the output)."""
    import torch

    from eovax_torch.core.precision import DEFAULT_POLICY, INT8_POLICY
    from eovax_torch.data.wavelengths import WAVELENGTHS
    from eovax_torch.losses.msssim import multiscale_ssim
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.utils.metrics import psnr

    state = model.core.state_dict()
    bf16 = EOFluxVAE(model.config, state, policy=DEFAULT_POLICY, device=device)
    q = EOFluxVAE(model.config, state, policy=INT8_POLICY, device=device)

    data = np.load(args.quality_npz) if args.quality_npz else None
    res = args.resolution
    # MS-SSIM over 5 scales needs a side above 64 (kernel 5).
    rows = {}
    for modality in args.modalities:
        wvs = torch.as_tensor(WAVELENGTHS[modality], dtype=torch.float32, device=device)
        c = len(WAVELENGTHS[modality])
        if data is not None and modality in data:
            x = np.asarray(data[modality], np.float32)
        else:
            x = synthetic_field(modality, args.batch, res, c)
        tgt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        r_b = bf16.reconstruct(tgt, wvs).float()
        r_q = q.reconstruct(tgt, wvs).float()
        m = {
            "psnr_bf16": float(psnr(r_b, tgt, data_range=QUALITY_DATA_RANGE)),
            "psnr_int8": float(psnr(r_q, tgt, data_range=QUALITY_DATA_RANGE)),
            # fp32 without TF32 (EOFluxVAE activates its policy): a quality
            # measurement, 4-decimal deltas.
            "msssim_bf16": float(multiscale_ssim(r_b, tgt, data_range=QUALITY_DATA_RANGE)),
            "msssim_int8": float(multiscale_ssim(r_q, tgt, data_range=QUALITY_DATA_RANGE)),
        }
        m["psnr_delta"] = m["psnr_int8"] - m["psnr_bf16"]
        m["msssim_delta"] = m["msssim_int8"] - m["msssim_bf16"]
        rows[modality] = {k: round(v, 4) for k, v in m.items()}

    result = {
        "mode": "int8-quality",
        "weights": "checkpoint" if args.ckpt else "random-init (mechanism check only)",
        "batch": args.batch,
        "resolution": res,
        "modalities": rows,
    }
    hdr = (f"{'modality':10} {'PSNR bf16':>10} {'PSNR int8':>10} {'ΔPSNR':>8} "
           f"{'MS-SSIM bf16':>13} {'MS-SSIM int8':>13} {'Δ':>8}")
    print(hdr)
    for mod, m in rows.items():
        print(f"{mod:10} {m['psnr_bf16']:10.2f} {m['psnr_int8']:10.2f} "
              f"{m['psnr_delta']:8.3f} {m['msssim_bf16']:13.4f} "
              f"{m['msssim_int8']:13.4f} {m['msssim_delta']:8.4f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    print(f"JSON_RESULT:{json.dumps(result)}")


if __name__ == "__main__":
    main()
