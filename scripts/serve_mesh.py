"""Serving over the cards of one host: ``ServedModel.with_mesh`` against one card.

On a host with N cards, one process driving all of them:

    python3 scripts/serve_mesh.py

and its rehearsal on the CPU, a tiny model over the host repeated 4 times:

    python3 scripts/serve_mesh.py --tiny

The artifacts are ``chip_smoke.py``'s phase 15-17 ones, exported here on the
first card from phase 3's full-width weights (``bench_state_dict``): the bf16
``reconstruct`` (S2L2A 256²), the calibrated int8 one (static ranges from 4
images) and the DDIM-4 SR pipeline (phase 8's UNet, LR 128²). Over the mesh
of every visible card (``make_device_mesh()``):

1. bf16 and calibrated int8 ``reconstruct`` at B = 16 and 64: the mesh's
   result ``torch.equal`` to the first card's single-card calls on each row
   block, with exact launches (48/52/2 a block; int8 48 ``conv3x3_int8``), and
   each card's block finite (its GroupNorm launches succeeded: a second card's
   first launch failed before the kernel's attributes were kept per device);
2. ms per call, one card against the mesh (host clock over 10 calls after 2,
   every card synchronized), and the factor between them; beside it the same
   split issued from one host thread a card (``threaded``, a variant the
   package does not ship: ROADMAP S8), its result ``torch.equal`` to the
   mesh's;
3. the daemon with ``max_batch=16``: 64 B=1 ``reconstruct`` requests from 16
   client threads of another process (``chip_smoke.serve_clients``), one card
   against the mesh, and the mesh with a thread a card: requests/s, p50/p99,
   device calls;
4. the SR artifact's row i of B = N, each on its own card, ``torch.equal`` to
   its B = 1 call on the first card with seed 5+i;
5. where one card's call at B = 16 spends its host time, bf16 and calibrated
   int8: ``torch.profiler``'s host records of one call on the first card
   (after the mesh ran), the ops of most self time;
6. ``python -m eovax_torch.cli.serve --mesh`` as a process (cards only):
   announced over N devices, its warm-up at batch 1 and at N, one request,
   SIGTERM, exit 0.

Exits 1 when a check fails. The last line of standard output is a JSON
object of the readings, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from eovax_torch import EOFluxVAE  # noqa: E402
from eovax_torch.core import config as tcfg  # noqa: E402
from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION, INT8_POLICY  # noqa: E402
from eovax_torch.parallel.mesh import make_device_mesh  # noqa: E402
from eovax_torch.serving import (  # noqa: E402
    MeshServedModel,
    ServedModel,
    calibrate_activations,
    export_model,
    export_sr_pipeline,
)

def tiny_config(bands: int):
    stem = tcfg.StemConfig(num_layers=1, wv_planes=32)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    return tcfg.VAEConfig(encoder=tcfg.EncoderConfig(in_channels=bands, **kw),
                          decoder=tcfg.DecoderConfig(out_ch=bands, **kw))


def uncounted(label: str, fn, expected: dict | None):
    """``chip_smoke.drive`` without the counts (returned as 0): for the CPU
    rehearsal, where no kernel launches, and for calls issued from several
    threads, whose counters (a Python ``+=``) are not atomic."""
    out = fn()
    print(f"{label}: launches not counted")
    return out, cs.launches(0, 0, 0)


def threaded(view: MeshServedModel, pool: ThreadPoolExecutor):
    """``view._call`` with each card's block copied and issued from a thread of
    ``pool`` (one a card) instead of from the calling thread: the variant of
    ROADMAP S8, measured here beside the package's one-thread issue."""

    def call(name, x, modality, *extra):
        n, size = len(x), view._mesh.size
        if size == 1 or n % size:
            return ServedModel._call(view, name, x, modality, *extra)
        rows = n // size
        args = (torch.as_tensor(x, dtype=torch.float32), *extra)

        def block(i, dev):
            xb, *eb = (a[i * rows:(i + 1) * rows].to(dev) for a in args)
            return view._models[dev]._call(name, xb, modality, *eb)

        futures = [pool.submit(block, i, dev) for i, dev in enumerate(view._mesh.devices)]
        return torch.cat([f.result().to(view.device) for f in futures])

    return call


def host_ops(fn, device, top: int = 10) -> dict:
    """One ``fn()`` and a synchronize under ``torch.profiler`` (host records
    only): the wall ms and the ``top`` ops by self host time (ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync([device])
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"wall_ms": wall, "top": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                                     for e in rows[:top]]}


def sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def wall_ms(fn, devices, iters: int = 10, warmup: int = 2) -> float:
    """Host-clock ms a call over ``iters`` calls, every device synchronized."""
    for _ in range(warmup):
        fn()
    sync(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(devices)
    return (time.perf_counter() - t0) / iters * 1e3


def export_all(tiny: bool, device, out: Path, res: int) -> dict:
    """The three artifacts of the module docstring, the VAE's at ``res``² and the
    SR pipeline's at LR ``res // 2``²; returns the seconds each took."""
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.config import load_yaml
    from eovax_torch.models.sr_diffusion import RectifiedSchedule, SimpleDenoiser
    from eovax_torch.models.unet import UNet

    cfg = tiny_config(12) if tiny else cs.shipped_config(12)
    model = EOFluxVAE(cfg, policy=DEFAULT_POLICY, device=device, seed=0)
    sd = cs.bench_state_dict(model, seed=0)
    model.core.load_state_dict(sd)
    seconds = {}
    t0 = time.perf_counter()
    export_model(model, str(out / "bf16"), modalities=("S2L2A",), resolution=res,
                 functions=("reconstruct",))
    seconds["bf16"] = time.perf_counter() - t0
    live = EOFluxVAE(cfg, sd, policy=INT8_POLICY, device=device)
    images = np.random.default_rng(16).standard_normal((4, 12, res, res)).astype(np.float32)
    t0 = time.perf_counter()
    scales = calibrate_activations(live, [images], modality="S2L2A")
    export_model(live, str(out / "int8_calibrated"), modalities=("S2L2A",), resolution=res,
                 functions=("reconstruct",), act_scales=scales)
    seconds["int8_calibrated"] = time.perf_counter() - t0
    if tiny:
        torch.manual_seed(10)
        denoiser = SimpleDenoiser(RectifiedSchedule())
        unet = UNet(in_channels=8, out_channels=8, cond_channels=8, hid_channels=(32, 16),
                    hid_blocks=(1, 1)).to(device).eval()
    else:
        lm = load_yaml(str(cs.SR_CONFIG))["lightning_module"]
        denoiser, unet = build_denoiser_from_config(lm, policy=DEFAULT_POLICY, device=device)
        unet.load_state_dict(cs.sr_state_dict(unet, seed=10))
    t0 = time.perf_counter()
    export_sr_pipeline(model, denoiser, unet, str(out / "sr"), resolution=res // 2,
                       steps=cs.SR_STEPS)
    seconds["sr"] = time.perf_counter() - t0
    return seconds


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiny", action="store_true",
                        help="the rehearsal: the tests' tiny model on the CPU, 4 times over")
    args = parser.parse_args()

    on_cuda = not args.tiny
    card = cs.card_line() if on_cuda else "cpu"
    # The rehearsal checks the control flow at small sizes on a few threads.
    batches, iters, res = ((16, 64), 10, 256) if on_cuda else ((4, 8), 1, 32)
    n_requests = cs.SERVE_REQUESTS if on_cuda else 8
    if not on_cuda:
        torch.set_num_threads(2)
    if on_cuda:
        print(f"cards: {torch.cuda.device_count()} x {card}")
        print(f"kernel build: {cs.build_kernels():.1f} s")
    FULL_PRECISION.activate()  # fp32 references without TF32, as chip_smoke.py
    mesh = make_device_mesh() if on_cuda else make_device_mesh(["cpu"] * 4)
    first, n = mesh.devices[0], mesh.size
    per_block = {"bf16": cs.launches(48, 52, 2),
                 "int8_calibrated": cs.launches(0, 52, 2, conv_int8=48)}
    run = cs.drive if on_cuda else uncounted
    readings: dict = {"card": card, "devices": [str(d) for d in mesh.devices]}
    ok = True
    pool = ThreadPoolExecutor(max_workers=n)
    with pool, tempfile.TemporaryDirectory(prefix="serve_mesh_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        readings["export_s"] = export_all(args.tiny, first, tmp, res)
        print(f"exports (s): {readings['export_s']}")
        g = torch.Generator(first).manual_seed(1)
        x = torch.randn(max(batches), 12, res, res, generator=g, device=first)

        # ---- 1-2. the mesh against one card -----------------------------------------
        readings["reconstruct"] = {}
        for kind, per in per_block.items():
            served = ServedModel.load(str(tmp / kind), device=first)
            view = served.with_mesh(mesh)
            for b in batches:
                counts = cs.check_mesh(kind, served, mesh, x[:b], per, run)
                y, rows = view.reconstruct(x[:b]), b // n
                finite = [bool(torch.isfinite(y[i * rows:(i + 1) * rows]).all()) for i in range(n)]
                ok &= all(finite)
                one = wall_ms(lambda: served.reconstruct(x[:b]), [first], iters)
                many = wall_ms(lambda: view.reconstruct(x[:b]), mesh.devices, iters)
                view._call = threaded(view, pool)
                same = torch.equal(view.reconstruct(x[:b]), y)
                ok &= same
                threads = wall_ms(lambda: view.reconstruct(x[:b]), mesh.devices, iters)
                del view._call
                if b == batches[0]:
                    ops = host_ops(lambda: served.reconstruct(x[:b]), first)
                    readings.setdefault("host_ops", {})[f"{kind} B={b}"] = ops
                    print(f"host records of one {kind} reconstruct [{b},12,{res},{res}] on "
                          f"{first} (profiled, {ops['wall_ms']:.3f} ms wall): "
                          + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, c, ms in ops["top"]))
                readings["reconstruct"][f"{kind} B={b}"] = dict(
                    launches=counts, one_card_ms=one, mesh_ms=many, factor=one / many,
                    finite=all(finite), threads_ms=threads, threads_factor=one / threads,
                    threads_equal=same)
                print(f"time {kind} reconstruct [{b},12,{res},{res}]: one card {one:.3f} ms, "
                      f"{n} devices {many:.3f} ms, factor {one / many:.3f}; a thread a card "
                      f"{threads:.3f} ms, factor {one / threads:.3f}, torch.equal {same}; each "
                      f"device's block finite {finite} [{card}]")
            del served, view
        cs.stamp("mesh against one card")

        # ---- 3. the daemon ------------------------------------------------------------
        served = ServedModel.load(str(tmp / "bf16"), device=first)
        requests = tmp / "requests.npy"
        np.save(requests, np.random.default_rng(40).standard_normal(
            (n_requests, 1, 12, res, res)).astype(np.float32))
        from eovax_torch.serving.server import warmup

        readings["daemon"] = {}
        view = served.with_mesh(mesh)
        for label, target, blocks in (("one card", served, 1), (f"{n} devices", view, n),
                                      (f"{n} devices, a thread a card", view, n)):
            warmup(target, batch_sizes=(1, 2, 4, 8, 16))  # graphs load before any thread runs
            per_call = {k: blocks * v for k, v in per_block["bf16"].items()}
            counter = run
            if "thread" in label:
                view._call, counter = threaded(view, pool), uncounted
            if counter is uncounted:  # the daemon's check reads the counts
                per_call = dict.fromkeys(per_call, 0)
            _, readings["daemon"][label] = cs.serve_clients(target, requests, 16, card, per_call,
                                                            counter)
        cs.stamp("daemon")

        # ---- 4. the SR artifact's rows on their cards ----------------------------------
        sr = ServedModel.load(str(tmp / "sr"), device=first)
        lr = torch.randn(n, 4, res // 2, res // 2, generator=g, device=first)
        readings["sr_launches"] = cs.check_mesh_sr(sr, mesh, lr, 5, cs.launches(*cs.SR_CALL),
                                                   run)
        cs.stamp("SR rows")

        # ---- 6. serve --mesh as a process ----------------------------------------------
        if on_cuda:
            lines = cs.serve_cli_process(tmp / "bf16", card, ("--mesh",))
            want = (f"data-parallel over {n} devices",
                    f"warmed {1 if n == 1 else 2} function×batch combinations")
            readings["serve_cli"] = lines
            if not all(w in lines for w in want):
                print(f"serve --mesh printed {lines}, not {want}")
                ok = False
            cs.stamp("serve --mesh")

    print(card)
    print(json.dumps({"ok": ok, **readings}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
