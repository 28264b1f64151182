"""What the adversarial stage 2's card checks can see, on one CUDA card.

Three parts, each printing one line per reading, then the card's name and
power limit:

- ``distances``: one generator + discriminator step of the tiny model of
  ``tests/test_torch_gan.py`` with EOPatchLoss and with EOGenerativeLoss, at
  the GAN's start step and one step before it (the GAN term gated off), on the
  card in fp32 and bf16 and on the CPU in bf16, each against fp32 on the CPU:
  the relative distance of the generator's and the discriminator's gradients,
  of the adaptive weight (read where the loss computes it, before the gate)
  and the worst of the spectral-norm u and σ. The card test holds fp32 at the
  start step and bf16 one step before it.
- ``losses``: ``chip_smoke.py`` phase 11's adversarial step at full width
  (``configs/finetune_gan.yaml``, disc_start 0, 12-band 256² B = 16, bf16, one
  fixed batch) for ``--steps`` steps at each ``--lr``: each step's
  reconstruction L1, MS-SSIM, GAN term, adaptive weight and discriminator
  loss, and the generator's whole loss.
- ``mutation``: the card test with every conv3x3 launch's output scaled by
  1 + e in the process, for each ``--scale`` e: which cases fail.

    python3 scripts/gan_check_probe.py [--parts distances,losses,mutation]
        [--lr 2e-4 1e-4] [--steps 30] [--scale 0.01 0.002]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def distances() -> None:
    import numpy as np
    import torch

    import test_torch_gan as t
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.losses import gan
    from eovax_torch.train import stage2

    FULL_PRECISION.activate()
    cfg = t._cfg(t.tcfg)
    variables = t.EOFluxVAE(cfg, device="cpu", seed=0).core.state_dict()
    image = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 4, 64, 64)).astype(np.float32))
    weights = []
    weight_fn = gan.adaptive_weight

    def recorded_weight(*args, **kw):
        w = weight_fn(*args, **kw)
        weights.append(float(w))
        return w

    gan.adaptive_weight = recorded_weight

    def step(loss_cfg, disc_state, device, policy, global_step):
        model = t.EOFluxVAE(cfg, variables, policy=policy, device=device)
        loss, disc, _ = t.build_loss_from_config(loss_cfg, cfg, policy=policy)
        disc.load_state_dict(disc_state)
        disc.to(device)
        keep = types.SimpleNamespace(zero_grad=lambda: None, step=lambda: torch.zeros(()))
        gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, keep, disc, keep,
                                                            cfg)
        state = stage2.TrainState(step=global_step)
        wvs = torch.from_numpy(t.WVS).to(device)
        _, recon, target = gen_step(state, image.to(device), wvs)
        grads = {f"g.{n}": p.grad.float().cpu() for n, p in model.core.named_parameters()}
        disc_step(state, target, wvs, recon)
        grads.update({f"d.{n}": p.grad.float().cpu() for n, p in disc.named_parameters()})
        stats = {k: v.cpu() for k, v in disc.state_dict().items() if k.endswith((".u", ".sigma"))}
        return grads, weights[-1], stats

    def distance(got, ref):
        (g, w, st), (rg, rw, rst) = got, ref
        out = {"weight": abs(w - rw) / abs(rw)}
        for prefix in ("g.", "d."):
            keys = [k for k in rg if k.startswith(prefix)]
            norm = torch.sqrt(sum(rg[k].double().square().sum() for k in keys))
            diff = torch.sqrt(sum((g[k].double() - rg[k].double()).square().sum() for k in keys))
            out[prefix] = (diff / norm).item()
        out["u/sigma"] = max((((st[k] - v).norm() / v.norm()).item() for k, v in rst.items()),
                             default=0.0)
        return out

    cuda = torch.device("cuda")
    try:
        for name, loss_cfg in (("EOPatchLoss", t.PATCH_CFG), ("EOGenerativeLoss", t.GEN_CFG)):
            disc_state = t.build_loss_from_config(loss_cfg, cfg, seed=4)[1].state_dict()
            start = loss_cfg.get("disc_start", loss_cfg.get("gan_start_step"))
            for global_step in (start - 1, start):
                ref = step(loss_cfg, disc_state, "cpu", FULL_PRECISION, global_step)
                for label, device, policy in (("card fp32", cuda, FULL_PRECISION),
                                              ("card bf16", cuda, DEFAULT_POLICY),
                                              ("cpu bf16", "cpu", DEFAULT_POLICY)):
                    got = step(loss_cfg, disc_state, device, policy, global_step)
                    d = " ".join(f"{k} {v:.4e}" for k, v in distance(got, ref).items())
                    print(f"distances {name} step {global_step} (GAN "
                          f"{'on' if global_step >= start else 'off'}) {label} vs cpu fp32: "
                          f"{d}; weight {got[1]:.6f} vs {ref[1]:.6f}", flush=True)
    finally:
        gan.adaptive_weight = weight_fn


def losses(lrs: list[float], steps: int) -> None:
    import torch

    import chip_smoke as cs
    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.train import stage2

    dev = torch.device("cuda")
    sd = cs.bench_state_dict(EOFluxVAE(cs.shipped_config(12), device=dev, seed=0), seed=0)
    *_, disc_sd = cs.gan_setup(sd, None, FULL_PRECISION, "cpu")
    s2 = torch.tensor(wavelengths_for("S2L2A"), device=dev)
    x = torch.randn(16, 12, 256, 256, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    for lr in lrs:
        cfg, model, loss, disc, _, _ = cs.gan_setup(sd, disc_sd, DEFAULT_POLICY, dev)
        cfg = dataclasses.replace(cfg, base_lr=lr)
        opt, schedule = stage2.make_optimizer(cfg, model.core.parameters())
        dopt = stage2.ClippedAdam(disc.parameters(), lr, clip_grad=None)
        gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, opt, disc, dopt,
                                                            cfg, schedule=schedule)
        state = stage2.TrainState()
        for i in range(steps):
            logs, recon, target = gen_step(state, x, s2)
            logs.update(disc_step(state, target, s2, recon))
            rec, g, ms = (float(logs[f"train/{k}"]) for k in ("loss_rec", "loss_g",
                                                               "loss_msssim"))
            part = rec + loss.ssim_weight * ms
            print(f"losses lr {lr:g} step {i}: whole {part + loss.disc_weight * g:.6f} "
                  f"rec part {part:.6f} (L1 {rec:.6f} msssim {ms:.6f}) "
                  f"gan term {g:.6f} weight {float(logs['train/disc_weight']):.6f} "
                  f"disc {float(logs['train/loss_disc']):.6f}", flush=True)
        del model, disc, opt, dopt, gen_step, disc_step
        torch.cuda.empty_cache()


def mutation(scales: list[float]) -> None:
    import pytest

    class Scale:
        def __init__(self, e):
            self.e = e

        def pytest_runtest_setup(self, item):
            from eovax_torch.kernels import conv3x3

            launch = getattr(conv3x3, "_unscaled_launch", conv3x3._launch)
            conv3x3._unscaled_launch = launch
            conv3x3._launch = lambda *a, **kw: launch(*a, **kw) * (1.0 + self.e)

    try:
        for e in scales:
            rc = pytest.main([str(ROOT / "tests" / "test_torch_gan.py"), "-m", "gpu",
                              "--noconftest", "-q", "-p", "no:cacheprovider", "-k", "card",
                              "-rfE", "--tb=line"], plugins=[Scale(e)])
            print(f"mutation: every conv3x3 output scaled by {1 + e:g}: pytest rc {int(rc)}",
                  flush=True)
    finally:
        from eovax_torch.kernels import conv3x3

        conv3x3._launch = getattr(conv3x3, "_unscaled_launch", conv3x3._launch)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", default="distances,losses,mutation")
    parser.add_argument("--lr", type=float, nargs="+", default=[2e-4, 1e-4])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--scale", type=float, nargs="+", default=[0.01, 0.002])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gan_check_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(f"kernel build: {cs.build_kernels():.1f} s", flush=True)
    parts = args.parts.split(",")
    if "distances" in parts:
        distances()
    if "losses" in parts:
        losses(args.lr, args.steps)
    if "mutation" in parts:
        mutation(args.scale)
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
