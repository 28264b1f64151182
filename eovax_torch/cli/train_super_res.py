"""Stage-3 latent-SR training CLI (reference: train_super_res.py).

Port of ``eovax/cli/train_super_res.py``'s ``build_denoiser_from_config``,
which the SR sampling and evaluation paths use. Its ``main`` (the training
loop) comes with SR training, ``ROADMAP.md`` Queue 1 item 6b.
"""

from __future__ import annotations

import torch


def build_denoiser_from_config(cfg: dict, *, policy=None, seed: int = 0,
                               device: str | torch.device | None = None):
    """UNet, schedule and denoiser from a reference-format config block
    (configs_superres/eo_vae_latent.yaml:32-48). Returns ``(denoiser, unet)``:
    the UNet, with weights drawn from ``seed``, is on ``device`` (CUDA unless
    told otherwise; raises without a card) in eval mode."""
    from eovax_torch.core.device import resolve_device
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.models.sr_diffusion import (
        DecaySchedule,
        KarrasDenoiser,
        RectifiedSchedule,
        SimpleDenoiser,
        VPSchedule,
    )
    from eovax_torch.models.unet import UNet
    from eovax_torch.nn.init import init_parameters

    policy = policy or DEFAULT_POLICY
    device = resolve_device(device)
    policy.activate()
    den_cfg = cfg["denoiser"]
    bb = den_cfg["backbone"]
    unet = UNet(
        in_channels=bb.get("in_channels", 32),
        out_channels=bb.get("out_channels", 32),
        cond_channels=bb.get("cond_channels", 0),
        hid_channels=tuple(bb.get("hid_channels", (256, 128, 64))),
        hid_blocks=tuple(bb.get("hid_blocks", (3, 3, 3))),
        policy=policy,
    )
    init_parameters(unet, torch.Generator().manual_seed(seed))
    unet.to(device).eval()

    sched_target = den_cfg.get("schedule", {}).get("_target_", "RectifiedSchedule")
    if "VPSchedule" in sched_target:
        schedule = VPSchedule()
    elif "DecaySchedule" in sched_target:
        schedule = DecaySchedule()
    else:
        schedule = RectifiedSchedule()

    den_target = den_cfg.get("_target_", "SimpleDenoiser")
    cls = KarrasDenoiser if "Karras" in den_target else SimpleDenoiser
    return cls(schedule=schedule), unet


def main(argv=None) -> None:
    raise NotImplementedError(
        "stage-3 SR training (this CLI and its trainer) is not ported yet: "
        "ROADMAP Queue 1 item 6b")


if __name__ == "__main__":
    main()
