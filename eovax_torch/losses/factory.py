"""Stage-2 loss and discriminator construction from a config dict.

Port of ``eovax/losses/factory.py``: ``EOConsistencyLoss``, and the
adversarial ``EOPatchLoss`` over a ``DynamicPatchGAN`` and
``EOGenerativeLoss`` over an ``NLayerDiscriminator``. The reference passes
the encoder's dynamic ``conv_in`` to the DynamicPatchGAN as its input stem;
the port builds an owned stem with the same hyperparameters and asks the
trainer to seed it from the encoder's (``seed_disc_stem``).

DOFA, which feeds the consistency loss's feature term and the generative
loss's perceptual (LPIPS) term, is not ported yet (ROADMAP Queue 1 item 4b):
a term whose DOFA checkpoint is not on disk is disabled, as in the JAX
package; one whose checkpoint is there raises.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from eovax_torch.core.config import VAEConfig
from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.losses.consistency import EOConsistencyLoss
from eovax_torch.losses.gan import (
    DynamicPatchGAN,
    EOGenerativeLoss,
    EOPatchLoss,
    NLayerDiscriminator,
)
from eovax_torch.nn.init import init_parameters

#: keys EOPatchLoss accepts
_PATCH_KEYS = ("disc_start", "disc_weight", "ssim_weight")
#: keys EOGenerativeLoss accepts
_GEN_KEYS = (
    "perceptual_weight", "disc_weight", "gan_start_step",
    "disc_update_start_step", "max_d_weight", "disc_loss_type",
    "focal_loss_weight", "focal_loss_alpha",
)


def build_loss_from_config(loss_cfg: dict | None, vae_cfg: VAEConfig, *,
                           policy: Policy = FULL_PRECISION,
                           seed: int = 0) -> tuple[Any, torch.nn.Module | None, bool]:
    """The stage-2 loss named by ``loss_cfg['_target_']`` (empty: the
    consistency loss).

    Returns ``(loss, discriminator | None, seed_disc_stem)``. The
    discriminator is built on the CPU with weights drawn from ``seed`` + 1;
    ``seed_disc_stem`` asks the trainer to copy the encoder's ``conv_in``
    parameters into its dynamic input stem.
    """
    loss_cfg = dict(loss_cfg or {})
    target = loss_cfg.pop("_target_", "") or ""
    if target.endswith("EOPatchLoss"):
        return _build_patch_loss(loss_cfg, vae_cfg, policy, seed)
    if target.endswith("EOGenerativeLoss"):
        return _build_generative_loss(loss_cfg, policy, seed)
    if target and not target.endswith("EOConsistencyLoss"):
        raise ValueError(f"Unknown loss _target_: {target}")
    loss_cfg.pop("discriminator", None)
    dofa_cfg = loss_cfg.pop("dofa_net", None)
    if loss_cfg.get("feature_weight", 0) > 0 and dofa_cfg is not None:
        _dofa_absent(dofa_cfg, "feature")
        loss_cfg["feature_weight"] = 0.0
    return EOConsistencyLoss.from_dict(loss_cfg), None, False


def _init(disc: torch.nn.Module, seed: int) -> torch.nn.Module:
    init_parameters(disc, torch.Generator().manual_seed(seed + 1))
    return disc.eval()


def _build_patch_loss(loss_cfg: dict, vae_cfg: VAEConfig, policy: Policy, seed: int):
    disc_cfg = dict(loss_cfg.pop("discriminator", None) or {})
    disc_target = disc_cfg.pop("_target_", "")
    if disc_target and not disc_target.endswith("DynamicPatchGAN"):
        raise ValueError(f"EOPatchLoss expects a DynamicPatchGAN: {disc_target}")
    enc = vae_cfg.encoder
    seed_stem = bool(enc.use_dynamic_ops and enc.stem and enc.stem.mode == "conv")
    stem = enc.stem
    disc = DynamicPatchGAN(
        # The reference's stem is the encoder's conv_in, so ndf is the encoder's ch.
        ndf=disc_cfg.pop("ndf", enc.ch),
        n_layers=disc_cfg.pop("n_layers", 3),
        wv_planes=stem.wv_planes if seed_stem else 128,
        stem_num_layers=stem.num_layers if seed_stem else 1,
        stem_num_heads=stem.num_heads if seed_stem else 4,
        stem_generator_type=stem.generator_type if seed_stem else "transformer",
        stem_rank_ratio=stem.rank_ratio if seed_stem else 4,
        policy=policy,
    )
    if disc_cfg:
        raise ValueError(f"Unknown DynamicPatchGAN kwargs: {sorted(disc_cfg)}")
    loss = EOPatchLoss(**{k: loss_cfg.pop(k) for k in _PATCH_KEYS if k in loss_cfg})
    if loss_cfg:
        raise ValueError(f"Unknown EOPatchLoss kwargs: {sorted(loss_cfg)}")
    return loss, _init(disc, seed), seed_stem


def _build_generative_loss(loss_cfg: dict, policy: Policy, seed: int):
    disc_cfg = dict(loss_cfg.pop("discriminator", None) or {})
    disc_target = disc_cfg.pop("_target_", "")
    if disc_target and not disc_target.endswith("NLayerDiscriminator"):
        raise ValueError(f"EOGenerativeLoss expects an NLayerDiscriminator: {disc_target}")
    disc = NLayerDiscriminator(
        input_nc=disc_cfg.pop("input_nc", 3),
        ndf=disc_cfg.pop("ndf", 64),
        n_layers=disc_cfg.pop("n_layers", 3),
        policy=policy,
    )
    if disc_cfg:
        raise ValueError(f"Unknown NLayerDiscriminator kwargs: {sorted(disc_cfg)}")
    kwargs = {k: loss_cfg.pop(k) for k in _GEN_KEYS if k in loss_cfg}
    lpips_cfg = loss_cfg.pop("lpips", None)
    if kwargs.get("perceptual_weight", 1.0) > 0 and lpips_cfg is not None:
        _dofa_absent((lpips_cfg or {}).get("dofa_net") or {}, "perceptual")
        kwargs["perceptual_weight"] = 0.0
    if loss_cfg:
        raise ValueError(f"Unknown EOGenerativeLoss kwargs: {sorted(loss_cfg)}")
    return EOGenerativeLoss(**kwargs), _init(disc, seed), False


def _dofa_absent(dofa_cfg: dict, term: str) -> None:
    """Print that a DOFA term is disabled when its checkpoint is not on disk, as
    the JAX package does; raise when it is, since DOFA is not ported."""
    ckpt = dofa_cfg.get("ckpt_data") or dofa_cfg.get("weights_path")
    if ckpt and os.path.exists(ckpt):
        raise NotImplementedError(
            f"DOFA (the {term} term's network, checkpoint {ckpt!r}) is not ported yet: "
            "ROADMAP Queue 1 item 4b")
    print(
        f"[losses.factory] DOFA checkpoint {ckpt!r} not found — "
        "perceptual/feature term disabled (supply a converted ckpt to enable)"
    )
