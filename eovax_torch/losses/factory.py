"""Stage-2 loss and discriminator construction from a config dict.

Port of ``eovax/losses/factory.py``: ``EOConsistencyLoss``, and the
adversarial ``EOPatchLoss`` over a ``DynamicPatchGAN`` and
``EOGenerativeLoss`` over an ``NLayerDiscriminator``. The reference passes
the encoder's dynamic ``conv_in`` to the DynamicPatchGAN as its input stem;
the port builds an owned stem with the same hyperparameters and asks the
trainer to seed it from the encoder's (``seed_disc_stem``).

DOFA feeds the consistency loss's feature term and the generative loss's
perceptual (LPIPS) term: its ``dofa_net`` block names a builder of
``eovax_torch.models.dofa`` and a local checkpoint (``ckpt_data`` or
``weights_path``). As in the JAX package, a term whose checkpoint is not on
disk, whose builder is unknown or whose builder raises ``NotImplementedError``
is disabled with a message. The DOFA network is built on the CPU, frozen (no
gradient on its parameters, eval mode) and fp32 whatever the VAE's policy;
the loss holds it as a module (``DOFALPIPS`` or ``DOFAFeatures``), which
``Stage2Trainer`` moves to its device once.
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
        feats = _build_dofa_features(dofa_cfg)
        if feats is None:
            loss_cfg["feature_weight"] = 0.0
        loss_cfg["dofa_features"] = feats
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
    lpips_apply = None
    if kwargs.get("perceptual_weight", 1.0) > 0 and lpips_cfg is not None:
        lpips_apply = _build_lpips(lpips_cfg)
        if lpips_apply is None:
            kwargs["perceptual_weight"] = 0.0
    if loss_cfg:
        raise ValueError(f"Unknown EOGenerativeLoss kwargs: {sorted(loss_cfg)}")
    return EOGenerativeLoss(lpips_apply=lpips_apply, **kwargs), _init(disc, seed), False


def _build_dofa(dofa_cfg: dict):
    """The ViT of a ``dofa_net`` block, frozen and loaded from its checkpoint, or
    None (with the JAX factory's message) when the term cannot be built: a
    frozen net at random init is of no use."""
    from eovax_torch.models import dofa as dofa_mod

    dofa_cfg = dict(dofa_cfg)
    target = dofa_cfg.pop("_target_", "eo_vae.models.dofa.dofav1_base_patch16_224")
    builder_name = target.rsplit(".", 1)[-1]
    builder = getattr(dofa_mod, builder_name, None)
    if builder is None:
        print(f"[losses.factory] unknown DOFA builder {builder_name!r} — term disabled")
        return None
    ckpt = dofa_cfg.pop("ckpt_data", None) or dofa_cfg.pop("weights_path", None)
    dofa_cfg.pop("model_bands", None)  # unused, as in the JAX factory
    if not (ckpt and os.path.exists(ckpt)):
        print(
            f"[losses.factory] DOFA checkpoint {ckpt!r} not found — "
            "perceptual/feature term disabled (supply a converted ckpt to enable)"
        )
        return None
    try:
        vit, _ = builder(weights_path=ckpt, **dofa_cfg)
    except NotImplementedError as e:
        print(f"[losses.factory] {e} — term disabled")
        return None
    return vit


def _build_lpips(lpips_cfg: dict):
    """``DOFALPIPS`` over the frozen ViT, its tap weights at their constant init."""
    from eovax_torch.models.dofa import DOFALPIPS

    lpips_cfg = dict(lpips_cfg)
    lpips_cfg.pop("_target_", None)
    vit = _build_dofa(lpips_cfg.pop("dofa_net", {}))
    if vit is None:
        return None
    return DOFALPIPS(vit).eval().requires_grad_(False)


def _build_dofa_features(dofa_cfg: dict):
    """The consistency loss's feature net: the frozen ViT's taps (v3's
    ``forward_lpips``)."""
    from eovax_torch.models.dofa import DOFAFeatures

    vit = _build_dofa(dofa_cfg)
    if vit is None:
        return None
    return DOFAFeatures(vit).eval().requires_grad_(False)
