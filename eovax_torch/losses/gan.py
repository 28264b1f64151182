"""Adversarial losses and discriminators (NCHW).

Port of ``eovax/losses/gan.py``:

- the hinge / vanilla objectives;
- ``DynamicPatchGAN``, a PatchGAN whose 4×4 convs are spectral-normalised
  with flax's ``nn.SpectralNorm`` semantics, over an owned wavelength-dynamic
  input stem;
- ``NLayerDiscriminator``, the Pix2Pix PatchGAN with a dynamic input stem;
- ``adaptive_weight``, the reference's ``calculate_adaptive_weight`` over the
  decoder's *generated* output-stem kernel;
- ``EOPatchLoss`` (L1 + MS-SSIM + hinge GAN) and ``EOGenerativeLoss``
  (L1 + FFL + perceptual + vanilla GAN).

The losses are stateless: each call is handed the discriminator module, as
the JAX package's are handed its variables. The discriminators' convs are
``F.conv2d`` in the compute dtype; their instance norms run in fp32.

Where JAX re-expresses the reconstruction as a closure over the kernel and
takes ``jax.grad``, the port takes ``torch.autograd.grad`` of the loss's own
terms with respect to the non-leaf kernel, the reference's form: the terms
are the ones in the loss, and no part of the generator runs again.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.losses.ffl import focal_frequency_loss
from eovax_torch.losses.msssim import msssim_loss
from eovax_torch.nn.dynamic_conv import DynamicConv
from eovax_torch.parallel.mesh import average_gradients

# ---------------------------------------------------------------------------
# Basic GAN objectives
# ---------------------------------------------------------------------------


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def vanilla_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return F.softplus(-logits_fake).mean()


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """flax's ``_l2_normalize``: x · rsqrt(Σx² + eps)."""
    return x * torch.rsqrt((x * x).sum() + eps)


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """flax ``GroupNorm`` with a group per channel, eps 1e-5, no affine, in fp32
    with its fast variance E[x²] − E[x]² (clipped at 0); cast back to x's dtype."""
    h = x.float()
    mean = h.mean((2, 3), keepdim=True)
    var = ((h * h).mean((2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    return ((h - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


class Conv4x4(nn.Conv2d):
    """4×4 conv, padding 1, input, kernel and bias cast to the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, bias: bool,
                 policy: Policy = FULL_PRECISION):
        super().__init__(in_channels, out_channels, 4, stride=stride, padding=1, bias=bias)
        self.policy = policy

    def _conv(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        bias = None if self.bias is None else c(self.bias)
        return F.conv2d(c(x), c(kernel), bias, self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.weight)


class SpectralNormConv4x4(Conv4x4):
    """``Conv4x4`` under flax's ``nn.SpectralNorm`` (one power-iteration step,
    eps 1e-12).

    The kernel, as the matrix W of its HWIO flattening (H·W·I, O), is divided by
    σ = v W u'ᵀ, where every forward runs one step from the stored ``u`` (1, O):
    v = l2n(u Wᵀ), u' = l2n(v W), both without gradient; the gradient reaches W
    through σ too. ``u`` and ``sigma`` (buffers) take u' and σ only when the
    stats are updated (:meth:`update_stats`).
    σ is fp32, the parameters' dtype, whatever the compute dtype; the bias is
    not normalised. ``torch.nn.utils.spectral_norm`` differs: it updates ``u``
    on every train-mode forward and normalises with x / max(‖x‖, eps).
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int, bias: bool,
                 policy: Policy = FULL_PRECISION):
        super().__init__(in_channels, out_channels, stride, bias, policy)
        self.register_buffer("u", torch.randn(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.u.normal_(generator=generator)  # flax draws u from N(0, 1)
        self.sigma.fill_(1.0)

    def normalized_kernel(self, update_stats: bool = False) -> torch.Tensor:
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.out_channels)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T)
            u = _l2_normalize(v @ w)
        sigma = (v @ w @ u.T)[0, 0]
        if update_stats:
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    @torch.no_grad()
    def update_stats(self) -> None:
        self.normalized_kernel(update_stats=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.normalized_kernel())


class DynamicPatchGAN(nn.Module):
    """Spectral-norm PatchGAN over a wavelength-dynamic input stem.

    The reference injects the VAE encoder's ``conv_in`` as the input stem; here
    the stem is an owned ``DynamicConv`` with the same hyperparameters, which
    ``Stage2Trainer(seed_disc_stem=True)`` seeds from the encoder's. Logits
    [B, 1, h, w]. The stem runs without dropout, as the JAX package applies the
    discriminator without a dropout RNG: keep the module in eval mode.
    """

    def __init__(self, ndf: int = 128, n_layers: int = 3, wv_planes: int = 128,
                 stem_num_layers: int = 1, stem_num_heads: int = 4,
                 stem_generator_type: str = "transformer", stem_rank_ratio: int = 4,
                 policy: Policy = FULL_PRECISION):
        super().__init__()
        self.ndf, self.n_layers, self.wv_planes = ndf, n_layers, wv_planes
        self.stem_num_layers, self.stem_num_heads = stem_num_layers, stem_num_heads
        self.stem_generator_type, self.stem_rank_ratio = stem_generator_type, stem_rank_ratio
        self.policy = policy
        self.dynamic_input = DynamicConv(
            wv_planes=wv_planes, embed_dim=ndf, num_layers=stem_num_layers,
            num_heads=stem_num_heads, generator_type=stem_generator_type,
            rank_ratio=stem_rank_ratio, policy=policy)
        self.block_0 = SpectralNormConv4x4(ndf, ndf, 2, True, policy)
        curr = ndf
        for i in range(1, n_layers):
            nxt = min(ndf * 2**i, 512)
            setattr(self, f"block_{i}", SpectralNormConv4x4(curr, nxt, 2, False, policy))
            curr = nxt
        self.final = SpectralNormConv4x4(curr, 1, 1, True, policy)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.block_0(self.dynamic_input(x, wvs)), 0.2)
        for i in range(1, self.n_layers):
            h = F.leaky_relu(_instance_norm(getattr(self, f"block_{i}")(h)), 0.2)
        return self.final(h)

    def update_spectral_stats(self) -> None:
        """Store every layer's power-iteration step: what the JAX discriminator
        step's forward with ``update_sn=True`` stores. That forward's output is
        discarded and the step depends on neither x nor the output, so no
        forward runs here."""
        for m in self.modules():
            if isinstance(m, SpectralNormConv4x4):
                m.update_stats()


class NLayerDiscriminator(nn.Module):
    """Pix2Pix PatchGAN (4×4 kernels) with a ``DynamicConv`` input stem that maps
    any band count to ``input_nc``. Logits [B, 1, h, w]; keep in eval mode."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 policy: Policy = FULL_PRECISION):
        super().__init__()
        self.input_nc, self.ndf, self.n_layers, self.policy = input_nc, ndf, n_layers, policy
        self.conv_in = DynamicConv(wv_planes=128, embed_dim=input_nc, num_layers=1,
                                   policy=policy)
        self.layer_0 = Conv4x4(input_nc, ndf, 2, True, policy)
        prev = 1
        for n in range(1, n_layers):
            nf = min(2**n, 8)
            setattr(self, f"layer_{n}", Conv4x4(ndf * prev, ndf * nf, 2, False, policy))
            prev = nf
        nf = min(2**n_layers, 8)
        setattr(self, f"layer_{n_layers}", Conv4x4(ndf * prev, ndf * nf, 1, False, policy))
        self.final = Conv4x4(ndf * nf, 1, 1, True, policy)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.layer_0(self.conv_in(x, wvs)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(_instance_norm(getattr(self, f"layer_{n}")(h)), 0.2)
        return self.final(h)


# ---------------------------------------------------------------------------
# Adaptive weighting
# ---------------------------------------------------------------------------


def adaptive_weight(rec_loss: torch.Tensor, g_loss: torch.Tensor, kernel: torch.Tensor, *,
                    eps: float = 1e-4, max_weight: float = 2.0) -> torch.Tensor:
    """‖∂rec/∂kernel‖ / (‖∂gan/∂kernel‖ + eps), clamped to [0, max_weight] and
    detached: the reference's ``calculate_adaptive_weight`` over the generated
    output kernel. The graph is kept for the loss's backward. Under a process
    group both gradients are averaged over the ranks before their norms: the
    JAX package differentiates the global batch's mean loss."""
    rec_g, = torch.autograd.grad(rec_loss, kernel, retain_graph=True)
    gan_g, = torch.autograd.grad(g_loss, kernel, retain_graph=True)
    average_gradients([rec_g, gan_g])
    w = torch.linalg.vector_norm(rec_g) / (torch.linalg.vector_norm(gan_g) + eps)
    return w.clamp(0.0, max_weight).detach()


def robust_normalize(x: torch.Tensor, clip_val: float = 3.0) -> torch.Tensor:
    """Clamp to ±clip, then map to [-1, 1]."""
    return x.clamp(-clip_val, clip_val) / clip_val


def _l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def _logs(split: str, **terms: torch.Tensor) -> dict[str, torch.Tensor]:
    return {f"{split}/{k}": v.detach() for k, v in terms.items()}


# ---------------------------------------------------------------------------
# Composite adversarial losses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EOPatchLoss:
    """L1 + MS-SSIM + hinge GAN with the adaptive weight.

    ``generator_loss(disc, inputs, wvs, reconstructions, global_step=, kernel=,
    split=)``: ``kernel``, the generated output-stem kernel that
    ``reconstructions`` was computed with, turns on the adaptive weight (the
    train step); without it the weight is 1 (validation).
    """

    disc_start: int = 10000
    disc_weight: float = 0.5
    ssim_weight: float = 0.2

    def generator_loss(self, disc: nn.Module, inputs: torch.Tensor, wvs: torch.Tensor,
                       reconstructions: torch.Tensor, *, global_step: int,
                       kernel: torch.Tensor | None = None, split: str = "train"):
        recon = reconstructions.clamp(-2.5, 5.0)
        rec_loss = _l1(recon, inputs)
        ssim = (msssim_loss(recon, inputs) if self.ssim_weight > 0
                else torch.zeros((), device=recon.device))
        use_gan = float(global_step >= self.disc_start)
        logits_fake = disc(recon, wvs).float()
        g_loss = -logits_fake.mean()
        weight = torch.ones((), device=recon.device)
        if kernel is not None:
            weight = adaptive_weight(rec_loss, g_loss, kernel, eps=1e-4, max_weight=2.0)
        g_term = use_gan * weight * g_loss
        total = rec_loss + self.disc_weight * g_term + self.ssim_weight * ssim
        return total, _logs(split, loss_rec=rec_loss, loss_g=g_term,
                            disc_weight=use_gan * weight, loss_msssim=ssim,
                            logits_fake_g=use_gan * logits_fake.mean())

    def discriminator_loss(self, disc: nn.Module, inputs: torch.Tensor, wvs: torch.Tensor,
                           reconstructions: torch.Tensor, *, split: str = "train"):
        recon = reconstructions.detach().clamp(-2.5, 5.0)
        logits_real = disc(inputs.detach(), wvs).float()
        logits_fake = disc(recon, wvs).float()
        d_loss = hinge_d_loss(logits_real, logits_fake)
        return d_loss, _logs(split, loss_disc=d_loss, logits_real=logits_real.mean(),
                             logits_fake_d=logits_fake.mean())


@dataclasses.dataclass(frozen=True)
class EOGenerativeLoss:
    """L1 + optional FFL + optional perceptual term + vanilla GAN.

    ``lpips_apply(inputs, recon, wvs) → scalar`` is the perceptual term: the
    factory's is a frozen ``DOFALPIPS`` (fp32), through which the gradient
    reaches the reconstruction, in the adaptive weight and in the step's
    backward alike. The generator branch scores ``robust_normalize(recon)``,
    while the discriminator branch feeds the raw detached reconstruction and
    inputs: the reference's asymmetry, kept.
    """

    lpips_apply: Callable[..., torch.Tensor] | None = None
    perceptual_weight: float = 1.0
    disc_weight: float = 0.75
    gan_start_step: int = 0
    disc_update_start_step: int = 0
    max_d_weight: float = 1e4
    disc_loss_type: str = "hinge"
    focal_loss_weight: float = 0.0
    focal_loss_alpha: float = 0.0

    def generator_loss(self, disc: nn.Module, inputs: torch.Tensor, wvs: torch.Tensor,
                       reconstructions: torch.Tensor, *, global_step: int,
                       kernel: torch.Tensor | None = None, split: str = "train"):
        # The adaptive weight differentiates this whole reconstruction loss,
        # L1 + FFL + the weighted perceptual term, as the reference does.
        rec_loss = _l1(reconstructions, inputs)
        if self.focal_loss_weight > 0.0:
            rec_loss = rec_loss + focal_frequency_loss(
                reconstructions, inputs, loss_weight=self.focal_loss_weight,
                alpha=self.focal_loss_alpha)
        p_loss = torch.zeros((), device=reconstructions.device)
        if self.perceptual_weight > 0.0 and self.lpips_apply is not None:
            p_loss = self.lpips_apply(inputs, reconstructions, wvs)
            rec_loss = rec_loss + self.perceptual_weight * p_loss
        use_gan = float(global_step >= self.gan_start_step) * float(self.disc_weight > 0.0)
        g_loss = vanilla_g_loss(disc(robust_normalize(reconstructions), wvs).float())
        d_weight = torch.ones((), device=reconstructions.device)
        if kernel is not None:
            d_weight = adaptive_weight(rec_loss, g_loss, kernel, eps=1e-6,
                                       max_weight=self.max_d_weight)
        total = rec_loss + use_gan * d_weight * self.disc_weight * g_loss
        return total, _logs(split, loss_total=total, loss_rec=rec_loss, loss_lpips=p_loss,
                            loss_gan=use_gan * g_loss, d_weight=use_gan * d_weight)

    def discriminator_loss(self, disc: nn.Module, inputs: torch.Tensor, wvs: torch.Tensor,
                           reconstructions: torch.Tensor, *, split: str = "train"):
        fn = hinge_d_loss if self.disc_loss_type == "hinge" else vanilla_d_loss
        logits_fake = disc(reconstructions.detach(), wvs).float()
        logits_real = disc(inputs.detach(), wvs).float()
        d_loss = fn(logits_real, logits_fake)
        return d_loss, _logs(split, loss_disc=d_loss, logits_real=logits_real.mean(),
                             logits_fake=logits_fake.mean())
