"""Flux-derived VAE encoder/decoder backbone (NCHW torch modules).

Port of ``eovax/models/backbone.py``. The module tree carries the
reference's state-dict names (``down.0.block.1.conv1.weight``,
``mid.attn_1.q.weight``, ``up.3.upsample.conv.weight``, ``bn.running_mean``),
so a reference checkpoint loads with ``load_state_dict``.

Shipped architecture (configs/eo-vae.yaml): ch=128, ch_mult=(1,2,4,4),
num_res_blocks=2, z_channels=32 — three downsamples, a [B, 32, H/8, W/8]
latent and ~95.5M parameters. The mid-block attention runs over (H/8)·(W/8)
tokens of width ch·ch_mult[-1] = 512.

:meth:`EOVAECore.forward` takes the JAX module's training arguments: latent
BatchNorm batch statistics (``train``), latent noise, and ``remat`` of the
encoder's and decoder's level ResnetBlocks; :meth:`EOVAECore.forward_gan`
also returns the decoder's penultimate activation and the generated
output-stem kernel, which the adversarial loss's adaptive weight
differentiates against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.core.config import DecoderConfig, EncoderConfig, StemConfig
from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.nn.blocks import (
    AttnBlock,
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    Upsample,
    WavelengthConditioner,
)
from eovax_torch.nn.distributions import DiagonalGaussian
from eovax_torch.nn.dynamic_conv import DynamicConv, DynamicConvDecoder
from eovax_torch.nn.latent import LatentBatchNorm, patch_shuffle, patch_unshuffle


def _stem_kwargs(stem: StemConfig) -> dict:
    if stem.mode == "basis":
        raise NotImplementedError(
            "stem.mode='basis' (shared-basis stems, eovax/nn/dynamic_basis.py) is not "
            "ported yet: ROADMAP Queue 1 item 7 (model variants)"
        )
    return dict(
        wv_planes=stem.wv_planes,
        inter_dim=stem.inter_dim,
        kernel_size=stem.kernel_size,
        num_layers=stem.num_layers,
        num_heads=stem.num_heads,
        generator_type=stem.generator_type,
        rank_ratio=stem.rank_ratio,
    )


def _mid(block_in: int, cond_dim: int | None, policy: Policy) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(block_in, block_in, cond_dim, policy)
    mid.attn_1 = AttnBlock(block_in, policy)
    mid.block_2 = ResnetBlock(block_in, block_in, cond_dim, policy)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor, emb: torch.Tensor | None) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h, emb)), emb)


class Encoder(nn.Module):
    """Image → latent moments [B, 2·z_channels, H/8, W/8]."""

    def __init__(self, cfg: EncoderConfig, policy: Policy = FULL_PRECISION, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.use_adain = bool(cfg.use_dynamic_ops and cfg.stem and cfg.stem.use_adain)
        if cfg.use_dynamic_ops:
            self.conv_in = DynamicConv(embed_dim=cfg.ch, stride=1, padding=1, policy=policy,
                                       **_stem_kwargs(cfg.stem))
        else:
            self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1, policy=policy)
        if self.use_adain:
            self.conditioner = WavelengthConditioner(embed_dim=512)
        cond_dim = 512 if self.use_adain else None

        in_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            block_in, block_out = cfg.ch * in_mult[i], cfg.ch * mult
            stage = nn.Module()
            stage.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                stage.block.append(ResnetBlock(block_in, block_out, cond_dim, policy, remat))
                block_in = block_out
            if i != len(cfg.ch_mult) - 1:
                stage.downsample = Downsample(block_in, policy)
            self.down.append(stage)

        self.mid = _mid(block_in, cond_dim, policy)
        self.norm_out = GroupNorm(block_in, policy)
        self.conv_out = Conv2d(block_in, 2 * cfg.z_channels, 3, padding=1, policy=policy)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.z_channels, 1, policy=policy)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor | None = None) -> torch.Tensor:
        emb = None
        if self.cfg.use_dynamic_ops:
            if wvs is None:
                raise ValueError("wvs must be provided for a dynamic encoder")
            h = self.conv_in(x, wvs)
            if self.use_adain:
                emb = self.conditioner(wvs)
        else:
            h = self.conv_in(x)
        for stage in self.down:
            for block in stage.block:
                h = block(h, emb)
            if hasattr(stage, "downsample"):
                h = stage.downsample(h)
        h = _run_mid(self.mid, h, emb)
        h = self.norm_out(h, swish=True)
        return self.quant_conv(self.conv_out(h))


class Decoder(nn.Module):
    """Latent [B, z_channels, H/8, W/8] → image."""

    def __init__(self, cfg: DecoderConfig, policy: Policy = FULL_PRECISION, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.use_adain = bool(cfg.use_dynamic_ops and cfg.stem and cfg.stem.use_adain)
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.post_quant_conv = Conv2d(cfg.z_channels, cfg.z_channels, 1, policy=policy)
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1, policy=policy)
        if self.use_adain:
            self.conditioner = WavelengthConditioner(embed_dim=512)
        cond_dim = 512 if self.use_adain else None
        self.mid = _mid(block_in, cond_dim, policy)

        # Built top-down, as the reference does, so the channel chain matches.
        stages: list[nn.Module] = [None] * num_res
        for i in reversed(range(num_res)):
            block_out = cfg.ch * cfg.ch_mult[i]
            stage = nn.Module()
            stage.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                stage.block.append(ResnetBlock(block_in, block_out, cond_dim, policy, remat))
                block_in = block_out
            if i != 0:
                stage.upsample = Upsample(block_in, policy)
            stages[i] = stage
        self.up = nn.ModuleList(stages)

        self.norm_out = GroupNorm(block_in, policy)
        if cfg.use_dynamic_ops:
            self.conv_out = DynamicConvDecoder(embed_dim=block_in, stride=1, padding=1,
                                               policy=policy, **_stem_kwargs(cfg.stem))
        else:
            self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1, policy=policy)

    def penultimate(self, z: torch.Tensor, wvs: torch.Tensor | None = None) -> torch.Tensor:
        """Everything up to and including norm_out + swish: the activation
        the output stem convolves."""
        h = self.conv_in(self.post_quant_conv(z))
        emb = None
        if self.use_adain:
            if wvs is None:
                raise ValueError("wvs must be provided for an AdaIN decoder")
            emb = self.conditioner(wvs)
        h = _run_mid(self.mid, h, emb)
        for stage in reversed(self.up):
            for block in stage.block:
                h = block(h, emb)
            if hasattr(stage, "upsample"):
                h = stage.upsample(h)
        return self.norm_out(h, swish=True)

    def forward(self, z: torch.Tensor, wvs: torch.Tensor | None = None) -> torch.Tensor:
        h = self.penultimate(z, wvs)
        if self.cfg.use_dynamic_ops:
            if wvs is None:
                raise ValueError("wvs must be provided for a dynamic decoder")
            return self.conv_out(h, wvs)
        return self.conv_out(h)

    def generate_output_kernel(self, wvs: torch.Tensor):
        """The generated output-stem (weight [N, E, K, K], bias [N])."""
        if not self.cfg.use_dynamic_ops:
            raise ValueError("generate_output_kernel needs a dynamic decoder")
        return self.conv_out.generate(wvs)


class EOVAECore(nn.Module):
    """Full VAE: encoder, 2×2 patch shuffle, latent BatchNorm, decoder.

    ``remat`` recomputes the encoder's and decoder's level ResnetBlocks in the
    backward (the mid blocks are kept, as in the JAX module)."""

    def __init__(self, encoder_cfg: EncoderConfig, decoder_cfg: DecoderConfig,
                 policy: Policy = FULL_PRECISION, ps: tuple[int, int] = (2, 2),
                 remat: bool = False):
        super().__init__()
        self.policy = policy
        self.ps = ps
        self.encoder = Encoder(encoder_cfg, policy, remat)
        self.decoder = Decoder(decoder_cfg, policy, remat)
        self.bn = LatentBatchNorm(ps[0] * ps[1] * encoder_cfg.z_channels)

    # --- primitives -----------------------------------------------------------

    def encode(self, x: torch.Tensor, wvs: torch.Tensor) -> DiagonalGaussian:
        """Image → posterior over the raw (unshuffled) latent."""
        return DiagonalGaussian.from_moments(self.encoder(x, wvs).float())

    def decode(self, z: torch.Tensor, wvs: torch.Tensor,
               bn_stats: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
        """Normalized packed latent [B, 4z, H/16, W/16] → image (de-normalized
        with the running statistics, or with ``bn_stats``)."""
        return self.decoder(patch_unshuffle(self.bn.inverse(z, bn_stats), self.ps), wvs)

    def decode_raw(self, z: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        """Raw (unshuffled, unnormalized) latent → image."""
        return self.decoder(z, wvs)

    def normalize_latent(self, z_shuffled: torch.Tensor, *, train: bool) -> torch.Tensor:
        return self.bn(z_shuffled, use_running_average=not train)

    # --- composite passes -----------------------------------------------------

    def forward(self, x: torch.Tensor, wvs: torch.Tensor, *,
                generator: torch.Generator | None = None, sample_posterior: bool = True,
                scale: float | tuple[float, float] | None = None,
                angle: int | None = None, train: bool = False, latent_noise_p: float = 0.0,
                noise_tau: float = 0.8) -> tuple[torch.Tensor, DiagonalGaussian]:
        """Encode → (EQ-VAE scale / rotation) → shuffle → BN → (latent noise) → decode.

        ``train`` normalizes the latent with its batch statistics, updates the
        running ones and de-normalizes with the updated ones. In train mode
        with ``latent_noise_p`` > 0, the whole batch's latent gets, with
        probability ``latent_noise_p``, Gaussian noise of a per-sample σ drawn
        uniform in [0, ``noise_tau``). Every draw comes from ``generator``.
        """
        z, bn_stats, posterior = self._latent(x, wvs, generator, sample_posterior, scale, angle,
                                              train, latent_noise_p, noise_tau)
        return self.decode(z, wvs, bn_stats), posterior

    def forward_gan(self, x: torch.Tensor, wvs: torch.Tensor, *,
                    generator: torch.Generator | None = None, sample_posterior: bool = True,
                    scale: float | tuple[float, float] | None = None,
                    angle: int | None = None, train: bool = False, latent_noise_p: float = 0.0,
                    noise_tau: float = 0.8):
        """:meth:`forward` that also returns the decoder's penultimate activation
        and the output stem it convolves: ``(recon, posterior, h_pre, kernel,
        bias)`` with recon = conv(h_pre, kernel) + bias. ``kernel`` [N, E, K, K]
        is the generated (non-leaf) output-stem kernel; a static decoder returns
        None for ``kernel`` and ``bias``, and the caller reads ``conv_out``'s
        parameters."""
        z, bn_stats, posterior = self._latent(x, wvs, generator, sample_posterior, scale, angle,
                                              train, latent_noise_p, noise_tau)
        h_pre = self.decoder.penultimate(
            patch_unshuffle(self.bn.inverse(z, bn_stats), self.ps), wvs)
        conv_out = self.decoder.conv_out
        if not self.decoder.cfg.use_dynamic_ops:
            return conv_out(h_pre), posterior, h_pre, None, None
        kernel, bias = conv_out.generate(wvs)
        return conv_out._conv(h_pre, kernel, bias), posterior, h_pre, kernel, bias

    def _latent(self, x, wvs, generator, sample_posterior, scale, angle, train, latent_noise_p,
                noise_tau):
        """The normalized packed latent of a training or eval pass, the statistics
        that de-normalize it (None: the running ones) and the posterior.

        ``train`` normalizes the latent with its batch statistics, updates the
        running ones and returns the updated ones, with their gradient."""
        posterior = self.encode(x, wvs)
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        if scale is not None:
            z = self._apply_scale(z, scale)
        if angle is not None:
            z = torch.rot90(z, k=angle, dims=(3, 2))  # the JAX package's NHWC axes (2, 1)
        z, bn_stats = patch_shuffle(z, self.ps), None
        if train:
            z, bn_stats = self.bn.normalize_batch(z)
        else:
            z = self.bn(z, use_running_average=True)
        if train and latent_noise_p > 0.0:
            z = self._latent_noise(z, latent_noise_p, noise_tau, generator)
        return z, bn_stats, posterior

    def encode_to_latent(self, x: torch.Tensor, wvs: torch.Tensor, *,
                         train: bool = False) -> torch.Tensor:
        """Image → normalized packed latent [B, 4z, H/16, W/16] (posterior mode)."""
        z = self.encode(x, wvs).mode()
        return self.normalize_latent(patch_shuffle(z, self.ps), train=train)

    def encode_spatial_normalized(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        """Image → normalized latent in spatial layout [B, z, H/8, W/8]."""
        return patch_unshuffle(self.encode_to_latent(x, wvs), self.ps)

    def decode_spatial_normalized(self, z: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        """Spatial normalized latent → image."""
        return self.decode(patch_shuffle(z, self.ps), wvs)

    def reconstruct(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        recon, _ = self.forward(x, wvs, sample_posterior=False)
        return recon

    # --- helpers --------------------------------------------------------------

    @staticmethod
    def _latent_noise(z: torch.Tensor, p: float, tau: float,
                      generator: torch.Generator | None) -> torch.Tensor:
        draw = dict(generator=generator, device=z.device)
        gate = torch.rand((), **draw) < p
        sigma = tau * torch.rand((z.shape[0], 1, 1, 1), **draw)
        noise = sigma * torch.randn(z.shape, **draw)
        return torch.where(gate, z + noise.to(z.dtype), z)

    def _apply_scale(self, z: torch.Tensor, scale) -> torch.Tensor:
        """Bilinear latent rescale snapped to patch multiples (half-pixel
        centres, no antialiasing)."""
        _, _, h, w = z.shape
        sh, sw = scale if isinstance(scale, (tuple, list)) else (scale, scale)
        new_h = round(h * sh / self.ps[0]) * self.ps[0]
        new_w = round(w * sw / self.ps[1]) * self.ps[1]
        return F.interpolate(z, size=(new_h, new_w), mode="bilinear", align_corners=False,
                             antialias=False)

    def generate_output_kernel(self, wvs: torch.Tensor):
        return self.decoder.generate_output_kernel(wvs)
