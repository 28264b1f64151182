"""DOFA: the wavelength-conditioned ViT feature extractors (frozen), NCHW.

Port of ``eovax/models/dofa.py``. A ViT whose patch embedding is generated per
band by the same transformer hypernetwork as the VAE stems, so one frozen
backbone extracts features from any sensor. It feeds the perceptual term of
``EOGenerativeLoss`` (:class:`DOFALPIPS`), the feature term of
``EOConsistencyLoss`` and the feature-space :class:`DOFADiscriminator`.

Three families: :class:`OFAViT` (DOFA v1: fixed sin/cos position embedding),
:class:`DOFAViTv2` (timm-style: patch 14, learned position embedding resampled
to the token grid, LayerScale) and :class:`DOFAViTv3` (DINOv3-style: cls and
register tokens, 2-D rotary embedding on the patch tokens, LayerScale).

DOFA runs in fp32 whatever the VAE's policy, as the JAX package's does: its
input (a bf16 reconstruction under the bf16 policy) is cast to fp32 in the
patch embed, and its matmuls and convolution run with TF32 off
(``Policy.activate``, which every ``EOFluxVAE`` calls). The attention is written as the JAX package's einsums
in tensor ops (fp32 logits scaled by 1/√hd, softmax, probabilities times V).

The submodules carry the reference torch models' names (``blocks.N.attn.qkv``,
``blocks.N.mlp.fc1``, ``blocks.N.ls1.gamma``, ``patch_embed.fclayer.w1``), so a
reference checkpoint loads by key: the builders take a local ``.pth`` /
``.pt`` file and load exactly the keys that the JAX package's converter
converts, reporting the others as unexpected (:func:`_maybe_load`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.data.wavelengths import BAND_WAVELENGTHS, WAVELENGTHS
from eovax_torch.models.eo_flux_vae import read_checkpoint
from eovax_torch.nn.dynamic_conv import (
    FCResLayer,
    TransformerWeightGenerator,
    sincos_wavelength_embed,
)
from eovax_torch.nn.init import init_parameters
from eovax_torch.utils.resize import resize_nhwc


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = True) -> np.ndarray:
    """MAE-style fixed 2D sin/cos position embedding [1, N(+1), D]."""

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000.0**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w first (MAE convention)
    grid = np.stack(grid, axis=0).reshape(2, -1)
    emb = np.concatenate([_1d(embed_dim // 2, grid[0]), _1d(embed_dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb[None].astype(np.float32)


class DynamicPatchEmbed(nn.Module):
    """The hypernetwork-generated patch-embed conv (kernel = stride = patch,
    padding 1: the reference's odd padding, so 224² at patch 14 gives a 16×16
    grid) → tokens [B, N, E], and the wavelength features.

    ``convert_patch_14_to_16`` resizes the generated 14×14 kernels to 16×16
    (bicubic, a = −0.75) and strides by 16.
    """

    SCALER = 0.1

    def __init__(self, wv_planes: int = 128, embed_dim: int = 1024, kernel_size: int = 16,
                 convert_patch_14_to_16: bool = False):
        super().__init__()
        if convert_patch_14_to_16 and kernel_size != 14:
            raise ValueError(f"convert_patch_14_to_16 needs kernel_size 14, got {kernel_size}")
        self.wv_planes, self.embed_dim, self.kernel_size = wv_planes, embed_dim, kernel_size
        self.convert_patch_14_to_16 = convert_patch_14_to_16
        self.weight_generator = TransformerWeightGenerator(
            input_dim=wv_planes, output_dim=kernel_size * kernel_size * embed_dim,
            embed_dim=embed_dim, variant="encoder")
        self.fclayer = FCResLayer(wv_planes)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        # The hypernetwork's reference init: xavier-uniform Linears with bias
        # 0.01, tokens N(0, 0.02).
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.fill_(0.01)
        self.weight_generator.weight_tokens.normal_(0.0, 0.02, generator=generator)
        self.weight_generator.bias_token.normal_(0.0, 0.02, generator=generator)

    def generate(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(kernel [E, N, k, k] ·0.1, bias [E] ·0.1, wavelength features [N, wv_planes])."""
        waves = self.fclayer(sincos_wavelength_embed(self.wv_planes, wvs.float() * 1000.0))
        weight, bias = self.weight_generator(waves)
        n, k, e = wvs.shape[0], self.kernel_size, self.embed_dim
        kernel = weight.reshape(n, k, k, e).permute(1, 2, 0, 3) * self.SCALER  # HWIO
        if self.convert_patch_14_to_16:
            kernel = resize_nhwc(kernel.reshape(1, k, k, n * e), (16, 16), mode="bicubic")
            kernel = kernel.reshape(16, 16, n, e)
        return kernel.permute(3, 2, 0, 1), bias.reshape(e) * self.SCALER, waves

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        kernel, bias, waves = self.generate(wvs)
        stride = kernel.shape[-1]
        y = F.conv2d(x.float(), kernel, stride=stride, padding=1) + bias[:, None, None]
        return y.flatten(2).transpose(1, 2), waves


class LayerScale(nn.Module):
    """timm LayerScale: a per-channel learnable branch gain (init 1e-5)."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), init_values))

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.gamma.fill_(self.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


def _rope_2d(grid_h: int, grid_w: int, head_dim: int, theta: float = 100.0,
             coords: str = "box", device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Axial 2D rotary embedding over the patch grid: half the rotary dims
    encode y, half x. Returns (cos, sin) [H·W, head_dim] in the rotate-half
    layout. ``coords`` "box": pixel-centre coordinates in [-1, 1] per axis
    (DINOv3's RoPE-box); "grid": the integer patch indices."""
    quarter = head_dim // 4
    f32 = dict(dtype=torch.float32, device=device)
    freqs = theta ** (-torch.arange(quarter, **f32) / max(quarter, 1))
    if coords == "box":
        ys = (torch.arange(grid_h, **f32) + 0.5) / grid_h * 2.0 - 1.0
        xs = (torch.arange(grid_w, **f32) + 0.5) / grid_w * 2.0 - 1.0
    elif coords == "grid":
        ys = torch.arange(grid_h, **f32)
        xs = torch.arange(grid_w, **f32)
    else:
        raise ValueError(f"rope coords must be 'box' or 'grid', got {coords!r}")
    ang_y = (ys[:, None] * freqs[None])[:, None, :].expand(grid_h, grid_w, quarter)
    ang_x = (xs[:, None] * freqs[None])[None, :, :].expand(grid_h, grid_w, quarter)
    ang = torch.cat([ang_y, ang_x], dim=-1).reshape(grid_h * grid_w, -1)
    ang = torch.cat([ang, ang], dim=-1)  # rotate-half pairs
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor],
                num_prefix: int) -> torch.Tensor:
    """Rotate the patch tokens of q or k [B, H, S, hd]; the ``num_prefix``
    leading tokens (cls and registers) pass unrotated."""
    cos, sin = rope
    prefix, tokens = x[..., :num_prefix, :], x[..., num_prefix:, :]
    t1, t2 = tokens.chunk(2, dim=-1)
    rotated = torch.cat([-t2, t1], dim=-1)
    return torch.cat([prefix, tokens * cos + rotated * sin], dim=-2)


class Attention(nn.Module):
    """Multi-head self-attention with a packed ``qkv`` projection and ``proj``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        # 1/√hd as the JAX package computes it: both steps rounded to fp32.
        self.scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))

    def forward(self, x: torch.Tensor, rope=None, num_prefix: int = 1) -> torch.Tensor:
        b, s, d = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each [B, H, S, hd]
        if rope is not None:
            q, k = _apply_rope(q, rope, num_prefix), _apply_rope(k, rope, num_prefix)
        logits = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        attn = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.proj(attn.transpose(1, 2).reshape(b, s, d))


class Mlp(nn.Module):
    """fc1 → exact (erf) GELU → fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class ViTBlock(nn.Module):
    """Pre-norm ViT block (timm ``Block``: LayerNorm eps 1e-6, qkv bias, GELU
    MLP), with optional LayerScale (``init_values``: ``ls1``/``ls2``) and rotary
    embedding on q/k past the ``num_prefix`` leading tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float | None = None, num_prefix: int = 1):
        super().__init__()
        self.num_prefix = num_prefix
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls1 = self.ls2 = None
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        h = self.attn(self.norm1(x), rope, self.num_prefix)
        x = x + (h if self.ls1 is None else self.ls1(h))
        h = self.mlp(self.norm2(x))
        return x + (h if self.ls2 is None else self.ls2(h))


def _taps(blocks, h: torch.Tensor, out_indices, rope=None, drop: int = 0) -> list[torch.Tensor]:
    """Run ``blocks`` and collect the output of each block whose index is in
    ``out_indices``, without its first ``drop`` tokens."""
    feats = []
    for i, blk in enumerate(blocks):
        h = blk(h, rope)
        if i in out_indices:
            feats.append(h[:, drop:, :])
    return feats


class OFAViT(nn.Module):
    """DOFA v1: dynamic patch embed → fixed sin/cos position embedding → cls
    token → blocks, the outputs of ``out_indices`` tapped with the cls token.

    ``pos_embed`` is a constant (a non-persistent buffer): a checkpoint's
    ``pos_embed`` is not loaded, as the JAX package's converter does not."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16, wv_planes: int = 128,
                 mlp_ratio: float = 4.0, out_indices: tuple[int, ...] = (5, 11, 17, 22)):
        super().__init__()
        self.img_size, self.embed_dim, self.depth = img_size, embed_dim, depth
        self.out_indices = tuple(out_indices)
        self.patch_embed = DynamicPatchEmbed(wv_planes, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, img_size // patch_size)), persistent=False)
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))

    @property
    def num_taps(self) -> int:
        return sum(i in self.out_indices for i in range(len(self.blocks)))

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()

    def forward_features(self, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
        tokens, _ = self.patch_embed(x, wvs)
        pos = self.pos_embed
        tokens = tokens + pos[:, 1:, :]
        cls = (self.cls_token + pos[:, :1, :]).expand(tokens.shape[0], -1, -1)
        return _taps(self.blocks, torch.cat([cls, tokens], dim=1), self.out_indices)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
        return self.forward_features(x, wvs)


def dofa_vit_base_patch16(**kwargs) -> OFAViT:
    kwargs.setdefault("out_indices", (4, 6, 10, 11))
    return OFAViT(embed_dim=768, depth=12, num_heads=12, **kwargs)


def dofa_vit_large_patch16(**kwargs) -> OFAViT:
    kwargs.setdefault("out_indices", (5, 11, 17, 22))
    return OFAViT(embed_dim=1024, depth=24, num_heads=16, **kwargs)


def _resample_pos_embed(pos: torch.Tensor, num_patches: int) -> torch.Tensor:
    """[1, 1+N0, D] → [1, 1+N, D]: the grid part resized bicubic (a = −0.75,
    timm's ``resample_abs_pos_embed`` without its downscale antialias), the
    cls slot untouched."""
    n0 = pos.shape[1] - 1
    if n0 == num_patches:
        return pos
    g0, g1 = int(np.sqrt(n0)), int(np.sqrt(num_patches))
    grid = resize_nhwc(pos[:, 1:, :].float().reshape(1, g0, g0, pos.shape[-1]), (g1, g1),
                       mode="bicubic")
    return torch.cat([pos[:, :1, :], grid.reshape(1, g1 * g1, -1).to(pos.dtype)], dim=1)


class DOFAViTv2(nn.Module):
    """DOFA v2 (timm-VisionTransformer-based): dynamic patch-14 embed
    (optionally resized to 16), a learned position embedding with the cls slot,
    resampled when the token grid differs from ``img_size // patch``;
    LayerScale(1e-5) blocks; taps with the cls token."""

    def __init__(self, img_size: int = 224, patch_size: int = 14, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 wv_planes: int = 128, out_indices: tuple[int, ...] = (4, 6, 10, 11),
                 convert_patch_14_to_16: bool = False):
        super().__init__()
        self.img_size, self.embed_dim, self.depth = img_size, embed_dim, depth
        self.out_indices = tuple(out_indices)
        self.patch_embed = DynamicPatchEmbed(wv_planes, embed_dim, patch_size,
                                             convert_patch_14_to_16)
        eff_patch = 16 if convert_patch_14_to_16 else patch_size
        num_patches = (img_size // eff_patch) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, mlp_ratio, init_values=1e-5)
                                    for _ in range(depth))

    num_taps = OFAViT.num_taps

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(0.0, 1e-6, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward_features(self, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
        tokens, _ = self.patch_embed(x, wvs)
        pos = _resample_pos_embed(self.pos_embed, tokens.shape[1])
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        return _taps(self.blocks, torch.cat([cls, tokens], dim=1) + pos, self.out_indices)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
        return self.forward_features(x, wvs)


class DOFAViTv3(nn.Module):
    """DOFA v3 (DINOv3-based): dynamic patch-16 embed in fp32, cls + register
    tokens, rotary embedding (``rope_coords`` "box" or "grid") on the q/k of the
    patch tokens, LayerScale blocks.

    Both forwards run every block but the last, as the reference's
    ``blocks[:-1]`` does, so the module holds ``depth − 1`` blocks: the last
    one's weights are never created (as in the JAX package), and a checkpoint's
    keys for it are unexpected. ``forward_features`` returns block
    ``depth − 2``'s patch tokens; ``forward_lpips`` taps ``out_indices``
    without the prefix tokens."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 wv_planes: int = 128, out_indices: tuple[int, ...] = (5, 11, 17, 22),
                 num_reg_tokens: int = 4, rope_theta: float = 100.0, rope_coords: str = "box"):
        super().__init__()
        self.img_size, self.embed_dim, self.depth = img_size, embed_dim, depth
        self.num_heads, self.out_indices = num_heads, tuple(out_indices)
        self.num_reg_tokens, self.rope_theta, self.rope_coords = (num_reg_tokens, rope_theta,
                                                                  rope_coords)
        self.patch_embed = DynamicPatchEmbed(wv_planes, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.reg_token = nn.Parameter(torch.zeros(1, num_reg_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, init_values=1e-5,
                     num_prefix=1 + num_reg_tokens)
            for _ in range(depth - 1))

    num_taps = OFAViT.num_taps

    @property
    def num_prefix_tokens(self) -> int:
        return 1 + self.num_reg_tokens

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(0.0, 1e-6, generator=generator)
        self.reg_token.normal_(0.0, 1e-6, generator=generator)

    def _embed_tokens(self, x: torch.Tensor, wvs: torch.Tensor):
        tokens, _ = self.patch_embed(x.float(), wvs.float())
        b, s, d = tokens.shape
        grid = int(np.sqrt(s))
        rope = _rope_2d(grid, grid, d // self.num_heads, self.rope_theta, self.rope_coords,
                        device=tokens.device)
        prefix = torch.cat([self.cls_token, self.reg_token], dim=1).expand(b, -1, -1)
        return torch.cat([prefix, tokens], dim=1), rope

    def forward_features(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        h, rope = self._embed_tokens(x, wvs)
        return _taps(self.blocks, h, (self.depth - 2,), rope, self.num_prefix_tokens)[0]

    def forward_lpips(self, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
        h, rope = self._embed_tokens(x, wvs)
        return _taps(self.blocks, h, self.out_indices, rope, self.num_prefix_tokens)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x, wvs)


def dofa_taps(dofa: nn.Module, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
    """The multi-tap features: v3's ``forward_lpips`` (its ``forward_features``
    is one tensor), the v1/v2 ``forward_features``."""
    fn = getattr(dofa, "forward_lpips", None) or dofa.forward_features
    return fn(x, wvs)


class DOFAFeatures(nn.Module):
    """``fn(x, wvs) → taps`` over a frozen DOFA: the consistency loss's feature net."""

    def __init__(self, dofa: nn.Module):
        super().__init__()
        self.dofa = dofa

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> list[torch.Tensor]:
        return dofa_taps(self.dofa, x, wvs)


class DOFALPIPS(nn.Module):
    """Perceptual distance over frozen DOFA features: each of the first
    ``num_layers`` taps normalized over the feature axis (+1e-10), the squared
    difference weighted by ``lin_k`` [D] (constant 1/D, as the reference's
    NetLinLayer init) and averaged; the sum over taps. fp32.

    ``forward(inputs, target, wvs) → scalar``."""

    def __init__(self, dofa: nn.Module, num_layers: int = 4):
        super().__init__()
        self.dofa, self.num_layers = dofa, num_layers
        d = dofa.embed_dim
        for k in range(min(num_layers, dofa.num_taps)):  # one weight a tap used
            self.register_parameter(f"lin_{k}", nn.Parameter(torch.full((d,), 1.0 / d)))

    def forward(self, inputs: torch.Tensor, target: torch.Tensor,
                wvs: torch.Tensor) -> torch.Tensor:
        feats_in, feats_tgt = dofa_taps(self.dofa, inputs, wvs), dofa_taps(self.dofa, target, wvs)
        total = torch.zeros((), dtype=torch.float32, device=inputs.device)
        for k, (fi, ft) in enumerate(zip(feats_in, feats_tgt)):
            if k >= self.num_layers:
                break
            fi, ft = fi.float(), ft.float()
            fi = fi / (torch.linalg.vector_norm(fi, dim=-1, keepdim=True) + 1e-10)
            ft = ft / (torch.linalg.vector_norm(ft, dim=-1, keepdim=True) + 1e-10)
            total = total + torch.mean((fi - ft) ** 2 @ getattr(self, f"lin_{k}"))
        return total


class DOFADiscriminator(nn.Module):
    """Feature-space discriminator heads over frozen DOFA features: per tap a
    token-wise Linear(D → hidden) → LeakyReLU(0.2) → Linear(hidden → 1)
    (``heads.k.0`` / ``heads.k.2``, the reference's 1×1 Conv1d), the logits
    [B, N] of each tap concatenated: [B, Σ N]."""

    def __init__(self, dofa: nn.Module, hidden_dim: int = 256, num_layers: int = 4):
        super().__init__()
        self.dofa, self.hidden_dim, self.num_layers = dofa, hidden_dim, num_layers
        self.heads = nn.ModuleList(
            nn.Sequential(nn.Linear(dofa.embed_dim, hidden_dim), nn.LeakyReLU(0.2),
                          nn.Linear(hidden_dim, 1))
            for _ in range(min(num_layers, dofa.num_taps)))

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        feats = dofa_taps(self.dofa, x, wvs)
        return torch.cat([head(f.float()).reshape(x.shape[0], -1)
                          for head, f in zip(self.heads, feats)], dim=1)


class DOFAEncoderWrapper:
    """A DOFA model bound to fixed wavelengths: called with images only, it
    returns the model's forward as a tuple."""

    def __init__(self, dofa: nn.Module, wavelengths, out_indices=None):
        self.dofa = dofa
        self.wavelengths = torch.as_tensor(np.asarray(wavelengths, np.float32))
        self.out_channels = [dofa.embed_dim] * len(out_indices or dofa.out_indices)

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return tuple(self.dofa(x, self.wavelengths.to(x.device)))


def get_wavelengths(model_bands) -> list[float]:
    """Band names (or a modality name) → wavelengths in µm."""
    if isinstance(model_bands, str):
        return list(WAVELENGTHS[model_bands])
    return [BAND_WAVELENGTHS[b.split(".")[-1]] for b in model_bands]


# The reference's spelling.
get_wavelenghts = get_wavelengths


# ---------------------------------------------------------------------------
# Builders and the checkpoint loader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoadReport:
    """The checkpoint's keys (after the prefix strip) by what the loader did:
    loaded, skipped (``num_batches_tracked``) or unexpected, each in file order."""

    converted: list[str]
    skipped: list[str]
    unexpected: list[str]


def load_torch_file(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` / ``.ckpt`` / ``.safetensors`` file's tensors, a
    ``state_dict`` entry unwrapped. Torch files pickle more than tensors: load
    trusted files only."""
    ckpt = read_checkpoint(path)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def _maybe_load(vit: nn.Module, weights_path: str | None,
                strip_prefixes: tuple[str, ...] = ()) -> LoadReport | None:
    """Load a reference checkpoint into ``vit`` in place (None without a path).

    A key loads where the module has a parameter or persistent buffer of that
    name; a shape that differs raises. ``num_batches_tracked`` is skipped, and
    every other key is unexpected and ignored: timm's ``norm``/``fc_norm``/
    ``head``, v1's constant ``pos_embed``, v3's last block. Those are the JAX
    package's converter's verdicts on the same file. Parameters the file does
    not hold keep their initial values."""
    if weights_path is None:
        return None
    sd = load_torch_file(weights_path)
    for p in strip_prefixes:  # v2/v3 nest the timm backbone under `model.`
        sd = {k[len(p):] if k.startswith(p) else k: v for k, v in sd.items()}
    own = vit.state_dict()
    report, updates = LoadReport([], [], []), {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            report.skipped.append(key)
        elif key in own:
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(f"Shape mismatch for {key}: the file holds "
                                 f"{tuple(value.shape)}, the model {tuple(own[key].shape)}")
            updates[key] = value
            report.converted.append(key)
        else:
            report.unexpected.append(key)
    vit.load_state_dict(updates, strict=False)
    return report


def _built(vit: nn.Module, weights_path: str | None,
           strip_prefixes: tuple[str, ...] = ()) -> tuple[nn.Module, LoadReport | None]:
    """``vit`` with its initial weights from seed 0 (the JAX package's init key),
    then the checkpoint's: ``(module, report or None)``."""
    init_parameters(vit, torch.Generator().manual_seed(0))
    return vit, _maybe_load(vit, weights_path, strip_prefixes)


def dofav1_base_patch16_224(weights_path: str | None = None, **kwargs):
    """DOFA v1 base; returns ``(module, LoadReport | None)``."""
    return _built(dofa_vit_base_patch16(**kwargs), weights_path)


def dofav1_large_patch16_224(weights_path: str | None = None, **kwargs):
    return _built(dofa_vit_large_patch16(**kwargs), weights_path)


def dofav2_base_patch14_224(weights_path: str | None = None, model_bands=None,
                            convert_patch_14_to_16: bool = False, out_indices=None, **kwargs):
    """DOFA v2 base (ViT-B/14); returns ``(module, LoadReport | None)``."""
    vit = DOFAViTv2(out_indices=tuple(out_indices) if out_indices else (4, 6, 10, 11),
                    convert_patch_14_to_16=convert_patch_14_to_16, **kwargs)
    return _built(vit, weights_path, ("model.",))


def dofav2_large_patch14_224(weights_path: str | None = None, model_bands=None,
                             convert_patch_14_to_16: bool = False, out_indices=None, **kwargs):
    vit = DOFAViTv2(embed_dim=1024, depth=24, num_heads=16,
                    out_indices=tuple(out_indices) if out_indices else (5, 9, 15, 21),
                    convert_patch_14_to_16=convert_patch_14_to_16, **kwargs)
    return _built(vit, weights_path, ("model.",))


def dofav3_large_patch16_224(weights_path: str | None = None, model_bands=None,
                             out_indices=None, **kwargs):
    vit = DOFAViTv3(out_indices=tuple(out_indices) if out_indices else (5, 11, 17, 22),
                    **kwargs)
    return _built(vit, weights_path, ("model.",))


#: The pretrained backbones' Hugging Face files (repository, file name).
DOFA_HF_WEIGHTS = {
    "dofav1_base": ("earthflow/DOFA", "DOFA_ViT_base_e100.pth"),
    "dofav1_large": ("earthflow/DOFA", "DOFA_ViT_large_e100.pth"),
}
