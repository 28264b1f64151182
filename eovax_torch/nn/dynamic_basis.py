"""Shared-basis dynamic stems (``stem.mode: basis``).

Port of ``eovax/nn/dynamic_basis.py``: a bank of ``num_bases`` K×K basis
kernels shared by every channel, mixed by per-(band, channel) coefficients
that a deep MLP hypernetwork computes from the band's wavelength. The input
layer maps N bands to a fixed width; the output layer maps a fixed width to N
bands with a generated per-band bias. Both expose ``generate`` and
``get_distillation_weight`` in torch's OIHW layout, so that stage-1
distillation and the adversarial loss's adaptive weight treat them as they
treat the transformer stems.

The hypernetwork runs in fp32 (TF32 off through ``Policy.activate``, the
JAX package's ``HIGHEST``) with exact GELU; the wavelengths are embedded
as sincos of wvs·1000 through ``wv_proj``. The kernel is
``einsum("nob,bxy->noxy")`` of coefficients and bank, with no 0.1 scaler
(unlike ``DynamicConv``). The conv is the library's, as every stem conv is.

Parameter names are the JAX package's (``basis_bank``, ``hypernet.backbone_0``
… ``backbone_out``, ``expansion``, ``wv_proj``, ``bias_generator_0``,
``bias_generator_2``), so :func:`eovax_torch.utils.convert.state_dict_from_variables`
loads its variables as they are; the bank keeps its JAX shape [num_bases, K, K].
The reference implementation's own torch names for these layers are not
available to check against, so a reference checkpoint of a basis model is not
mapped here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.nn.dynamic_conv import apply_dynamic_kernel, sincos_wavelength_embed


class ScalableHyperNet(nn.Module):
    """Deep MLP with a low-rank expansion head: ``depth`` + 1 GELU layers of
    width 2·in_dim, a rank_dim bottleneck and the expansion to ``out_dim``;
    xavier-uniform weights and zero biases, the expansion N(0, 0.001)."""

    def __init__(self, in_dim: int, rank_dim: int, out_dim: int, depth: int = 3):
        super().__init__()
        self.depth = depth
        for i in range(depth + 1):
            setattr(self, f"backbone_{i}", nn.Linear(in_dim * 2 if i else in_dim, in_dim * 2))
        self.backbone_out = nn.Linear(in_dim * 2, rank_dim)
        self.expansion = nn.Linear(rank_dim, out_dim)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        for i in range(self.depth + 1):
            nn.init.xavier_uniform_(getattr(self, f"backbone_{i}").weight, generator=generator)
        nn.init.xavier_uniform_(self.backbone_out.weight, generator=generator)
        self.expansion.weight.normal_(0.0, 0.001, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth + 1):
            h = F.gelu(getattr(self, f"backbone_{i}")(h))  # exact (erf) GELU
        return self.expansion(self.backbone_out(h))


class _SharedBasisBase(nn.Module):
    def __init__(self, channels: int, num_bases: int = 64, rank_dim: int = 64,
                 kernel_size: int = 3, wv_dim: int = 128, policy: Policy = FULL_PRECISION):
        super().__init__()
        self.channels = channels
        self.num_bases = num_bases
        self.kernel_size = kernel_size
        self.wv_dim = wv_dim
        self.policy = policy
        self.basis_bank = nn.Parameter(torch.empty(num_bases, kernel_size, kernel_size))
        self.hypernet = ScalableHyperNet(wv_dim, rank_dim, channels * num_bases)
        self.wv_proj = nn.Linear(wv_dim, wv_dim)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        # torch's kaiming_uniform_(a=√5) on a [num_bases, 1, K, K] bank: ±1/K.
        bound = 1.0 / self.kernel_size
        self.basis_bank.uniform_(-bound, bound, generator=generator)

    def _embed(self, wvs: torch.Tensor) -> torch.Tensor:
        return self.wv_proj(sincos_wavelength_embed(self.wv_dim, wvs.float() * 1000.0))

    def _kernel(self, emb: torch.Tensor) -> torch.Tensor:
        """[N, channels, K, K] = Σ_b coeffs[n, c, b] · basis[b]."""
        coeffs = self.hypernet(emb).reshape(-1, self.channels, self.num_bases)
        return torch.einsum("ncb,bxy->ncxy", coeffs, self.basis_bank)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return apply_dynamic_kernel(x, weight, bias, padding=self.kernel_size // 2,
                                    policy=self.policy)

    def get_distillation_weight(self, wvs: torch.Tensor):
        """Torch-layout (weight, bias) for stage-1 distillation: :meth:`generate`."""
        return self.generate(wvs)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        return self._conv(x, *self.generate(wvs))


class DynamicInputLayer(_SharedBasisBase):
    """Encoder input stem: [B, N, H, W] → [B, out_channels, H, W]."""

    def __init__(self, out_channels: int = 128, **kw):
        super().__init__(out_channels, **kw)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def generate(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight [out, N, K, K], bias [out])."""
        return self._kernel(self._embed(wvs)).transpose(0, 1), self.bias


class DynamicOutputLayer(_SharedBasisBase):
    """Decoder output stem: [B, in_channels, H, W] → [B, N, H, W], with a
    per-band bias from ``bias_generator_0`` → ReLU → ``bias_generator_2``."""

    def __init__(self, in_channels: int = 128, **kw):
        super().__init__(in_channels, **kw)
        self.bias_generator_0 = nn.Linear(self.wv_dim, 32)
        self.bias_generator_2 = nn.Linear(32, 1)

    def generate(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight [N, in, K, K], bias [N])."""
        emb = self._embed(wvs)
        bias = self.bias_generator_2(F.relu(self.bias_generator_0(emb))).reshape(-1)
        return self._kernel(emb), bias
