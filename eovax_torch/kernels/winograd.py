"""Winograd F(2×2, 3×3) convolution as 16 batched matrix products (NCHW).

Port of ``eovax/kernels/winograd.py``, which the JAX package computes in XLA
(no Pallas kernel): here it is a torch composition. The output is split into
2×2 tiles; each tile comes from a 4×4 input window as

    Y = Aᵀ [ (G w Gᵀ) ⊙ (Bᵀ d B) ] A          (Lavin & Gray, arXiv:1509.09308)

and the elementwise product over the 16 transform positions becomes, over
the tiles and channels, 16 products ``[N, C_in] @ [C_in, C_out]`` with
``N = B·(H/2)·(W/2)`` (``torch.bmm``): 4/9 of the direct conv's multiplies.
The transforms are the same ±1/±½ stencils as the JAX package's, as adds and
subtracts in the compute dtype; the kernel transform G w Gᵀ is computed in
fp32 from the fp32 weight and rounded once to the compute dtype; the products
sum in fp32 and round to the compute dtype, as the JAX package's
``preferred_element_type`` does.

The tensors here are NCHW where the JAX package's are NHWC: the tile gather
takes strided (H, W) slices of the padded input, and the output interleave
puts tile position (p, q) at pixel (2i + p, 2j + q).

Selected by ``Policy.conv_algorithm = "winograd"`` (``WINOGRAD_POLICY``) at
the ResnetBlock and SR UNet 3×3 convs where :func:`should_use_winograd`
holds; gradients flow through autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# G (4×3), the kernel transform; Bᵀ (4×4) and Aᵀ (2×4) are the adds and
# subtracts of _bt and _at.
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def transform_kernel(w: torch.Tensor) -> torch.Tensor:
    """G w Gᵀ over the spatial dims: OIHW [O, I, 3, 3] → [16, I, O] (fp32)."""
    g = torch.tensor(_G, dtype=torch.float32, device=w.device)
    u = torch.einsum("ui,vj,ocij->uvco", g, g, w.float())
    return u.reshape(16, w.shape[1], w.shape[0])


def _bt(v0, v1, v2, v3):
    """Bᵀ's rows: d0 − d2, d1 + d2, d2 − d1, d1 − d3."""
    return (v0 - v2, v1 + v2, v2 - v1, v1 - v3)


def _at(v0, v1, v2, v3):
    """Aᵀ's rows: y0 + y1 + y2, y1 − y2 − y3."""
    return (v0 + v1 + v2, v1 - v2 - v3)


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, *,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3×3 stride-1 SAME conv of NCHW ``x`` with OIHW ``w`` via F(2×2, 3×3), in
    ``compute_dtype``. Needs even H and W. Exact in fp32 up to reassociation;
    in bf16 the error is of the order of the direct bf16 conv's rounding."""
    b, c, h, wd = x.shape
    o = w.shape[0]
    if h % 2 or wd % 2:
        raise ValueError(f"winograd_conv3x3 needs even H, W; got {h}x{wd}")
    xp = F.pad(x.to(compute_dtype), (1, 1, 1, 1))
    # d[a][bb]: position (a, bb) of every 4×4 tile, [B, C, H/2, W/2]; tile i
    # covers padded rows 2i … 2i+3.
    d = [[xp[:, :, a:a + h:2, bb:bb + wd:2] for bb in range(4)] for a in range(4)]
    rows = [_bt(*[d[a][bb] for a in range(4)]) for bb in range(4)]  # rows[bb][u]
    tiles = [t for u in range(4) for t in _bt(*[rows[bb][u] for bb in range(4)])]
    xt = torch.stack(tiles).permute(0, 1, 3, 4, 2).reshape(16, -1, c)  # [16, N, C]
    y = torch.bmm(xt, transform_kernel(w).to(compute_dtype))  # [16, N, O]
    y = y.reshape(4, 4, b, h // 2, wd // 2, o)
    s = [_at(*[y[u, v] for u in range(4)]) for v in range(4)]  # s[v][p]
    m = [_at(*[s[v][p] for v in range(4)]) for p in range(2)]  # m[p][q]: [B, H/2, W/2, O]
    out = torch.stack([torch.stack(m[p]) for p in range(2)])  # [p, q, B, H/2, W/2, O]
    out = out.permute(2, 5, 3, 0, 4, 1).reshape(b, o, h, wd)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out


def should_use_winograd(x_shape, kernel_shape, strides, compute_dtype) -> bool:
    """The JAX package's dispatch rule (NCHW ``x_shape``, OIHW ``kernel_shape``):
    bf16 compute, a 3×3 stride-1 conv, even H and W, and
    min(C_in, C_out) ≥ 128."""
    if compute_dtype != torch.bfloat16:
        return False
    if tuple(kernel_shape[2:]) != (3, 3) or tuple(strides) != (1, 1):
        return False
    _, ci, h, w = x_shape
    return h % 2 == 0 and w % 2 == 0 and min(ci, kernel_shape[0]) >= 128
