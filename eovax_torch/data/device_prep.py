"""Device-side batch preparation: z-score normalize + D4 augment.

The torch counterpart of ``eovax/data/device_prep.py``. With the
``device_prep`` collate mode (:mod:`eovax_torch.data.collate`) the host
emits the raw decoded batch in its stored dtype (int16 for S2) with small
per-sample descriptors, the trainer copies it to the device as it is (half
the bytes of an fp32 batch) and expands it there with :func:`device_prepare`
(``eovax_torch.train.stage2.Stage2Trainer._place``).

The result is bit-identical to the host collate's: ``clip → (x − mean) ·
(1/std) → D4``, where ``std`` already holds the legacy ``+1e-8``, the
reciprocal is taken in fp32 as the host normalizer takes it, and the
subtract and the multiply are separate operations (a fused multiply-add
would round once where the host rounds twice). The D4 draw (flip_h, flip_v,
rot_k) comes from the collate's RNG, the same stream as the host path's.
Non-square batches draw from the shape-preserving subgroup (flips and
rot180), as the collate folds odd rotations for them.

The D4 draw is read on the host (the collate's numpy leaf; a CUDA tensor
costs a sync), and each run of rows with one draw is permuted once, in the
raw batch: D4 moves pixels within a sample and the normalization is per sample
and channel, so permuting first gives the same bits and moves the narrow
input dtype. The JAX function selects among every flip and rotation
instead, because its draw is a traced value.

Tensor ops only: at [16,256,256,12] int16 the function moves about 75 MB,
a few hundredths of a millisecond of HBM time against a train step of
hundreds of milliseconds, and the JAX function it ports is XLA, not Pallas.
"""

from __future__ import annotations

import torch

__all__ = ["device_prepare"]


def _d4(x: torch.Tensor, flip_h: int, flip_v: int, rot_k: int) -> torch.Tensor:
    """H-flip, V-flip, then rot90 ``rot_k`` on axes (H, W) of an NHWC batch: the
    op order of ``collate.apply_batch_augmentations``. Odd ``rot_k`` rotates only
    a square batch."""
    if flip_h:
        x = x.flip(2)
    if flip_v:
        x = x.flip(1)
    if rot_k == 2 or (rot_k % 2 and x.shape[1] == x.shape[2]):
        x = x.rot90(rot_k, (1, 2))
    return x


def device_prepare(
    image: torch.Tensor,
    norm_mean: torch.Tensor,
    norm_std: torch.Tensor,
    norm_clip: torch.Tensor,
    d4=None,
) -> torch.Tensor:
    """Normalize and D4-augment one NHWC batch on the device of ``image``.

    Args:
      image: [B,H,W,C] raw decoded values (any real dtype; cast to fp32).
      norm_mean / norm_std: [C] fp32, or per-sample [B,C] (the collate's
        form). ``norm_std`` already contains any epsilon.
      norm_clip: [2] ``(lo, hi)`` or per-sample [B,2]; ``(-inf, +inf)``
        disables the clip ('legacy' scheme; 'custom' clips S2 to [0, 10000]).
      d4: ``(flip_h, flip_v, rot_k)`` integers (a numpy array or a tensor),
        [3] for the whole batch or per-sample [B,3], or None to skip the
        augment (eval batches). Odd ``rot_k`` rotates only square batches; on
        a non-square batch only ``rot_k == 2`` rotates, as in the JAX function.

    Returns the prepared batch, NHWC fp32 (the JAX function's layout).
    """
    x = image
    if d4 is not None:
        b = x.shape[0]
        rows = torch.as_tensor(d4).reshape(-1, 3).expand(b, 3).tolist()
        # Runs of consecutive rows with one draw, sliced: no index tensor to copy.
        starts = [i for i in range(b) if i == 0 or rows[i] != rows[i - 1]] + [b]
        if len(starts) == 2:
            x = _d4(x, *rows[0])
        else:
            x = torch.empty_like(image)
            for i, j in zip(starts, starts[1:]):
                x[i:j] = _d4(image[i:j], *rows[i])
    x = x.float()
    clip = norm_clip.float().reshape(-1, 2)
    x = torch.clamp(x, min=clip[:, 0].view(-1, 1, 1, 1), max=clip[:, 1].view(-1, 1, 1, 1))
    c = x.shape[-1]
    mean = norm_mean.float().reshape(-1, 1, 1, c)
    scale = torch.reciprocal(norm_std.float()).reshape(-1, 1, 1, c)
    x = torch.sub(x, mean)
    return torch.mul(x, scale)
