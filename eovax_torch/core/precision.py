"""Dtype policy threaded through the model code.

Port of ``eovax/core/precision.py``: fp32 parameters, a compute dtype for the
convolutions and the attention (fp32 or bf16), and fp32 islands for the
normalization statistics, the softmax statistics and the hypernetworks.
Casts are explicit and sit where the JAX package puts them; ``torch.autocast``
is not used, because it rounds at other places.

Every fp32 contraction of the JAX package runs at ``Precision.HIGHEST``
(the fp32 policy everywhere, the hypernetworks and AdaIN projections under
the bf16 policy too). Its counterpart here is TF32 switched off for cuDNN
convolutions and cuBLAS matmuls, which :meth:`Policy.activate` does.

``conv_algorithm`` picks how the ResnetBlock and SR UNet 3×3 convs run:
``"direct"`` (the conv3x3 kernel; the training path), ``"int8"`` (W8A8
through :mod:`eovax_torch.kernels.qconv`, inference only) or ``"int8-calib"``
(the direct conv, recording each eligible conv input's |x| percentile for
static int8 scales).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes for parameters, conv/matmul compute and normalization, the
    3×3 conv algorithm, and the |activation| percentile that the
    ``"int8-calib"`` pass records (99.9: saturating the top 0.1 % costs less
    than losing resolution on the body of the distribution)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32
    conv_algorithm: str = "direct"
    calib_percentile: float = 99.9

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def activate(self) -> None:
        """Run fp32 convs and matmuls in full fp32 (no TF32), the
        counterpart of ``jax.lax.Precision.HIGHEST``. Process-wide flags, set
        whatever the policy: every ``EOFluxVAE`` calls this, so the fp32
        networks beside the model (the loss's DOFA) run at HIGHEST too."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


#: fp32 everywhere — parity tests and stage-1 distillation.
FULL_PRECISION = Policy()

#: bf16 compute, fp32 params and statistics — the inference policy.
DEFAULT_POLICY = Policy(compute_dtype=torch.bfloat16)

#: DEFAULT_POLICY + W8A8 int8 body convs — quantized inference serving.
INT8_POLICY = dataclasses.replace(DEFAULT_POLICY, conv_algorithm="int8")

#: The calibration pass for static int8 activation scales: bf16 convs that
#: record their input's |x| percentile.
INT8_CALIB_POLICY = dataclasses.replace(DEFAULT_POLICY, conv_algorithm="int8-calib")


def policy_from_name(name: str) -> Policy:
    """Map config strings ('32-true', '16-mixed', 'bf16-mixed', ...) to a Policy."""
    name = str(name).lower()
    if name in ("32", "32-true", "fp32", "float32"):
        return FULL_PRECISION
    if name in ("16-mixed", "bf16-mixed", "bf16", "bfloat16", "mixed"):
        return DEFAULT_POLICY
    if name in ("int8", "w8a8"):
        return INT8_POLICY
    if name in ("bf16-winograd", "winograd"):
        raise ValueError(f"precision policy {name!r}: the Winograd conv is not ported yet "
                         "(ROADMAP Queue 1 item 10)")
    raise ValueError(f"Unknown precision policy: {name!r}")
