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
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes for parameters, conv/matmul compute and normalization."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32

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


def policy_from_name(name: str) -> Policy:
    """Map config strings ('32-true', '16-mixed', 'bf16-mixed', ...) to a Policy."""
    name = str(name).lower()
    if name in ("32", "32-true", "fp32", "float32"):
        return FULL_PRECISION
    if name in ("16-mixed", "bf16-mixed", "bf16", "bfloat16", "mixed"):
        return DEFAULT_POLICY
    raise ValueError(f"Unknown precision policy: {name!r}")
