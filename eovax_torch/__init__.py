"""eovax_torch — the EO-VAE on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``eovax`` that keeps its module names
(``eovax_torch.nn.blocks`` ↔ ``eovax.nn.blocks``) and its public API, and
imports nothing of it. Plain tensor code is PyTorch; the TPU's Pallas
kernels become hand-written Hopper kernels under ``eovax_torch.kernels``,
built with ``nvcc`` at first use.

Subpackages
-----------
- ``eovax_torch.core``     config dataclasses and dtype policies
- ``eovax_torch.data``     wavelength tables, normalization, Sen2NAIP and synthetic batches
- ``eovax_torch.kernels``  CUDA kernels, their wrappers and plain versions
- ``eovax_torch.nn``       blocks, hypernetwork stems, latent plumbing
- ``eovax_torch.models``   the EO-VAE backbone and the ``EOFluxVAE`` API
- ``eovax_torch.losses``   the stage-2 reconstruction losses
- ``eovax_torch.train``    the stage-2 train step, its optimizer and schedule, the trainer
- ``eovax_torch.utils``    the JAX-variables → state-dict bridge, checkpoints, logging
"""

from eovax_torch.models.eo_flux_vae import EOFluxVAE

__all__ = ["EOFluxVAE"]
