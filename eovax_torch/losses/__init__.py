"""Stage-2 reconstruction losses (NCHW, fp32). Port of ``eovax/losses``."""

from eovax_torch.losses.consistency import EOConsistencyLoss  # noqa: F401
from eovax_torch.losses.ffl import focal_frequency_loss  # noqa: F401
from eovax_torch.losses.msssim import multiscale_ssim  # noqa: F401
