from eovax_torch.nn.blocks import (  # noqa: F401
    AttnBlock,
    Downsample,
    ResnetBlock,
    Upsample,
    WavelengthConditioner,
)
from eovax_torch.nn.distributions import DiagonalGaussian  # noqa: F401
from eovax_torch.nn.dynamic_conv import (  # noqa: F401
    DynamicConv,
    DynamicConvDecoder,
    FCResLayer,
    sincos_wavelength_embed,
)
from eovax_torch.nn.embeddings import (  # noqa: F401
    LearnedPositionalEmbedding,
    RelativePositionBias,
    TimestepEmbedding,
    Timesteps,
    get_timestep_embedding,
)
from eovax_torch.nn.latent import LatentBatchNorm, patch_shuffle, patch_unshuffle  # noqa: F401
