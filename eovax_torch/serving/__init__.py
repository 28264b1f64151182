"""Model export and serving on the card (``torch.export``).

Port of ``eovax.serving``. Each public function of the inference surface
(``reconstruct``, ``encode_spatial_normalized``,
``decode_spatial_normalized``) is exported with ``torch.export`` as a graph
with a symbolic batch dimension, beside one weights file; the stage-3 SR
pipeline (encode → sampler → decode) is one more graph. A server (or another
process) reloads the artifact and runs it on the card without the model
code:

    from eovax_torch.serving import export_model, ServedModel
    export_model(model, "artifact/", modalities=("S2L2A", "S2RGB"))
    served = ServedModel.load("artifact/")                 # CUDA; device="cpu" too
    recon = served.reconstruct(x_nchw, modality="S2L2A")   # any batch size

Design notes:
- Functions are exported taking ``(state, x)``, so the weights live once in
  ``params.pt`` instead of in every graph: the traced core's parameters are
  on the meta device, and ``torch.func.functional_call`` takes them from
  ``state``. The loader reads ``params.pt`` once (``weights_only=True``) and
  shares it.
- One graph per modality: the wavelength vector is a per-modality constant
  (a buffer of the graph) and the channel count changes the signature.
- The batch dimension is symbolic (``torch.export.Dim``); H and W are fixed
  per artifact — export several resolutions if needed.
- The hand kernels appear in the graphs as the custom ops ``eovax::conv3x3``,
  ``eovax::conv3x3_int8``, ``eovax::group_norm`` and ``eovax::flash_attention``
  (:mod:`eovax_torch.kernels.ops`): on the card each launches its kernel
  (and counts the launch), on the CPU it computes its plain version.
- The dtype policy (fp32, bf16 or int8) is traced into the graphs and recorded
  in the manifest; the tensors cross the API in NCHW, as the model takes them.
- int8 (W8A8): an ``INT8_POLICY`` model's body-conv weights are quantized once
  at export (int8 weights and fp32 per-channel scales in ``params.pt``, the
  manifest's ``quantization`` block), with dynamic per-tensor activation
  ranges or static ones from :func:`calibrate_activations`. A dynamic range
  spans the whole batch, so a request's reply depends on the requests (and the
  pad rows) it is batched with, as in the JAX package; static ranges do not.
- The artifact format (``eovax-torch-serving-v1``) is not the JAX package's
  StableHLO format: neither loads the other's artifacts.
- Several cards: ``ServedModel.with_mesh(make_device_mesh())`` serves one
  process's cards data-parallel (a copy of the weights a card, a batch split
  into row blocks, the result gathered on the first card; the view is a
  ``MeshServedModel``); ``serve --mesh``. A dynamic-range int8 artifact is
  refused there: its range spans the batch it is called on, and a split would
  change it. One host thread issues every card's graph in turn, so a host-paced
  artifact (small batches, int8) runs slower over several cards than on one.
"""

from eovax_torch.serving.batching import MicroBatcher  # noqa: F401
from eovax_torch.serving.export import (  # noqa: F401
    MeshServedModel,
    ServedModel,
    calibrate_activations,
    export_model,
    export_sr_pipeline,
    per_sample_seeds,
)
from eovax_torch.serving.server import make_server, warmup  # noqa: F401
