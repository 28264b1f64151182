"""``torch.export`` artifacts of the EO-VAE inference surface, and their loader.

Port of ``eovax/serving/export.py``. See :mod:`eovax_torch.serving` for the
design. An artifact is a directory of

- ``params.pt``: the weights once, a torch state dict (``torch.save``; loaded
  with ``weights_only=True``);
- one ``<function>.<modality>.pt2`` per function and modality
  (``torch.export.save``), each a graph over ``(state, x)`` with a symbolic
  batch and no weights of its own;
- ``manifest.json``: the JAX package's manifest keys (``resolution``,
  ``params``, ``functions`` → ``file``, ``modality``, ``input_shape``,
  ``dtype``, ``extra_args``, and for an int8 model ``quantization``) under the
  format :data:`FORMAT`, plus the policy and the device the graphs were traced on.

Under the int8 policy the body convs' weights are quantized once, at export
(:func:`eovax_torch.kernels.qconv.quantize_state_int8`): ``params.pt`` holds
their int8 weights with fp32 ``kernel_scale`` (and, calibrated by
:func:`calibrate_activations`, ``act_scale``) tensors, and the graphs call
``eovax::conv3x3_int8``.
"""

from __future__ import annotations

import copy
import json
import operator
import os
import warnings
from typing import Any

import numpy as np
import torch
from torch import nn

#: function name → (core method, latent-space input?)
_FUNCTIONS = {
    "reconstruct": ("reconstruct", False),
    "encode_spatial_normalized": ("encode_spatial_normalized", False),
    "decode_spatial_normalized": ("decode_spatial_normalized", True),
}

#: The artifact format; the JAX package's ``eovax-serving-v1`` artifacts are
#: StableHLO and do not load here, nor these there.
FORMAT = "eovax-torch-serving-v1"
_MANIFEST = "manifest.json"
_PARAMS = "params.pt"


def per_sample_seeds(seed: int, n: int):
    """``[seed, seed+1, …, seed+n-1]`` as int32 with wraparound.

    THE scalar→vector seed derivation for per-sample-seed SR artifacts —
    `ServedModel.super_resolve` (scalar convenience arg) and the serving
    daemon's micro-batched path both use it, so a request served batched
    and the same request served unbatched draw identical per-sample
    noise (results agree to fp tolerance across batch compositions, and
    bitwise within one). Consecutive seeds keep the property that samples
    within one request draw DISTINCT noise (a broadcast scalar would hand
    every row the same x1), while sample ``i`` stays reproducible as the
    B=1 call with ``seed+i``."""
    raw = np.int64(seed) + np.arange(n, dtype=np.int64)
    return (raw & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _cast_float_params(state: dict, params: set, params_dtype) -> dict:
    """``state`` with its float parameters (the keys in ``params``) cast to
    ``params_dtype``; buffers (the latent BatchNorm's running statistics, the int8
    convs' ``kernel_scale`` / ``act_scale``) and int8 weights stay."""
    return {k: v.to(params_dtype) if k in params and v.is_floating_point() else v
            for k, v in state.items()}


def _upcast(state: dict) -> dict:
    """Float tensors stored below fp32 (``--compact-weights``) back to fp32: the
    graph computes with the stored values, under the traced policy."""
    return {k: v.float() if v.is_floating_point() and v.dtype != torch.float32 else v
            for k, v in state.items()}


def _quant_manifest(quantized_convs: int, act_scales=None) -> dict:
    return {
        "weights": "int8-symmetric-per-out-channel",
        "quantized_convs": quantized_convs,
        "activations": (
            "static-percentile-calibrated" if act_scales else
            "dynamic-per-tensor-absmax"
        ),
    }


def _meta_copy(module: nn.Module, state: dict) -> nn.Module:
    """A copy of ``module`` whose parameters and buffers are on the meta device
    (no data is copied), with the int8 convs that ``state`` holds. A traced graph
    then holds no weights: they come in with ``state``."""
    from eovax_torch.nn.blocks import Conv3x3

    memo: dict[int, Any] = {}
    for p in module.parameters():
        memo[id(p)] = nn.Parameter(p.detach().to("meta"), requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.detach().to("meta")
    out = copy.deepcopy(module, memo).eval()
    for name, m in out.named_modules():
        if isinstance(m, Conv3x3) and f"{name}.kernel_scale" in state:
            m.to_int8(act_scale=f"{name}.act_scale" in state)
    return out


class _Holder(nn.Module):
    """A module under the name ``m``, for ``functional_call``: ``forward(fn,
    *args)`` runs ``fn(module, *args)`` with the module's weights replaced."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args):
        return fn(self.m, *args)


def _call(holder: _Holder, state: dict, fn, *args):
    weights = {f"m.{k}": v for k, v in _upcast(state).items()}
    return torch.func.functional_call(holder, weights, (fn, *args), strict=True)


class _Surface(nn.Module):
    """``(state, x) → core.<method>(x, wvs)`` with the core's weights from
    ``state``; the modality's wavelengths are a buffer of the graph."""

    def __init__(self, core: nn.Module, state: dict, method: str, wvs, device: torch.device):
        super().__init__()
        object.__setattr__(self, "_holder", _Holder(_meta_copy(core, state)))  # not a submodule
        self._method = method
        self.register_buffer("wvs", torch.as_tensor(np.asarray(wvs, np.float32), device=device))

    def forward(self, state: dict, x: torch.Tensor) -> torch.Tensor:
        method = self._method
        return _call(self._holder, state, lambda m, a, w: getattr(m, method)(a, w), x, self.wvs)


class _SRPipeline(nn.Module):
    """``(state, x_lr, eps) → y``: encode, the sampler from x1 = σ(1)·eps,
    de-normalize the latent, decode; ``state`` is ``{"vae", "sr",
    "latent_norm": {"mean", "std"}}``."""

    def __init__(self, core: nn.Module, unet: nn.Module, state: dict, sampler, wvs,
                 device: torch.device):
        super().__init__()
        object.__setattr__(self, "_vae", _Holder(_meta_copy(core, state["vae"])))
        object.__setattr__(self, "_unet", _Holder(_meta_copy(unet, state["sr"])))
        object.__setattr__(self, "_sampler", sampler)
        self._sigma1 = float(sampler.denoiser.schedule.sigma(1.0))
        self.register_buffer("wvs", torch.as_tensor(np.asarray(wvs, np.float32), device=device))

    def forward(self, state: dict, x_lr: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        m = state["latent_norm"]["mean"].reshape(1, -1, 1, 1)
        s = state["latent_norm"]["std"].reshape(1, -1, 1, 1)
        z_lr = _call(self._vae, state["vae"],
                     lambda core, x, w: core.encode_spatial_normalized(x, w), x_lr, self.wvs)
        cond = (z_lr - m) / s
        x1 = eps.float() * self._sigma1
        sampler = self._sampler
        z_hr = _call(self._unet, state["sr"], lambda unet, x, c: sampler(unet, x, c), x1, cond)
        z_hr = z_hr * s + m
        return _call(self._vae, state["vae"],
                     lambda core, z, w: core.decode_spatial_normalized(z, w), z_hr, self.wvs)


def _key(arg):
    if isinstance(arg, (list, tuple)):
        return tuple(_key(a) for a in arg)
    if isinstance(arg, dict):
        return tuple(sorted((k, _key(v)) for k, v in arg.items()))
    return arg


def _pure(node) -> bool:
    """A node whose value depends on its arguments alone: an ATen op that
    mutates nothing, draws nothing and allocates no uninitialised memory, or a
    tuple index."""
    if node.op != "call_function":
        return False
    if node.target is operator.getitem:
        return True
    op = node.target
    return (isinstance(op, torch._ops.OpOverload) and op.namespace == "aten"
            and not op._schema.is_mutable and "empty" not in op.__name__
            and torch.Tag.nondeterministic_seeded not in op.tags)


def _prune(program) -> None:
    """Shrink the graph before it is saved; loading a graph costs time per node.

    Drop the nodes that the export IR keeps for every ``.to(dtype)``: its
    metadata assert, and the cast itself where the dtype does not change (half
    of an fp32 SR graph's nodes). Then merge the pure nodes that repeat with
    the same arguments (common subexpressions): the unrolled sampler casts the
    same weights and embeds the same time MLP at every step."""
    aten = torch.ops.aten
    graph = program.graph
    for node in list(graph.nodes):
        if node.target is aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and node.args[0].meta["val"].dtype == node.meta["val"].dtype):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    # detach_ changes autograd metadata, not data: it does not stop the merge.
    if not any(isinstance(n.target, torch._ops.OpOverload) and n.target._schema.is_mutable
               and n.target is not aten.detach_.default for n in graph.nodes):
        seen = {}
        for node in list(graph.nodes):
            if not _pure(node):
                continue
            key = (node.target, _key(node.args), _key(node.kwargs))
            try:
                hash(key)
            except TypeError:  # an argument that cannot be compared: keep the node
                continue
            if key in seen:
                node.replace_all_uses_with(seen[key])
                graph.erase_node(node)
            else:
                seen[key] = node
    program.graph_module.recompile()


def _export(module: nn.Module, args: tuple, path: str) -> None:
    """``torch.export`` of ``module`` over ``args`` (the state first) with the
    leading dim of every other argument the symbolic batch ``b``, saved to
    ``path``."""
    from torch.export import Dim

    b = Dim("b", min=1)
    state_dims = torch.utils._pytree.tree_map(lambda _: None, args[0])
    program = torch.export.export(
        module, args, dynamic_shapes=(state_dims, *({0: b} for _ in args[1:])))
    _prune(program)
    program.example_inputs = None  # else the file keeps a copy of the state
    torch.export.save(program, path)


def _indexed(device: torch.device) -> torch.device:
    """An unindexed CUDA device as the current card's index (where there is a
    card), so that a mesh's ``cuda:0`` and a loader's ``cuda`` compare equal."""
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _policy_name(policy) -> str:
    if _int8(policy):
        return "int8"
    if policy.conv_algorithm == "winograd":
        return "bf16-winograd"
    return "bf16" if policy.compute_dtype == torch.bfloat16 else "fp32"


def _int8(policy) -> bool:
    return policy.conv_algorithm == "int8"


def calibrate_activations(model, batches, modality: str = "S2L2A",
                          percentile: float = 99.9) -> dict[str, float]:
    """Percentile activation calibration for the int8 export.

    Runs representative batches (NCHW fp32, physical-norm units) through an
    ``INT8_CALIB_POLICY`` twin of ``model`` (its ``reconstruct``) and returns
    ``{conv module path: amax}``, the static ranges that
    ``export_model(act_scales=...)`` stores: for each eligible conv, the largest
    |input| ``percentile`` over batches and calls. A few batches suffice: the
    scale needs the bulk |activation| range, not dataset statistics.
    """
    import dataclasses

    from eovax_torch.core.precision import INT8_CALIB_POLICY
    from eovax_torch.data.wavelengths import WAVELENGTHS
    from eovax_torch.kernels.qconv import act_scales_from_calibration
    from eovax_torch.models.backbone import EOVAECore
    from eovax_torch.nn.blocks import Conv3x3

    policy = dataclasses.replace(INT8_CALIB_POLICY, calib_percentile=percentile)
    twin = EOVAECore(model.config.encoder, model.config.decoder, policy)
    twin.load_state_dict(model.core.state_dict(), strict=True)
    twin.to(model.device).eval()
    convs = {name: m for name, m in twin.named_modules() if isinstance(m, Conv3x3)}
    wvs = torch.as_tensor(np.asarray(WAVELENGTHS[modality], np.float32), device=model.device)
    records = []
    with torch.inference_mode():
        for batch in batches:
            for m in convs.values():
                m.calib_amax.clear()
            twin.reconstruct(torch.as_tensor(np.asarray(batch, np.float32),
                                              device=model.device).contiguous(), wvs)
            records.append({name: torch.stack(m.calib_amax).tolist()
                            for name, m in convs.items() if m.calib_amax})
    return act_scales_from_calibration(records)


def export_model(
    model,
    out_dir: str,
    *,
    modalities: tuple[str, ...] = ("S2L2A",),
    resolution: int = 256,
    functions: tuple[str, ...] = tuple(_FUNCTIONS),
    params_dtype: torch.dtype | None = None,
    act_scales: dict | None = None,
) -> dict:
    """Export the inference surface of an ``EOFluxVAE`` to ``out_dir``.

    Writes ``params.pt``, one ``.pt2`` graph per (function, modality) and
    ``manifest.json``; returns the manifest. The graphs are traced on the
    model's device under its policy (the manifest's ``policy``), with the
    batch symbolic: any batch size works at load time.

    ``params_dtype``: optional storage dtype for the float parameters (e.g.
    ``torch.bfloat16`` halves the weights file); the latent BatchNorm's running
    statistics stay fp32, and the graph computes with the stored values as the
    policy does with fp32 ones.

    An int8-policy model has its body-conv weights quantized once here: the
    artifact stores int8 weights and per-channel ``kernel_scale`` tensors (and,
    with ``act_scales`` from :func:`calibrate_activations`, static ``act_scale``
    tensors), so serving quantizes no weight per call.
    """
    from eovax_torch.data.wavelengths import WAVELENGTHS
    from eovax_torch.kernels.qconv import quantize_state_int8

    unknown = set(functions) - set(_FUNCTIONS)
    if unknown:
        raise ValueError(f"unknown functions {sorted(unknown)}; choose from {list(_FUNCTIONS)}")
    if act_scales and not _int8(model.policy):
        raise ValueError("act_scales requires an int8-policy model")
    os.makedirs(out_dir, exist_ok=True)
    core = model.core
    state, quantized = core.state_dict(), 0
    if _int8(model.policy):
        state, quantized = quantize_state_int8(state, act_scales)
    if params_dtype is not None:
        state = _cast_float_params(state, {k for k, _ in core.named_parameters()}, params_dtype)
    torch.save(state, os.path.join(out_dir, _PARAMS))

    z_ch = model.config.encoder.z_channels
    factor = 2 ** (len(model.config.encoder.ch_mult) - 1)  # downsample levels
    latent_hw = resolution // factor
    device = model.device
    manifest: dict[str, Any] = {
        "format": FORMAT,
        "resolution": resolution,
        "params": _PARAMS,
        "policy": _policy_name(model.policy),
        "params_dtype": str(params_dtype or torch.float32).removeprefix("torch."),
        "device": str(device),
        "functions": {},
    }
    if quantized:
        manifest["quantization"] = _quant_manifest(quantized, act_scales)
    for modality in modalities:
        wvs = WAVELENGTHS[modality]
        for name in functions:
            method, latent_input = _FUNCTIONS[name]
            per_sample = ((z_ch, latent_hw, latent_hw) if latent_input
                          else (len(wvs), resolution, resolution))
            x = torch.zeros((2, *per_sample), device=device)
            fname = f"{name}.{modality}.pt2"
            _export(_Surface(core, state, method, wvs, device), (state, x),
                    os.path.join(out_dir, fname))
            manifest["functions"][f"{name}.{modality}"] = {
                "file": fname,
                "modality": modality,
                "input_shape": ["b", *per_sample],
                "dtype": "float32",
            }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def export_sr_pipeline(
    model,
    denoiser,
    unet: nn.Module,
    out_dir: str,
    *,
    resolution: int = 128,
    steps: int = 50,
    sampler: str = "ddim",
    wvs=None,
    latent_stats: tuple | None = None,
    params_dtype: torch.dtype | None = None,
    denoiser_policy=None,
) -> dict:
    """Export the stage-3 pipeline — encode → ``steps``-step sampler → decode —
    as one graph ``(state, x_lr, eps) → y`` with a symbolic batch.

    ``params.pt`` holds ``{"vae": <model state>, "sr": <unet state>,
    "latent_norm": {"mean", "std"}}``. A graph cannot hold a
    ``torch.Generator``, so the function takes ``eps`` ~ N(0, 1) of the
    latent's shape and starts the sampler from x1 = σ(1)·eps, as the samplers'
    ``init`` does. :meth:`ServedModel.super_resolve` draws row i of eps from a
    generator seeded with ``seed[i]``: row i of a batched call is the B = 1 call
    with ``seed[i]``, the per-sample seed contract of the manifest's
    ``extra_args: ["seed:int32[b]"]``. The sampler's loop is unrolled into the
    graph (``steps`` UNet evals).

    ``latent_stats``: optional (mean[C], std[C]) per latent channel (the
    Sen2NAIP HR statistics); identity when omitted. ``params_dtype``: as in
    :func:`export_model`, for both networks; ``latent_norm`` stays fp32.

    ``denoiser_policy`` is required when ``model.policy`` is int8: the policy
    the UNet was built with, which must be int8 too. Both networks' body convs
    (the VAE's ResnetBlocks, the UNet's TimeResBlocks) are then quantized once,
    with dynamic activation ranges.
    """
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.kernels.qconv import quantize_state_int8
    from eovax_torch.models.sr_diffusion import make_sampler

    if _int8(model.policy) and getattr(denoiser_policy, "conv_algorithm", None) != "int8":
        raise ValueError(
            "int8 SR export: the denoiser must have been built with the same int8 "
            "policy, and denoiser_policy=<that policy> must be passed to confirm it: "
            "quantized UNet weights under any other policy would not take the int8 conv. "
            "cli/export builds the denoiser with policy=model.policy and forwards it.")
    sampler_obj = make_sampler(sampler, denoiser, steps=steps)  # a bad name fails first
    os.makedirs(out_dir, exist_ok=True)
    z_ch = model.config.encoder.z_channels
    factor = 2 ** (len(model.config.encoder.ch_mult) - 1)
    latent_hw = resolution // factor
    wvs_arr = np.asarray(SEN2NAIP_WVS if wvs is None else wvs, np.float32).reshape(-1)
    device = model.device
    if latent_stats is None:
        mean, std = torch.zeros(z_ch), torch.ones(z_ch)
    else:
        mean, std = (torch.as_tensor(np.asarray(v, np.float32).reshape(-1))
                     for v in latent_stats)

    vae_state, sr_state = model.core.state_dict(), unet.state_dict()
    quantized = 0
    if _int8(model.policy):
        (vae_state, n_vae), (sr_state, n_sr) = (quantize_state_int8(vae_state),
                                                quantize_state_int8(sr_state))
        quantized = n_vae + n_sr
    if params_dtype is not None:
        vae_state = _cast_float_params(
            vae_state, {k for k, _ in model.core.named_parameters()}, params_dtype)
        sr_state = _cast_float_params(sr_state, {k for k, _ in unet.named_parameters()},
                                      params_dtype)
    state = {"vae": vae_state, "sr": sr_state,
             "latent_norm": {"mean": mean.to(device), "std": std.to(device)}}
    torch.save(state, os.path.join(out_dir, _PARAMS))

    in_shape = (len(wvs_arr), resolution, resolution)
    latent_shape = (z_ch, latent_hw, latent_hw)
    fname = "super_resolve.pt2"
    _export(_SRPipeline(model.core, unet, state, sampler_obj, wvs_arr, device),
            (state, torch.zeros((2, *in_shape), device=device),
             torch.zeros((2, *latent_shape), device=device)),
            os.path.join(out_dir, fname))
    manifest = {
        "format": FORMAT,
        "resolution": resolution,
        "params": _PARAMS,
        "policy": _policy_name(model.policy),
        "params_dtype": str(params_dtype or torch.float32).removeprefix("torch."),
        "device": str(device),
        "pipeline": "sr",
        "sampler": sampler,
        "steps": steps,
        "ddim_steps": steps,  # the JAX manifest's alias; prefer "steps"
        "wvs": [float(v) for v in wvs_arr],
        "latent_shape": list(latent_shape),
        "functions": {
            "super_resolve": {
                "file": fname,
                "modality": "SEN2NAIP",
                "input_shape": ["b", *in_shape],
                "dtype": "float32",
                "extra_args": ["seed:int32[b]"],
            }
        },
    }
    if quantized:
        manifest["quantization"] = _quant_manifest(quantized)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServedModel:
    """Runs an exported artifact: the graphs and the weights, without the model
    code (the hand kernels' custom ops are registered by importing this module).
    Graphs load lazily on first use, onto the device the loader was given.
    Several cards: :meth:`with_mesh`."""

    #: modality the convenience methods default to when the caller passes
    #: none — the flagship 12-band Sentinel-2 L2A surface. The HTTP layer
    #: resolves its per-request default from this same constant so API and
    #: daemon behavior can't drift.
    DEFAULT_MODALITY = "S2L2A"

    def __init__(self, out_dir: str, manifest: dict, state: Any, device: torch.device,
                 programs: dict | None = None):
        self._dir = out_dir
        self._manifest = manifest
        self._state = state
        self.device = device
        self._fns: dict[str, Any] = {}
        #: the programs as loaded from disk, shared by a mesh's models on other
        #: devices than the loaded one's (None: this model loads its own)
        self._programs = programs

    def with_mesh(self, mesh) -> "MeshServedModel":
        """Data-parallel serving view over a 1-D
        :class:`~eovax_torch.parallel.mesh.DeviceMesh` (any axis name: the batch
        splits over its single axis). This model serves its own device's share;
        every other distinct device of the mesh gets a copy of the weights and
        graphs moved there from programs loaded from disk once for all of them."""
        if len(mesh.axis_names) != 1:
            raise ValueError(f"with_mesh expects a 1-D mesh, got {mesh.axis_names}")
        quant = self._manifest.get("quantization") or {}
        if mesh.size > 1 and quant.get("activations") == "dynamic-per-tensor-absmax":
            raise ValueError(
                "with_mesh: this int8 artifact takes its activation ranges dynamically, "
                "over the whole batch it is called on; split over the mesh, each device "
                "would take its own range over its rows and give another result (the JAX "
                "package's mesh reduces the range across the sharded batch). Export a "
                "calibrated artifact (export --precision int8 --calibrate-npz ...), whose "
                "static ranges split exactly.")
        programs: dict[str, Any] = {}
        models = {}
        for dev in mesh.devices:
            if dev not in models:
                models[dev] = self if dev == self.device else ServedModel(
                    self._dir, self._manifest,
                    torch.utils._pytree.tree_map(lambda t: t.to(dev), self._state), dev,
                    programs=programs)
        return MeshServedModel(mesh, models)

    @classmethod
    def load(cls, out_dir: str, device: str | torch.device | None = None) -> "ServedModel":
        """Load the artifact onto ``device`` (CUDA unless the caller asks for
        another; raises without a card)."""
        import eovax_torch.kernels.attention  # noqa: F401  (registers the eovax:: ops)
        import eovax_torch.kernels.conv3x3  # noqa: F401
        import eovax_torch.kernels.groupnorm  # noqa: F401
        import eovax_torch.kernels.qconv  # noqa: F401
        from eovax_torch.core.device import resolve_device

        device = _indexed(resolve_device(device))
        with open(os.path.join(out_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{out_dir}: format {manifest.get('format')!r} is not {FORMAT!r} "
                             "(artifacts of the JAX package do not load here)")
        state = torch.load(os.path.join(out_dir, manifest["params"]), map_location=device,
                           weights_only=True)
        return cls(out_dir, manifest, state, device)

    @property
    def modalities(self) -> list[str]:
        return sorted({v["modality"] for v in self._manifest["functions"].values()})

    def _entry(self, name: str, modality: str | None) -> tuple[str, dict]:
        """(manifest key, manifest entry) for a function — THE lookup and
        THE KeyError. input_shape (pre-dispatch validation) and _fn (the
        dispatch) must raise byte-identical messages or the daemon's 404
        bodies desynchronize between the two paths."""
        key = name if modality is None else f"{name}.{modality}"
        entry = self._manifest["functions"].get(key)
        if entry is None:
            raise KeyError(
                f"{key!r} not in artifact (have {sorted(self._manifest['functions'])})"
            )
        return key, entry

    def _fn(self, name: str, modality: str | None = None):
        key, entry = self._entry(name, modality)
        if key not in self._fns:
            shared = self._programs is not None
            program = self._programs.get(key) if shared else None
            if program is None:
                program = torch.export.load(os.path.join(self._dir, entry["file"]))
                if shared:
                    self._programs[key] = program
            if _indexed(torch.device(self._manifest["device"])) != self.device:
                from torch.export.passes import move_to_device_pass

                # The pass moves in place: a program that other devices share
                # is copied first.
                program = move_to_device_pass(copy.deepcopy(program) if shared else program,
                                              self.device)
            self._fns[key] = program.module()
        return self._fns[key]

    def input_shape(self, name: str, modality: str | None = None) -> tuple:
        """Per-sample input shape (batch dim excluded) the artifact expects
        for ``name`` — the manifest's ``input_shape`` with the symbolic "b"
        stripped. Raises ``KeyError`` for a function/modality not in this
        artifact (same error the call itself would raise, but before any
        payload is staged). The serving daemon uses this to reject
        wrong-shape payloads as 400s instead of letting them surface as
        device-call failures."""
        _, entry = self._entry(name, modality)
        return tuple(int(d) for d in entry["input_shape"][1:])

    def _call(self, name: str, x, modality: str | None, *extra) -> torch.Tensor:
        """The graph of ``name`` on the payload ``x`` and the device tensors
        ``extra``."""
        fn = self._fn(name, modality)
        with torch.inference_mode():
            return fn(self._state, _host(x).to(self.device).contiguous(), *extra)

    def reconstruct(self, x, modality: str = DEFAULT_MODALITY) -> torch.Tensor:
        return self._call("reconstruct", x, modality)

    def encode_spatial_normalized(self, x, modality: str = DEFAULT_MODALITY) -> torch.Tensor:
        return self._call("encode_spatial_normalized", x, modality)

    def decode_spatial_normalized(self, z, modality: str = DEFAULT_MODALITY) -> torch.Tensor:
        return self._call("decode_spatial_normalized", z, modality)

    def per_sample_seed(self, name: str = "super_resolve") -> bool:
        """True when ``name`` takes a per-sample int32 seed VECTOR
        (``extra_args: ["seed:int32[b]"]``, what this package writes) rather
        than one scalar baked into the whole batch. Per-sample seeds are
        what make the function safe to micro-batch: coalescing cannot
        change any request's noise draw. False for functions without a
        seed arg."""
        entry = self._manifest["functions"].get(name)
        return entry is not None and "seed:int32[b]" in entry.get("extra_args", ())

    def batchable(self, name: str) -> bool:
        """May the serving daemon coalesce concurrent ``name`` requests
        into one device call? Static rule (batching.NON_BATCHABLE)
        relaxed by the artifact capability: a per-sample-seed
        super_resolve batches safely."""
        from eovax_torch.serving.batching import NON_BATCHABLE

        return name not in NON_BATCHABLE or self.per_sample_seed(name)

    def noise(self, seeds) -> torch.Tensor:
        """eps [B, *latent_shape] on the device: row i ~ N(0, 1) from a generator
        seeded with ``seeds[i]`` (its uint32 view), drawn at shape (1, …), so
        that a row does not depend on the batch it is in."""
        shape = (1, *self._manifest["latent_shape"])
        rows = [torch.randn(shape, generator=torch.Generator(self.device).manual_seed(
            int(s) & 0xFFFFFFFF), device=self.device) for s in np.asarray(seeds).reshape(-1)]
        return torch.cat(rows)

    def super_resolve(self, x, seed=0) -> torch.Tensor:
        """Run an exported SR-pipeline artifact (encode → sampler → decode;
        :func:`export_sr_pipeline`). ``seed`` pins the x1 noise draw:
        an int is expanded to :func:`per_sample_seeds` (sample ``i`` ≡
        the B=1 call with ``seed+i``); a length-B int sequence pins each
        sample's draw directly."""
        self._entry("super_resolve", None)  # the KeyError of an artifact without it
        if not self.per_sample_seed():
            raise ValueError("this artifact's super_resolve takes no per-sample seed vector "
                             "(manifest extra_args lacks 'seed:int32[b]')")
        n = len(x)
        seeds = (per_sample_seeds(int(seed), n) if np.ndim(seed) == 0
                 else np.asarray(seed, np.int64).reshape(-1))
        if seeds.shape[0] != n:
            raise ValueError(
                f"need one seed per sample: got {seeds.shape[0]} "
                f"seeds for batch {n}")
        with torch.inference_mode():
            # Over a mesh the noise splits with the rows: row i's is the B = 1
            # call's with seed[i], on whichever device the row runs.
            return self._call("super_resolve", x, None, self.noise(seeds))


def _host(x) -> torch.Tensor:
    """A payload as a fp32 tensor where it is (numpy on the host)."""
    with warnings.catch_warnings():  # a daemon's payload is a read-only view: never written
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.as_tensor(x, dtype=torch.float32)


class MeshServedModel(ServedModel):
    """:meth:`ServedModel.with_mesh`'s view: data-parallel serving over the
    mesh's devices, one single-device :class:`ServedModel` each (``models``).
    A batch that the device count divides is split into equal row blocks, one
    a device, issued from this thread without a host sync between the devices,
    and gathered on the mesh's first device: a row's result is the
    single-device call's on its block. A batch that the count does not divide
    runs whole on the first device (the result of the JAX package's replicated
    branch). Everything else is the first device's model's."""

    def __init__(self, mesh, models: dict):
        first = models[mesh.devices[0]]
        super().__init__(first._dir, first._manifest, first._state, first.device,
                         first._programs)
        self._fns = first._fns
        self._mesh = mesh
        self._models = models

    def with_mesh(self, mesh) -> "MeshServedModel":
        return self._models[self.device].with_mesh(mesh)

    def _call(self, name: str, x, modality: str | None, *extra) -> torch.Tensor:
        n, size = len(x), self._mesh.size
        if size == 1 or n % size:
            return super()._call(name, x, modality, *extra)
        rows = n // size
        args = (_host(x), *extra)
        # Every block's input is copied and every call issued before any result
        # is gathered.
        blocks = [(self._models[dev], [a[i * rows:(i + 1) * rows].to(dev) for a in args])
                  for i, dev in enumerate(self._mesh.devices)]
        outs = [m._call(name, xb, modality, *eb) for m, (xb, *eb) in blocks]
        return torch.cat([y.to(self.device) for y in outs])
