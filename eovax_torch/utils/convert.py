"""JAX-package variables → the port's state dict.

The port's own copy of the rewrite rules of
``eovax/utils/torch_convert.py`` (``export_state_dict``): the flax module
paths (``down_0_block_1``, ``mid_attn_1``, ``layers_0``, ``fc_weight_0``,
``mlp_2``) become torch paths, HWIO conv kernels become OIHW, Dense
``[I, O]`` kernels become Linear ``[O, I]``, the packed ``in_proj`` Dense
becomes ``in_proj_weight``/``in_proj_bias``, norm ``scale`` becomes
``weight``, and the latent BatchNorm's ``mean``/``var`` become
``running_mean``/``running_var``. Feeding the result to
``load_state_dict(strict=True)`` makes the port compute what the JAX
package computes with the same variables. DOFA's ``blocks_N``,
``attn_qkv``/``attn_proj``, ``mlp_fc1``/``mlp_fc2`` and ``head_k_i`` become
the reference's ``blocks.N``, ``attn.qkv``, ``mlp.fc1``, ``heads.k.i``. The
same rules map the SR UNet's params (``eovax_torch.models.unet.UNet`` names
its modules to match), :func:`discriminator_state_dict` a discriminator's,
with its spectral-norm statistics, and :func:`dofa_state_dict` a DOFA tree's.

:func:`variables_from_state_dict` is the inverse: the port's state dict back to
the JAX package's ``{"params", "batch_stats"}`` tree, names and layouts, which
:mod:`eovax_torch.utils.flax_msgpack` writes as a ``.msgpack`` file that the
JAX package loads.

An int8 params tree (the JAX package's ``quantize_params_int8``: an int8 HWIO
``kernel`` with an fp32 ``kernel_scale`` [O] and a scalar ``act_scale`` beside
it) maps to an int8 OIHW ``weight`` with ``kernel_scale``/``act_scale`` tensors,
the state that :func:`eovax_torch.kernels.qconv.quantize_state_int8` writes;
:func:`module_path` maps a JAX module path (an ``act_scales`` key) to the port's.

The shared-basis stems (``eovax_torch.nn.dynamic_basis``) keep the JAX
package's names (``basis_bank`` [num_bases, K, K], ``hypernet.backbone_0`` …
``expansion``, ``wv_proj``, ``bias_generator_0``/``_2``), and the multi-stage
heads' ``transformer.layers_N`` becomes ``transformer.layers.N``. The
reference implementation's own torch names for the basis layers are not
available to check, so no rule maps a reference checkpoint of a basis model.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_REWRITES = [
    (re.compile(r"(^|\.)down_(\d+)_block_(\d+)\."), r"\1down.\2.block.\3."),
    (re.compile(r"(^|\.)down_(\d+)_downsample\."), r"\1down.\2.downsample."),
    (re.compile(r"(^|\.)up_(\d+)_block_(\d+)\."), r"\1up.\2.block.\3."),
    (re.compile(r"(^|\.)up_(\d+)_upsample\."), r"\1up.\2.upsample."),
    (re.compile(r"(^|\.)mid_block_(\d)\."), r"\1mid.block_\2."),
    (re.compile(r"(^|\.)mid_attn_(\d)\."), r"\1mid.attn_\2."),
    (re.compile(r"(transformer_encoder|transformer)\.layers_(\d+)\."), r"\1.layers.\2."),
    (re.compile(r"fc_weight_(\d+)\."), r"fc_weight.\1."),
    (re.compile(r"(^|\.)conditioner\.mlp_(\d+)\."), r"\1conditioner.mlp.\2."),
    # DOFA (``eovax_torch.models.dofa`` keeps the reference torch names): the
    # ViT blocks, their attention and MLP, the discriminator's heads.
    (re.compile(r"(^|\.)blocks_(\d+)\."), r"\1blocks.\2."),
    (re.compile(r"(^|\.)attn_qkv\."), r"\1attn.qkv."),
    (re.compile(r"(^|\.)attn_proj\."), r"\1attn.proj."),
    (re.compile(r"(^|\.)mlp_fc1\."), r"\1mlp.fc1."),
    (re.compile(r"(^|\.)mlp_fc2\."), r"\1mlp.fc2."),
    (re.compile(r"(^|\.)head_(\d+)_(\d+)\."), r"\1heads.\2.\3."),
]


# The inverse of each rule of _REWRITES, for variables_from_state_dict.
_INVERSE = [
    (re.compile(r"(^|\.)down\.(\d+)\.block\.(\d+)\."), r"\1down_\2_block_\3."),
    (re.compile(r"(^|\.)down\.(\d+)\.downsample\."), r"\1down_\2_downsample."),
    (re.compile(r"(^|\.)up\.(\d+)\.block\.(\d+)\."), r"\1up_\2_block_\3."),
    (re.compile(r"(^|\.)up\.(\d+)\.upsample\."), r"\1up_\2_upsample."),
    (re.compile(r"(^|\.)mid\.block_(\d)\."), r"\1mid_block_\2."),
    (re.compile(r"(^|\.)mid\.attn_(\d)\."), r"\1mid_attn_\2."),
    (re.compile(r"(transformer_encoder|transformer)\.layers\.(\d+)\."), r"\1.layers_\2."),
    (re.compile(r"fc_weight\.(\d+)\."), r"fc_weight_\1."),
    (re.compile(r"(^|\.)conditioner\.mlp\.(\d+)\."), r"\1conditioner.mlp_\2."),
    (re.compile(r"(^|\.)blocks\.(\d+)\."), r"\1blocks_\2."),
    (re.compile(r"(^|\.)attn\.qkv\."), r"\1attn_qkv."),
    (re.compile(r"(^|\.)attn\.proj\."), r"\1attn_proj."),
    (re.compile(r"(^|\.)mlp\.fc1\."), r"\1mlp_fc1."),
    (re.compile(r"(^|\.)mlp\.fc2\."), r"\1mlp_fc2."),
    (re.compile(r"(^|\.)heads\.(\d+)\.(\d+)\."), r"\1head_\2_\3."),
]


def _torch_module_path(path: str) -> str:
    for pat, repl in _REWRITES:
        path = pat.sub(repl, path)
    return path


def _flax_module_path(path: str) -> str:
    for pat, repl in _INVERSE:
        path = pat.sub(repl, path)
    return path


def module_path(path: tuple[str, ...]) -> str:
    """A JAX module path (``("encoder", "down_0_block_1", "conv1")``) as the
    port's (``"encoder.down.0.block.1.conv1"``)."""
    return _torch_module_path(".".join(path) + ".")[:-1]


def _float32(leaf) -> np.ndarray:
    """A leaf (numpy array, scalar or tensor, bf16 included) as fp32 numpy."""
    if torch.is_tensor(leaf):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


def _array(leaf) -> np.ndarray:
    """A leaf as numpy: an int8 quantized weight as it is, anything else fp32."""
    if getattr(leaf, "dtype", None) in (np.int8, torch.int8):
        return leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    return _float32(leaf)


def state_dict_from_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays → the port's state dict."""
    out: dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.array(arr))  # a writable copy

    def walk(tree, path: tuple[str, ...]) -> None:
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        arr = _array(tree)
        leaf = path[-1]
        if len(path) >= 2 and path[-2] == "in_proj":  # packed q/k/v projection
            prefix = _torch_module_path(".".join(path[:-2]) + ".")
            put(prefix + ("in_proj_weight" if leaf == "kernel" else "in_proj_bias"),
                arr.T if leaf == "kernel" else arr)
            return
        module = ".".join(path[:-1])
        prefix = _torch_module_path(module + ".") if module else ""
        if leaf == "kernel":
            put(prefix + "weight", arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
        elif leaf == "scale":
            put(prefix + "weight", arr)
        elif leaf == "mean":  # latent BatchNorm statistics
            put(prefix + "running_mean", arr)
        elif leaf == "var":
            put(prefix + "running_var", arr)
            out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        else:  # bias, weight_tokens, bias_token
            put(prefix + leaf, arr)

    walk(variables.get("params", {}), ())
    walk(variables.get("batch_stats", {}), ())
    return out


def variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of :func:`state_dict_from_variables`: the port's state dict →
    the JAX package's ``{"params", "batch_stats"}`` tree of fp32 numpy arrays
    (``num_batches_tracked`` has no counterpart and is dropped). A ``weight`` is
    a conv kernel (OIHW → HWIO) or a Dense kernel ([O, I] → [I, O]) unless it is
    1-D, a norm's ``scale``."""
    tree: dict[str, Any] = {}

    def put(collection: str, module: str, leaf: str, arr: np.ndarray) -> None:
        node = tree.setdefault(collection, {})
        for part in filter(None, module.split(".")):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)

    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        arr = _array(value)
        path = _flax_module_path(module + ".") if module else ""
        if leaf in ("in_proj_weight", "in_proj_bias"):  # packed q/k/v projection
            put("params", path + "in_proj", "kernel" if leaf == "in_proj_weight" else "bias",
                arr.T if leaf == "in_proj_weight" else arr)
        elif leaf == "weight" and arr.ndim == 1:
            put("params", path, "scale", arr)
        elif leaf == "weight":
            put("params", path, "kernel", arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
        elif leaf in ("running_mean", "running_var"):
            put("batch_stats", path, "mean" if leaf == "running_mean" else "var", arr)
        else:
            put("params", path, leaf, arr)
    return tree


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A network's state dict from a file: the JAX package's ``.msgpack``
    variables file (``{"params", ...}``, as its trainers write it) through
    :func:`state_dict_from_variables`, or a torch file holding the state dict
    itself or ``{"state_dict": ...}``."""
    if path.endswith((".msgpack", ".eovax")):
        from eovax_torch.utils import flax_msgpack

        return state_dict_from_variables(flax_msgpack.read(path))
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return raw.get("state_dict", raw)


def discriminator_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX discriminator's ``{"params", "spectral_stats"}`` tree of numpy arrays
    → the port discriminator's state dict (``DynamicPatchGAN`` or
    ``NLayerDiscriminator``): the params by :func:`state_dict_from_variables`'s
    rules under the layer names (``dynamic_input``, ``block_<i>``, ``final``;
    ``conv_in``, ``layer_<i>``, ``final``), and each
    ``SpectralNorm_<i>/<layer>/kernel/{u,sigma}`` as the buffers
    ``<layer>.u`` [1, O] and ``<layer>.sigma`` []."""
    out = state_dict_from_variables({"params": variables.get("params", {})})
    for stats in variables.get("spectral_stats", {}).values():
        for key, arr in stats.items():
            layer, _, name = key.split("/")
            out[f"{layer}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return out


def dofa_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX DOFA ``{"params", ...}`` tree of numpy arrays (``OFAViT``,
    ``DOFAViTv2``, ``DOFAViTv3``, or a ``DOFALPIPS`` / ``DOFADiscriminator`` with
    its ViT under ``dofa``) → the state dict of its counterpart in
    ``eovax_torch.models.dofa``: :func:`state_dict_from_variables`'s rules. v1's
    constant ``pos_embed`` is not a parameter on either side."""
    return state_dict_from_variables(variables)
