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
    (re.compile(r"transformer_encoder\.layers_(\d+)\."), r"transformer_encoder.layers.\1."),
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


def _torch_module_path(path: str) -> str:
    for pat, repl in _REWRITES:
        path = pat.sub(repl, path)
    return path


def state_dict_from_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays → the port's state dict."""
    out: dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.array(arr, np.float32))  # a writable copy

    def walk(tree, path: tuple[str, ...]) -> None:
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        arr = np.asarray(tree, np.float32)
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
