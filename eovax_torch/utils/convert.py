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
package computes with the same variables. The same rules map the SR UNet's
params (``eovax_torch.models.unet.UNet`` names its modules to match).
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
