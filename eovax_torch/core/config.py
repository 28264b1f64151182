"""Model configuration dataclasses and the reference-format YAML loader.

A copy of the JAX package's ``eovax/core/config.py`` (the port imports
nothing of that package). ``yaml`` is imported inside :func:`load_yaml`, so
building a config from the dataclasses needs no PyYAML.

The published ``model_config.yaml`` format parses unchanged: a ``model:``
section (or the root itself) holding ``encoder``/``decoder`` blocks plus
optional VAE hyperparameters. ``_target_`` keys are checked against a fixed
list. ``${a.b.c}`` interpolation and the ``${eval:...}`` arithmetic resolver
are supported.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")
# PyYAML 1.1 parses '1e-4' (no dot) as a string; OmegaConf, which the
# reference configs were written for, parses it as float. Coerce.
_SCI_FLOAT_RE = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+")

#: Hydra class paths that may appear as ``_target_`` for each section.
KNOWN_TARGETS = {
    "encoder": ("eo_vae.models.Encoder", "eo_vae.models.model.Encoder", "eovax.Encoder"),
    "decoder": ("eo_vae.models.Decoder", "eo_vae.models.model.Decoder", "eovax.Decoder"),
}


def _lookup(root: dict, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _safe_eval(expr: str) -> Any:
    """Evaluate a pure-arithmetic expression (the ``eval`` resolver)."""
    node = ast.parse(expr, mode="eval")
    allowed = (
        ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Add, ast.Sub,
        ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd,
        ast.Tuple, ast.List,
    )
    for sub in ast.walk(node):
        if not isinstance(sub, allowed):
            raise ValueError(f"Unsafe expression in config: {expr!r}")
    result = eval(compile(node, "<config>", "eval"))  # noqa: S307 — AST-validated
    # ${eval:'1 * 2000'} hands the resolver a quoted string literal: unwrap
    # and evaluate once more. Only the quoted-literal case recurses.
    if isinstance(node.body, ast.Constant) and isinstance(result, str):
        return _safe_eval(result)
    return result


def resolve_interpolations(cfg: Any, root: dict | None = None) -> Any:
    """Resolve ``${path.to.key}`` and ``${eval:expr}`` recursively."""
    if root is None:
        root = cfg

    def resolve_value(v: Any) -> Any:
        if isinstance(v, str) and _SCI_FLOAT_RE.fullmatch(v.strip()):
            return float(v)
        if isinstance(v, str):
            # Iterate: inner ${…} tokens resolve first (${eval:${a} * 2}).
            prev = None
            while isinstance(v, str) and "${" in v and v != prev:
                prev = v
                full = _INTERP_RE.fullmatch(v.strip())
                if full:  # whole-string interpolation keeps the native type
                    v = _resolve_token(full.group(1), root)
                else:
                    v = _INTERP_RE.sub(
                        lambda m: str(_resolve_token(m.group(1), root)), v
                    )
            return v
        if isinstance(v, dict):
            return {k: resolve_value(x) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x) for x in v]
        return v

    return resolve_value(cfg)


def _resolve_token(token: str, root: dict) -> Any:
    if token.startswith("eval:"):
        expr = token[len("eval:") :]
        expr = _INTERP_RE.sub(lambda m: str(_resolve_token(m.group(1), root)), expr)
        return _safe_eval(expr)
    value = _lookup(root, token)
    return resolve_interpolations(value, root)


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"Config must deserialize to a dict: {path}")
    return resolve_interpolations(cfg)


@dataclasses.dataclass(frozen=True)
class StemConfig:
    """Hypernetwork stem settings (``dynamic_conv_kwargs`` in the YAML).

    ``mode='basis'`` selects the shared-basis stems
    (``eovax_torch.nn.dynamic_basis``) with ``num_bases`` and ``rank_dim``.
    """

    num_layers: int
    wv_planes: int = 128
    inter_dim: int = 128
    num_heads: int = 4
    generator_type: str = "transformer"
    rank_ratio: int = 4
    use_adain: bool = False
    kernel_size: int = 3
    mode: str = "conv"  # 'conv' (hypernet transformer) | 'basis' (shared bank)
    num_bases: int = 64
    rank_dim: int = 64

    @classmethod
    def from_dict(cls, d: dict | None, default_num_layers: int) -> "StemConfig":
        d = dict(d or {})
        # out_channels in the bases recipe always equals the model ch.
        d.pop("out_channels", None)
        d.setdefault("num_layers", default_num_layers)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 32
    use_dynamic_ops: bool = True
    stem: StemConfig | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "EncoderConfig":
        d = dict(d)
        target = d.pop("_target_", None)
        if target is not None and target not in KNOWN_TARGETS["encoder"]:
            raise ValueError(f"Unknown encoder _target_: {target}")
        stem = None
        if d.get("use_dynamic_ops", False):
            # The reference DynamicConv defaults to num_layers=1.
            stem = StemConfig.from_dict(d.pop("dynamic_conv_kwargs", None), 1)
        else:
            d.pop("dynamic_conv_kwargs", None)
        if "ch_mult" in d:
            d["ch_mult"] = tuple(d["ch_mult"])
        return cls(stem=stem, **d)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    resolution: int = 256
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 32
    use_dynamic_ops: bool = True
    stem: StemConfig | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "DecoderConfig":
        d = dict(d)
        target = d.pop("_target_", None)
        if target is not None and target not in KNOWN_TARGETS["decoder"]:
            raise ValueError(f"Unknown decoder _target_: {target}")
        stem = None
        if d.get("use_dynamic_ops", False):
            # The reference DynamicConv_decoder defaults to num_layers=2.
            stem = StemConfig.from_dict(d.pop("dynamic_conv_kwargs", None), 2)
        else:
            d.pop("dynamic_conv_kwargs", None)
        if "ch_mult" in d:
            d["ch_mult"] = tuple(d["ch_mult"])
        return cls(stem=stem, **d)


#: VAE-level hyperparameter keys of the reference's model section.
VAE_KEYS = {
    "freeze_body",
    "base_lr",
    "final_lr",
    "warmup_epochs",
    "decay_end_epoch",
    "clip_grad",
    "p_prior",
    "p_prior_s",
    "anisotropic",
    "latent_noise_p",
    "noise_tau",
    "image_key",
    "sample_posterior",
}


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    encoder: EncoderConfig
    decoder: DecoderConfig
    freeze_body: bool = False
    base_lr: float = 1e-4
    final_lr: float | None = None
    warmup_epochs: int | None = None
    decay_end_epoch: int | None = None
    clip_grad: float | None = None
    p_prior: float = 0.0
    p_prior_s: float = 0.0
    anisotropic: bool = False
    latent_noise_p: float = 0.0
    noise_tau: float = 0.8
    image_key: str = "image"
    sample_posterior: bool = True

    @classmethod
    def from_dict(cls, config: dict) -> "VAEConfig":
        """Accepts a full train config or a minimal HF model_config
        (a ``model`` section, or the root)."""
        model_cfg = config.get("model", config)
        if not isinstance(model_cfg, dict):
            raise ValueError("Invalid config: `model` section must be a dict")
        if "encoder" not in model_cfg or "decoder" not in model_cfg:
            raise ValueError("Invalid config: expected `encoder` and `decoder` sections")
        vae_kwargs = {k: model_cfg[k] for k in VAE_KEYS if k in model_cfg}
        # FluxAutoencoderKL configs spell the cosine floor `final_lr_sched`.
        if "final_lr" not in vae_kwargs and "final_lr_sched" in model_cfg:
            vae_kwargs["final_lr"] = model_cfg["final_lr_sched"]
        return cls(
            encoder=EncoderConfig.from_dict(model_cfg["encoder"]),
            decoder=DecoderConfig.from_dict(model_cfg["decoder"]),
            **vae_kwargs,
        )


def load_model_config(path: str) -> VAEConfig:
    return VAEConfig.from_dict(load_yaml(path))
