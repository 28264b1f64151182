"""Stage 1 — data-free weight distillation of the hypernetwork stems.

Port of ``eovax/train/distill.py``: train the dynamic ``conv_in``/``conv_out``
generators so that, queried at the RGB wavelengths, they reproduce a
pretrained Flux VAE's static stem weights. The loss lives on weights, not
images: no data at all.

Only ``encoder.conv_in.*`` and ``decoder.conv_out.*`` train, under
``torch.optim.AdamW``, whose arithmetic is optax's ``adamw`` (decoupled decay
on the parameter, eps after the bias correction), on
``cosine_decay_schedule(lr, max_steps, alpha=0.01)``; every other parameter
keeps its bits and has no optimizer state, as under the JAX package's
``set_to_zero`` mask. The run is fp32 with TF32 off: the reference forces
``precision='32-true'`` (weight_distill_train.py:540).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from eovax_torch.core.precision import FULL_PRECISION
from eovax_torch.models.backbone import EOVAECore
from eovax_torch.train.schedule import cosine_decay_schedule
from eovax_torch.train.stage2 import _freeze_mask
from eovax_torch.utils.checkpoint import host_copy

_STEMS = {"encoder_conv_in_state_dict": "encoder.conv_in",
          "decoder_conv_out_state_dict": "decoder.conv_out"}


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Mirrors weight_distill_train.py:43-62."""

    max_steps: int = 5000
    lr: float = 1e-4
    val_every_n_steps: int = 500
    log_every_n_steps: int = 50
    patience: int = 10
    min_delta: float = 1e-7
    rgb_wavelengths: tuple[float, ...] = (0.665, 0.560, 0.490)
    weight_loss_scale: float = 1.0
    bias_loss_scale: float = 1.0
    weight_decay: float = 1e-5  # AdamW (weight_distill_train.py:300)


def load_teacher_stems(path: str) -> dict[str, torch.Tensor]:
    """The static conv_in/conv_out weights of a Flux ``.safetensors`` or a torch
    ``.pt``/``.ckpt`` (weight_distill_train.py:70-137), fp32 on the host, in
    torch's layouts: encoder_weight [E, C, K, K], decoder_weight [C, E, K, K]."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as exc:
            raise ImportError(f"reading {path} needs the safetensors package, which is not "
                              "installed; convert the teacher to a torch .pt file") from exc
        sd = load_file(path, device="cpu")
    else:
        # Lightning .ckpt files pickle more than tensors: load trusted files only.
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
    out = {}
    for name, key in (("encoder_weight", "encoder.conv_in.weight"),
                      ("encoder_bias", "encoder.conv_in.bias"),
                      ("decoder_weight", "decoder.conv_out.weight"),
                      ("decoder_bias", "decoder.conv_out.bias")):
        if key not in sd:
            raise KeyError(f"Teacher checkpoint missing {key} in {path}")
        out[name] = torch.as_tensor(sd[key]).detach().float().cpu()
    return out


def distillation_loss(core: EOVAECore, teacher: dict, cfg: DistillConfig
                      ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MSE between the generated stems (torch layout) and the teacher's
    (weight_distill_train.py:190-264); returns (total, logs). Deterministic:
    the generators run in eval mode (no dropout), as in the JAX package."""
    device = next(core.parameters()).device
    wvs = torch.tensor(cfg.rgb_wavelengths, dtype=torch.float32, device=device)
    logs: dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=device)
    for part, stem in (("enc", core.encoder.conv_in), ("dec", core.decoder.conv_out)):
        prefix = "encoder" if part == "enc" else "decoder"
        sw, sb = stem.get_distillation_weight(wvs)
        tw = teacher[f"{prefix}_weight"].to(device)
        loss_w = torch.mean((sw - tw) ** 2)
        total = total + loss_w * cfg.weight_loss_scale
        logs[f"{part}_weight_loss"] = loss_w
        if teacher.get(f"{prefix}_bias") is not None:
            loss_b = torch.mean((sb - teacher[f"{prefix}_bias"].to(device)) ** 2)
            total = total + loss_b * cfg.bias_loss_scale
            logs[f"{part}_bias_loss"] = loss_b
        logs[f"{part}_weight_mae"] = torch.mean(torch.abs(sw - tw))
        logs[f"{part}_weight_max_err"] = torch.max(torch.abs(sw - tw))
    logs["total_loss"] = total
    return total, logs


def run_distillation(core: EOVAECore, teacher: dict, cfg: DistillConfig = DistillConfig(), *,
                     log_fn=None) -> dict[str, float]:
    """Optimize the dynamic stems of ``core`` in place; returns the last step's logs.

    AdamW(lr, wd) on a cosine decay to 0.01·lr over ``max_steps``
    (weight_distill_train.py:300-311). Early stopping: every
    ``val_every_n_steps`` the step's loss is checked, and ``patience`` checks
    in a row without a fall of more than ``min_delta`` below the best stop
    the run (weight_distill_train.py:52-54)."""
    FULL_PRECISION.activate()
    core.eval()
    mask = _freeze_mask(core, freeze_body=True)
    stems = [p for name, p in core.named_parameters() if mask[name]]
    optimizer, scheduler = make_distill_optimizer(stems, cfg)
    best, bad_vals = float("inf"), 0
    logs: dict[str, torch.Tensor] = {}
    for i in range(cfg.max_steps):
        optimizer.zero_grad(set_to_none=False)
        loss, logs = distillation_loss(core, teacher, cfg)
        logs = {k: v.detach() for k, v in sorted(logs.items())}  # the JAX step's order
        loss.backward()
        optimizer.step()
        scheduler.step()
        if log_fn and (i + 1) % cfg.log_every_n_steps == 0:
            log_fn(i + 1, {k: float(v) for k, v in logs.items()})
        if (i + 1) % cfg.val_every_n_steps == 0:
            val = float(loss)
            if val < best - cfg.min_delta:
                best, bad_vals = val, 0
            else:
                bad_vals += 1
                if bad_vals >= cfg.patience:
                    break
    optimizer.zero_grad()
    return {k: float(v) for k, v in logs.items()}


def make_distill_optimizer(stems: list[torch.nn.Parameter], cfg: DistillConfig):
    """AdamW(wd) on ``cosine_decay_schedule(lr, max_steps, alpha=0.01)``, counted
    from the update count before the step; returns (optimizer, scheduler). The
    schedule gives the rate itself, so the base rate is 1. Every stem starts with
    a zero gradient, so that one the loss does not reach still decays, as under
    optax, whose gradients are never missing."""
    for p in stems:
        p.grad = torch.zeros_like(p)
    optimizer = torch.optim.AdamW(stems, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, cosine_decay_schedule(cfg.lr, cfg.max_steps, alpha=0.01))
    return optimizer, scheduler


def save_distilled_checkpoint(path: str, core: EOVAECore, cfg: DistillConfig,
                              final_loss: float | None = None) -> None:
    """The reference's distilled ``.pt`` (weight_distill_train.py:388-429): the
    two stems' state dicts, the config and the final loss.
    ``EOFluxVAE.load_checkpoint`` reads it too."""
    payload: dict[str, Any] = {key: host_copy(core.get_submodule(module).state_dict())
                               for key, module in _STEMS.items()}
    payload["distill_config"] = dataclasses.asdict(cfg)
    payload["final_loss"] = -1.0 if final_loss is None else float(final_loss)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def load_distilled_checkpoint(path: str, core: EOVAECore) -> dict[str, Any]:
    """Load a distilled checkpoint's stems into ``core`` (strictly); returns its
    config and final loss."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key, module in _STEMS.items():
        core.get_submodule(module).load_state_dict(payload[key], strict=True)
    return {"distill_config": payload["distill_config"], "final_loss": payload["final_loss"]}
