"""EOFluxVAE — the published inference API on PyTorch.

Port of ``eovax/models/eo_flux_vae.py``: ``from_config``, ``from_pretrained``,
``load_checkpoint`` (the JAX package's ``.msgpack`` files as well as the
reference's torch files), ``save``, ``reconstruct``,
``encode_spatial_normalized``, ``decode_spatial_normalized``,
``encode_to_latent``, ``decode_raw``, ``encode``, ``decode`` and
``forward(x, wvs, sample_posterior, scale, angle)``. Tensors cross the API
in the reference's NCHW layout.

The model runs on CUDA unless the caller passes ``device="cpu"``; without a
card, the default raises instead of falling back.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch

from eovax_torch.core.config import VAEConfig, load_model_config
from eovax_torch.core.device import resolve_device
from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.models.backbone import EOVAECore
from eovax_torch.nn.distributions import DiagonalGaussian
from eovax_torch.nn.init import init_parameters
from eovax_torch.utils import flax_msgpack
from eovax_torch.utils.convert import state_dict_from_variables, variables_from_state_dict

_STEM_PREFIXES = {"encoder": "encoder.conv_in", "decoder": "decoder.conv_out"}


def read_checkpoint(path: str) -> dict[str, Any]:
    """A ``.safetensors`` file's tensors, or a torch file's pickled object."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path, device="cpu")
    # Lightning .ckpt files pickle more than tensors: load trusted files only.
    return torch.load(path, map_location="cpu", weights_only=False)


class EOFluxVAE:
    """Multi-sensor EO VAE with wavelength-conditioned dynamic stems.

    ``variables`` is a state dict of the port's module tree (for example
    :func:`eovax_torch.utils.convert.state_dict_from_variables` of a JAX
    variables tree); without it the weights are drawn from ``seed``.
    """

    def __init__(self, config: VAEConfig, variables: Mapping[str, torch.Tensor] | None = None,
                 *, policy: Policy = FULL_PRECISION, device: str | torch.device | None = None,
                 seed: int = 0) -> None:
        self.config = config
        self.policy = policy
        self.device = resolve_device(device)
        policy.activate()
        self.core = EOVAECore(config.encoder, config.decoder, policy)
        if variables is None:
            init_parameters(self.core, torch.Generator().manual_seed(seed))
        else:
            self.core.load_state_dict(variables, strict=True)
        self.core.to(self.device).eval()

    # ----------------------------------------------------------- constructors

    @classmethod
    def from_config(cls, config_path: str, ckpt_path: str | None = None, *,
                    policy: Policy = FULL_PRECISION, device: str | torch.device | None = None,
                    ignore_keys: tuple[str, ...] = (), strict: bool = True,
                    seed: int = 0) -> "EOFluxVAE":
        """Build from a reference-format YAML config and an optional checkpoint."""
        model = cls(load_model_config(config_path), policy=policy, device=device, seed=seed)
        if ckpt_path:
            model.load_checkpoint(ckpt_path, ignore_keys=ignore_keys, strict=strict)
        return model

    @classmethod
    def from_pretrained(cls, repo_id: str, *, ckpt_filename: str = "eo-vae.ckpt",
                        config_filename: str = "model_config.yaml", revision: str | None = None,
                        cache_dir: str | None = None, local_files_only: bool = False,
                        policy: Policy = FULL_PRECISION, ignore_keys: tuple[str, ...] = (),
                        device: str | torch.device | None = None) -> "EOFluxVAE":
        """Download the config and the checkpoint from the Hugging Face Hub and build."""
        try:
            from huggingface_hub import hf_hub_download
        except ImportError as exc:  # pragma: no cover
            raise ImportError("huggingface_hub is required for from_pretrained") from exc

        kw = dict(repo_id=repo_id, revision=revision, cache_dir=cache_dir,
                  local_files_only=local_files_only)
        config_path = hf_hub_download(filename=config_filename, **kw)
        ckpt_path = hf_hub_download(filename=ckpt_filename, **kw)
        return cls.from_config(config_path, ckpt_path, policy=policy, device=device,
                               ignore_keys=ignore_keys)

    # ------------------------------------------------------------- checkpoint

    def load_checkpoint(self, path: str, *, ignore_keys: tuple[str, ...] = (),
                        strict: bool = True) -> None:
        """Load the JAX package's ``.msgpack``/``.eovax`` file (its variables
        tree, through :mod:`eovax_torch.utils.flax_msgpack` and
        :func:`~eovax_torch.utils.convert.state_dict_from_variables`; every
        weight, strictly) or a reference torch checkpoint: a Lightning ``.ckpt``
        (``state_dict``), a stage-1 distilled ``.pt`` (stem state dicts only)
        or a Flux teacher ``.safetensors`` (body only). An orbax checkpoint
        directory is refused: the JAX package's ``eovax.cli.convert_checkpoint``
        turns it into a ``.msgpack`` file.

        With dynamic stems, a full checkpoint's static ``conv_in``/``conv_out``
        (its ``weight`` and ``bias``, where it holds the static ``weight``) are
        skipped, and missing stem weights are expected. Under
        ``strict``, unknown ``encoder.``/``decoder.``/``bn.`` keys and other
        missing parameters raise.
        """
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an orbax checkpoint of the JAX package), which the "
                "port does not read: convert it to .msgpack with `python -m "
                "eovax.cli.convert_checkpoint --config <model yaml> --input <dir> --output "
                "<file>.msgpack` where the JAX package is installed")
        if path.endswith((".msgpack", ".eovax")):
            self.core.load_state_dict(
                state_dict_from_variables(flax_msgpack.read(path)), strict=True)
            return
        raw = read_checkpoint(path)
        dynamic = {"encoder": self.config.encoder.use_dynamic_ops,
                   "decoder": self.config.decoder.use_dynamic_ops}
        stems = {"encoder": "encoder_conv_in_state_dict", "decoder": "decoder_conv_out_state_dict"}
        if any(key in raw for key in stems.values()):
            # Stage-1 distilled checkpoint: only the hypernetwork stems.
            for part, key in stems.items():
                if dynamic[part] and raw.get(key):
                    module = self.core.get_submodule(_STEM_PREFIXES[part])
                    module.load_state_dict(raw[key], strict=strict)
            return

        sd = raw.get("state_dict", raw)
        own = self.core.state_dict()
        allowed_missing = list(ignore_keys)
        load, unknown = {}, []
        for key, value in sd.items():
            if not torch.is_tensor(value) or any(key.startswith(k) for k in ignore_keys):
                continue
            part = key.split(".")[0]
            stem = _STEM_PREFIXES[part] if dynamic.get(part) else None
            if stem and key in (f"{stem}.weight", f"{stem}.bias") and f"{stem}.weight" in sd:
                continue  # static stem of a teacher checkpoint
            if key in own:
                load[key] = value
            elif part in ("encoder", "decoder", "bn"):
                unknown.append(key)
        allowed_missing += [_STEM_PREFIXES[p] for p, on in dynamic.items() if on]
        missing = [
            name for name, _ in self.core.named_parameters()
            if name not in load and not any(name.startswith(a) for a in allowed_missing)
        ]
        if strict and unknown:
            raise ValueError(f"Unconvertible checkpoint keys ({len(unknown)}): {unknown[:10]}")
        if strict and missing:
            raise ValueError(f"Critical weights missing from checkpoint ({len(missing)}): "
                             f"{missing[:10]}")
        self.core.load_state_dict(load, strict=False)

    def save(self, path: str) -> None:
        """Write the weights as the JAX package's ``.msgpack`` variables file."""
        flax_msgpack.write(path, variables_from_state_dict(self.core.state_dict()))

    # ----------------------------------------------------------------- params

    def param_count(self) -> int:
        return sum(p.numel() for p in self.core.parameters())

    def _tensor(self, x) -> torch.Tensor:
        # Contiguous: a transposed view (NHWC batches made NCHW) would otherwise
        # reach the kernels, which take contiguous NCHW only.
        return torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()

    # -------------------------------------------------------------- inference

    @torch.inference_mode()
    def encode(self, x, wvs) -> DiagonalGaussian:
        """Image [B, C, H, W] → posterior over the raw latent (NCHW moments)."""
        return self.core.encode(self._tensor(x), self._tensor(wvs))

    @torch.inference_mode()
    def decode(self, z, wvs) -> torch.Tensor:
        """Normalized packed latent [B, 4z, H/16, W/16] → image [B, C, H, W]."""
        return self.core.decode(self._tensor(z), self._tensor(wvs))

    @torch.inference_mode()
    def decode_raw(self, z, wvs) -> torch.Tensor:
        return self.core.decode_raw(self._tensor(z), self._tensor(wvs))

    @torch.inference_mode()
    def forward(self, x, wvs, sample_posterior: bool = True, scale=None,
                angle: int | None = None, *, seed: int = 0
                ) -> tuple[torch.Tensor, DiagonalGaussian]:
        generator = None
        if sample_posterior:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.core(self._tensor(x), self._tensor(wvs), generator=generator,
                         sample_posterior=sample_posterior, scale=scale, angle=angle)

    @torch.inference_mode()
    def reconstruct(self, x, wvs) -> torch.Tensor:
        """Deterministic round trip through the posterior mode."""
        return self.core.reconstruct(self._tensor(x), self._tensor(wvs))

    @torch.inference_mode()
    def encode_to_latent(self, x, wvs) -> torch.Tensor:
        """Image → normalized packed latent [B, 4z, H/16, W/16]."""
        return self.core.encode_to_latent(self._tensor(x), self._tensor(wvs))

    @torch.inference_mode()
    def encode_spatial_normalized(self, x, wvs) -> torch.Tensor:
        """Image → normalized spatial latent [B, z, H/8, W/8]."""
        return self.core.encode_spatial_normalized(self._tensor(x), self._tensor(wvs))

    @torch.inference_mode()
    def decode_spatial_normalized(self, z, wvs) -> torch.Tensor:
        return self.core.decode_spatial_normalized(self._tensor(z), self._tensor(wvs))
