"""Diffusion machinery for latent super-resolution: schedules, denoisers, samplers.

Port of ``eovax/models/sr_diffusion.py``. Continuous time t ∈ [0, 1]; a
schedule defines x_t = alpha(t)·x + sigma(t)·eps; a denoiser predicts
E[x | x_t] from a backbone (the port's :class:`eovax_torch.models.unet.UNet`).
The JAX package passes a params tree beside the backbone's function; here the
backbone ``model`` is an ``nn.Module`` that holds its parameters, and takes
that tree's place in every call (``denoise(model, x_t, t, cond)``,
``sampler(model, x1, cond)``). Tensors are NCHW, as the UNet's.

Each ``lax.scan`` of the JAX samplers is a Python loop over the steps, each
``lax.cond`` an ``if`` on the step index. The time grid (:func:`time_grid`),
λ and the clamps (tiny 1e-20, σ ≥ 1e-8) are fp32 tensors on the samples'
device, computed as the JAX package computes them. ``init``
draws x1 from an explicit ``torch.Generator``, and the denoisers' ``loss``
draws its noise from one too, unless the caller passes ``eps`` (the value the
JAX loss draws from its key).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from eovax_torch.parallel.mesh import global_rows

# ---------------------------------------------------------------------------
# Noise schedules
# ---------------------------------------------------------------------------


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


class RectifiedSchedule:
    """Rectified flow / linear interpolation: alpha = 1 − t, sigma = t."""

    def alpha(self, t) -> torch.Tensor:
        return 1.0 - _f32(t)

    def sigma(self, t) -> torch.Tensor:
        return _f32(t)


class VPSchedule:
    """Variance-preserving: alpha = cos(π t / 2), sigma = sin(π t / 2)."""

    def alpha(self, t) -> torch.Tensor:
        return torch.cos(0.5 * math.pi * _f32(t))

    def sigma(self, t) -> torch.Tensor:
        return torch.sin(0.5 * math.pi * _f32(t))


@dataclasses.dataclass(frozen=True)
class DecaySchedule:
    """Variance-exploding: alpha = 1, sigma(t) = sigma_min^(1−t) · sigma_max^t."""

    sigma_min: float = 1e-3
    sigma_max: float = 80.0

    def alpha(self, t) -> torch.Tensor:
        return torch.ones_like(_f32(t))

    def sigma(self, t) -> torch.Tensor:
        t = _f32(t)
        return self.sigma_min ** (1.0 - t) * self.sigma_max ** t


# ---------------------------------------------------------------------------
# Denoisers
# ---------------------------------------------------------------------------


def _bshape(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-sample scalar over image dims."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - 1)))


def _noised(schedule, x, t, eps, generator):
    """x_t = alpha(t)·x + sigma(t)·eps in fp32, eps ~ N(0, 1) from ``generator``
    unless given (drawn at the global batch's shape under a process group)."""
    if eps is None:  # over the global batch, each rank keeping its rows
        device = x.device if generator is None else generator.device
        eps = global_rows(lambda shape: torch.randn(shape, generator=generator, device=device,
                                                    dtype=torch.float32), x.shape)
    a = _bshape(schedule.alpha(t), x)
    s = _bshape(schedule.sigma(t), x)
    return a * x + s * eps


@dataclasses.dataclass(frozen=True)
class SimpleDenoiser:
    """x0-prediction denoiser: model(x_t, t, cond) → E[x | x_t]."""

    schedule: Any = dataclasses.field(default_factory=RectifiedSchedule)

    def denoise(self, model, x_t, t, cond=None):
        return model(x_t, t, cond)

    def postprocess(self, model, raw, x_t, t):
        """Raw backbone output → x0_hat (identity for x0-prediction); used by
        samplers that run the backbone's paths themselves."""
        return raw.float()

    def loss(self, model, x, t, cond=None, *, eps=None, generator=None) -> torch.Tensor:
        """fp32 MSE of the x0 prediction from x_t = alpha(t)·x + sigma(t)·eps."""
        x_t = _noised(self.schedule, x, t, eps, generator)
        x0_hat = self.denoise(model, x_t, t, cond)
        return torch.mean((x0_hat.float() - x.float()) ** 2)


@dataclasses.dataclass(frozen=True)
class KarrasDenoiser:
    """EDM-preconditioned denoiser (Karras et al. 2022):
    x0_hat = c_skip·x_t + c_out·model(c_in·x_t, t, cond)."""

    schedule: Any = dataclasses.field(default_factory=VPSchedule)
    sigma_data: float = 1.0

    def _coeffs(self, t):
        a = self.schedule.alpha(t)
        s = self.schedule.sigma(t)
        sig = s / torch.clamp_min(a, 1e-4)  # the EDM sigma domain (guard a → 0)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sig ** 2 + sd2)
        c_out = sig * self.sigma_data / torch.sqrt(sig ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sig ** 2 + sd2)
        return c_skip, c_out, c_in

    def denoise(self, model, x_t, t, cond=None):
        a = _bshape(self.schedule.alpha(t), x_t)
        x_hat = x_t / torch.clamp_min(a, 1e-4)  # rescale to the x + sig·eps domain
        c_skip, c_out, c_in = (_bshape(c, x_t) for c in self._coeffs(t))
        f = model((c_in * x_hat).to(x_t.dtype), t, cond)
        return c_skip * x_hat + c_out * f.float()

    def loss(self, model, x, t, cond=None, *, eps=None, generator=None) -> torch.Tensor:
        """fp32 MSE of the x0 prediction weighted by 1/max(c_out², 1e-8)."""
        x_t = _noised(self.schedule, x, t, eps, generator)
        x0_hat = self.denoise(model, x_t, t, cond)
        c_out = _bshape(self._coeffs(t)[1], x)
        w = 1.0 / torch.clamp_min(c_out ** 2, 1e-8)
        return torch.mean(w * (x0_hat - x.float()) ** 2)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def time_grid(steps: int, device=None) -> torch.Tensor:
    """fp32 1 = t_0 > … > t_N = 0, the values ``jnp.linspace(1, 0, N + 1)`` gives
    under XLA, which takes its i/N as i·(1/N): 1 − i·(1/N), then the end point."""
    inv = torch.tensor(1.0, dtype=torch.float32) / steps
    i = torch.arange(steps, dtype=torch.float32)
    return torch.cat([1.0 - i * inv, torch.zeros(1)]).to(device)


def _init(denoiser, generator: torch.Generator, shape) -> torch.Tensor:
    """x_1 ~ N(0, sigma(1)²) on the generator's device: pure noise under each schedule."""
    s1 = denoiser.schedule.sigma(1.0)
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return x * s1.to(x.device)


def _ddim_update(sched, x_t, x0_hat, t, s):
    """x_s = alpha_s · x0_hat + (sigma_s / sigma_t) · (x_t − alpha_t · x0_hat)."""
    a_t = _bshape(sched.alpha(t), x_t)
    a_s = _bshape(sched.alpha(s), x_t)
    s_t = _bshape(torch.clamp_min(sched.sigma(t), 1e-8), x_t)
    s_s = _bshape(sched.sigma(s), x_t)
    return a_s * x0_hat + (s_s / s_t) * (x_t - a_t * x0_hat)


@dataclasses.dataclass(frozen=True)
class DDIMSampler:
    """Deterministic DDIM over the denoiser's schedule on a uniform time grid."""

    denoiser: Any
    steps: int = 50

    def init(self, generator: torch.Generator, shape) -> torch.Tensor:
        return _init(self.denoiser, generator, shape)

    def __call__(self, model, x1: torch.Tensor, cond=None) -> torch.Tensor:
        sched = self.denoiser.schedule
        x_t = x1.float()
        ts = time_grid(self.steps, x_t.device)
        b = x_t.shape[0]
        for i in range(self.steps):
            t, s = ts[i].expand(b), ts[i + 1].expand(b)
            x0_hat = self.denoiser.denoise(model, x_t, t, cond).float()
            x_t = _ddim_update(sched, x_t, x0_hat, t, s)
        return x_t


@dataclasses.dataclass(frozen=True)
class DPMSolverPlusPlus2M:
    """DPM-Solver++(2M) (Lu et al. 2022, Algorithm 2): second-order multistep in
    the x0 parameterization, one denoiser eval per step; on the uniform grid,
    with λ_t = log(α_t / σ_t):

        h_i = λ_{t_i} − λ_{t_{i−1}},  r_i = h_{i−1} / h_i
        D_i = (1 + 1/(2 r_i)) · x0_i − 1/(2 r_i) · x0_{i−1}
        x_{t_i} = (σ_{t_i}/σ_{t_{i−1}}) · x_{t_{i−1}} − α_{t_i}·expm1(−h_i)·D_i

    The first and the last step are first order (D = x0): the clamps inside the
    log make |h| huge at the end points, where expm1(−h) = −1 is the limit.
    """

    denoiser: Any
    steps: int = 20

    def init(self, generator: torch.Generator, shape) -> torch.Tensor:
        return _init(self.denoiser, generator, shape)

    def __call__(self, model, x1: torch.Tensor, cond=None) -> torch.Tensor:
        sched = self.denoiser.schedule
        x_t = x1.float()
        ts = time_grid(self.steps, x_t.device)
        tiny = 1e-20
        lam = (torch.log(torch.clamp_min(sched.alpha(ts), tiny))
               - torch.log(torch.clamp_min(sched.sigma(ts), tiny)))
        x0_prev = torch.zeros_like(x_t)
        for i in range(self.steps):
            t = ts[i].expand(x_t.shape[0])
            x0 = self.denoiser.denoise(model, x_t, t, cond).float()
            h = lam[i + 1] - lam[i]
            if i == 0 or i == self.steps - 1:
                c = torch.zeros_like(h)
            else:
                r = (lam[i] - lam[i - 1]) / h
                c = 1.0 / (2.0 * torch.clamp_min(r, 1e-8))
            d = (1.0 + c) * x0 - c * x0_prev
            s_t = torch.clamp_min(sched.sigma(ts[i]), 1e-8)
            s_s = sched.sigma(ts[i + 1])
            a_s = sched.alpha(ts[i + 1])
            x_t = (s_s / s_t) * x_t - a_s * torch.expm1(-h) * d
            x0_prev = x0
        return x_t


#: accepted spellings → sampler class (config ``_target_`` names included).
_SAMPLERS = {
    "ddim": lambda den, steps: DDIMSampler(den, steps=steps),
    "ddimsampler": lambda den, steps: DDIMSampler(den, steps=steps),
    "dpm++2m": lambda den, steps: DPMSolverPlusPlus2M(den, steps=steps),
    "dpmsolverplusplus2m": lambda den, steps: DPMSolverPlusPlus2M(den, steps=steps),
}


def make_sampler(name: str, denoiser, *, steps: int):
    """Sampler by name ("ddim" | "dpm++2m", any case, config ``_target_`` spellings too)."""
    try:
        return _SAMPLERS[name.lower()](denoiser, steps)
    except KeyError:
        raise ValueError(
            f"Unknown sampler {name!r}; choose from {sorted(_SAMPLERS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class CachedDDIMSampler:
    """DDIM with the UNet's encoder features cached across timesteps
    ("encoder propagation", Li et al., arXiv:2312.09608): every
    ``cache_every``-th step (the key steps, step 0 first) runs the whole UNet
    and keeps its (bottleneck, skips); the other steps run only
    ``model.decode_path`` on the kept features with a fresh time embedding. An
    approximation of :class:`DDIMSampler`, for x0-prediction denoisers only.
    """

    denoiser: Any
    steps: int = 50
    cache_every: int = 2

    def init(self, generator: torch.Generator, shape) -> torch.Tensor:
        return _init(self.denoiser, generator, shape)

    def __call__(self, model, x1: torch.Tensor, cond=None) -> torch.Tensor:
        if not hasattr(self.denoiser, "postprocess"):
            # The Karras preconditioning scales the UNet's input; the cache
            # feeds raw x_t and only combines afterwards.
            raise TypeError(
                f"CachedDDIMSampler requires an x0-prediction denoiser "
                f"exposing .postprocess (e.g. SimpleDenoiser); got "
                f"{type(self.denoiser).__name__}. Use the exact "
                f"DDIMSampler for preconditioned (Karras) denoisers."
            )
        sched = self.denoiser.schedule
        x_t = x1.float()
        ts = time_grid(self.steps, x_t.device)
        b = x_t.shape[0]
        cache = None
        for i in range(self.steps):
            t, s = ts[i].expand(b), ts[i + 1].expand(b)
            if i % self.cache_every == 0:
                cache = model.encode_path(x_t, t, cond)
            raw = model.decode_path(*cache, t)
            x0_hat = self.denoiser.postprocess(model, raw, x_t, t)
            x_t = _ddim_update(sched, x_t, x0_hat, t, s)
        return x_t
