"""The port's stage-3 SR sampling path against the JAX package's, in fp32 on the CPU.

A small UNet (``hid_channels`` (32, 16), ``hid_blocks`` (1, 1), 4 latent and
4 condition channels, 16² latents) holds the JAX package's parameter tree with
every leaf drawn from a numpy seed (none is zero, so ``conv2``, ``proj`` and
``conv_out`` are not the zeros the JAX init gives them), loaded into the port
through ``state_dict_from_variables`` with ``strict=True``. Both sides get the
same numpy inputs (NHWC there, NCHW here). The schedules, both denoisers, the
three samplers from one injected x1, ``make_sampler``, the metrics,
``evaluate_sr`` (a stub sampler on a latent tree the test writes) and the eval
CLI on the CPU are held against ``eovax``.

JAX is imported inside the tests that need it, so that the one ``gpu`` case
runs on a machine without JAX:

    python -m pytest tests/test_torch_sr.py -m gpu --noconftest
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

from eovax_torch.models import sr_diffusion as tsr
from eovax_torch.models.unet import UNet, timestep_embedding
from eovax_torch.utils.convert import state_dict_from_variables

# fp32 on both sides through a few convs, norms and the attention, summed in
# other orders.
TOL = dict(rtol=1e-4, atol=1e-4)
UNET_KW = dict(in_channels=4, out_channels=4, cond_channels=4, hid_channels=(32, 16),
               hid_blocks=(1, 1))
B, HW, C = 2, 16, 4


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_params(params, seed: int):
    """Every leaf from a numpy seed: GroupNorm scales 1 + N(0, 0.1), the rest N(0, 0.1)."""
    import jax

    g = np.random.default_rng(seed)

    def draw(path, a):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + g.normal(0.0, 0.1, a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def unets():
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import FULL_PRECISION
    from eovax.models.unet import UNet as JaxUNet

    ju = JaxUNet(**UNET_KW, policy=FULL_PRECISION)
    x = jnp.zeros((1, HW, HW, C))
    params = _random_params(ju.init(jax.random.PRNGKey(0), x, jnp.zeros((1,)), x)["params"], 0)
    tu = UNet(**UNET_KW)
    tu.load_state_dict(state_dict_from_variables({"params": params}), strict=True)
    return ju, params, tu.eval()


def _inputs(seed: int = 1):
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, HW, HW, C)).astype(np.float32),
            np.asarray([0.83, 0.27], np.float32),
            g.standard_normal((B, HW, HW, C)).astype(np.float32))


@pytest.mark.parametrize("dim", [32, 256])
def test_timestep_embedding_matches_jax(dim):
    """XLA's fp32 exp and torch's differ in the last bit for some frequencies,
    and cos/sin pass that on scaled by the argument t·1000·f: so 1e-6 plus
    four fp32 ulps of the largest argument (2^-21 · 1000 t)."""
    import jax.numpy as jnp

    from eovax.models.unet import timestep_embedding as jax_embedding

    t = np.linspace(0.0, 1.0, 41).astype(np.float32)
    ref = np.asarray(jax_embedding(jnp.asarray(t), dim))
    out = timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert out.shape == ref.shape == (41, dim) and out.dtype == np.float32
    np.testing.assert_array_equal(out[0], ref[0])  # t = 0: cos 0, sin 0 exactly
    bound = 1e-6 + 2.0 ** -21 * 1000.0 * t[:, None]
    assert (np.abs(out - ref) <= bound).all(), np.abs(out - ref).max()


def test_converter_loads_the_shipped_unet_strictly():
    """The full-width UNet of configs_superres/eo_vae_latent.yaml: the JAX
    params tree maps onto the port's module tree, shape for shape."""
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import FULL_PRECISION
    from eovax.models.unet import UNet as JaxUNet

    kw = dict(in_channels=32, out_channels=32, cond_channels=32, hid_channels=(256, 128, 64),
              hid_blocks=(3, 3, 3))
    x = jnp.zeros((1, 8, 8, 32))
    shapes = jax.eval_shape(
        lambda: JaxUNet(**kw, policy=FULL_PRECISION).init(jax.random.PRNGKey(0), x,
                                                          jnp.zeros((1,)), x))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_variables({"params": params})
    unet = UNet(**kw)
    unet.load_state_dict(sd, strict=True)
    assert {"mid_attn.qkv.weight", "temb_0.weight", "temb_2.bias",
            "up.0.block.3.skip.weight", "down.1.downsample.weight"} <= set(sd)
    assert sum(p.numel() for p in unet.parameters()) == sum(a.size for a in
                                                            jax.tree_util.tree_leaves(params))


def test_unet_matches_jax(unets):
    ju, params, tu = unets
    x, t, cond = _inputs()
    ref = np.asarray(ju.apply({"params": params}, x, t, cond))
    with torch.no_grad():
        out = tu(_nchw(x), torch.from_numpy(t), _nchw(cond))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


def test_encode_and_decode_paths_match_jax(unets):
    ju, params, tu = unets
    x, t, cond = _inputs(2)
    h_ref, skips_ref = ju.apply({"params": params}, x, t, cond, method=ju.encode_path)
    with torch.no_grad():
        h, skips = tu.encode_path(_nchw(x), torch.from_numpy(t), _nchw(cond))
    np.testing.assert_allclose(_nhwc(h), np.asarray(h_ref), **TOL)
    assert len(skips) == len(skips_ref) == 4  # conv_in, a block, the downsample, a block
    for s, r in zip(skips, skips_ref):
        np.testing.assert_allclose(_nhwc(s), np.asarray(r), **TOL)
    t2 = np.asarray([0.5, 0.1], np.float32)  # the cached sampler's fresh time embedding
    ref = np.asarray(ju.apply({"params": params}, h_ref, skips_ref, t2, method=ju.decode_path))
    with torch.no_grad():
        out = tu.decode_path(h, skips, torch.from_numpy(t2))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


SCHEDULES = ["RectifiedSchedule", "VPSchedule", "DecaySchedule"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_jax(name):
    import jax.numpy as jnp

    from eovax.models import sr_diffusion as jsr

    t = np.linspace(0.0, 1.0, 17).astype(np.float32)
    js, ts = getattr(jsr, name)(), getattr(tsr, name)()
    for fn in ("alpha", "sigma"):
        out = getattr(ts, fn)(torch.from_numpy(t))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(getattr(js, fn)(jnp.asarray(t))),
                                   rtol=1e-6, atol=1e-7)


def _denoisers(name: str, unet_jax):
    from eovax.models import sr_diffusion as jsr

    def apply_fn(params, x_t, t, cond=None):
        return unet_jax.apply({"params": params}, x_t, t, cond)

    cls, schedule = name.split("-")
    return (getattr(jsr, cls)(apply_fn, getattr(jsr, schedule)()),
            getattr(tsr, cls)(getattr(tsr, schedule)()))


DENOISERS = ["SimpleDenoiser-RectifiedSchedule", "KarrasDenoiser-VPSchedule",
             "KarrasDenoiser-DecaySchedule"]


@pytest.mark.parametrize("name", DENOISERS)
def test_denoise_matches_jax(unets, name):
    ju, params, tu = unets
    jd, td = _denoisers(name, ju)
    x, t, cond = _inputs(3)
    ref = np.asarray(jd.denoise(params, x, t, cond))
    with torch.no_grad():
        out = td.denoise(tu, _nchw(x), torch.from_numpy(t), _nchw(cond))
    np.testing.assert_allclose(_nhwc(out.float()), ref, **TOL)


SAMPLERS = ["DDIMSampler", "DPMSolverPlusPlus2M", "CachedDDIMSampler"]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_samplers_match_jax(unets, sampler):
    """4 steps from the same x1 and cond; the cached sampler refreshes its
    features every 2 steps."""
    from eovax.models import sr_diffusion as jsr

    ju, params, tu = unets
    jd, td = _denoisers("SimpleDenoiser-RectifiedSchedule", ju)
    x1, _, cond = _inputs(4)
    if sampler == "CachedDDIMSampler":
        js = jsr.CachedDDIMSampler(jd, ju, steps=4, cache_every=2)
        ts = tsr.CachedDDIMSampler(td, steps=4, cache_every=2)
    else:
        js, ts = getattr(jsr, sampler)(jd, steps=4), getattr(tsr, sampler)(td, steps=4)
    ref = np.asarray(js(params, x1, cond))
    with torch.no_grad():
        out = ts(tu, _nchw(x1), _nchw(cond))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


@pytest.mark.parametrize("steps", [4, 25, 50])
def test_time_grid_is_the_jax_grid(steps):
    import jax.numpy as jnp

    np.testing.assert_array_equal(tsr.time_grid(steps).numpy(),
                                  np.asarray(jnp.linspace(1.0, 0.0, steps + 1)))


def test_make_sampler_names_and_error():
    from eovax.models import sr_diffusion as jsr

    den = tsr.SimpleDenoiser()
    for name, cls in (("ddim", tsr.DDIMSampler), ("DDIMSampler", tsr.DDIMSampler),
                      ("dpm++2m", tsr.DPMSolverPlusPlus2M),
                      ("DPMSolverPlusPlus2M", tsr.DPMSolverPlusPlus2M)):
        sampler = tsr.make_sampler(name, den, steps=7)
        assert type(sampler) is cls and sampler.steps == 7
        assert type(jsr.make_sampler(name, None, steps=7)).__name__ == cls.__name__
    with pytest.raises(ValueError) as got:
        tsr.make_sampler("euler", den, steps=3)
    with pytest.raises(ValueError) as want:
        jsr.make_sampler("euler", None, steps=3)
    assert str(got.value) == str(want.value)


def test_cached_sampler_refuses_a_preconditioned_denoiser(unets):
    _, _, tu = unets
    x = torch.zeros(1, C, HW, HW)
    with pytest.raises(TypeError, match="x0-prediction"):
        tsr.CachedDDIMSampler(tsr.KarrasDenoiser(), steps=2)(tu, x, x)


def test_sampler_init_draws_from_the_generator():
    sampler = tsr.DDIMSampler(tsr.KarrasDenoiser(tsr.DecaySchedule()), steps=2)
    a = sampler.init(torch.Generator().manual_seed(3), (2, 4, 8, 8))
    b = sampler.init(torch.Generator().manual_seed(3), (2, 4, 8, 8))
    ref = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(3)) * 80.0
    assert torch.equal(a, b) and a.dtype == torch.float32
    torch.testing.assert_close(a, ref, rtol=1e-6, atol=0)


METRICS = ["rmse", "mse", "mae", "psnr", "spectral_angle", "ssim"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    import jax.numpy as jnp

    from eovax.utils import metrics as jm
    from eovax_torch.utils import metrics as tm

    g = np.random.default_rng(5)
    target = g.uniform(0.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    pred = np.clip(target + 0.1 * g.standard_normal(target.shape), 0, 1).astype(np.float32)
    ref = float(getattr(jm, name)(jnp.asarray(pred), jnp.asarray(target)))
    out = float(getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# evaluate_sr and the eval CLI, on the tiny VAE of tests/test_torch_cli.py
# ---------------------------------------------------------------------------

Z = 8
_VAE_YAML = {
    "model": {
        part: {"z_channels": Z, "resolution": 32, channels: 4, "ch": 32, "ch_mult": [1, 2],
               "num_res_blocks": 1, "use_dynamic_ops": True,
               "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
        for part, channels in (("encoder", "in_channels"), ("decoder", "out_ch"))
    }
}


def _tiny_vae_config(m):
    stem = m.StemConfig(num_layers=1, wv_planes=64)
    kw = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=Z,
              use_dynamic_ops=True, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(in_channels=4, **kw),
                       decoder=m.DecoderConfig(out_ch=4, **kw))


def _write_latent_tree(root, split: str = "test", n: int = 4, seed: int = 7) -> None:
    """encode_latents' schema: {split}/{aoi}.npz with CHW latents and images,
    and latent_stats.json with per-channel HR and LR statistics. The tiny VAE
    decodes a 16² latent to 32² images, wide enough for SSIM's 11-tap window."""
    g = np.random.default_rng(seed)
    (root / split).mkdir(parents=True)
    for i in range(n):
        np.savez(root / split / f"aoi{i}.npz",
                 hr_latent=g.normal(0.3, 1.5, (Z, 16, 16)).astype(np.float32),
                 lr_latent=g.normal(0.2, 1.2, (Z, 16, 16)).astype(np.float32),
                 hr_image=g.normal(size=(4, 32, 32)).astype(np.float32),
                 lr_image=g.normal(size=(4, 32, 32)).astype(np.float32))
    stats = {k: {"mean": g.normal(size=Z).tolist(), "std": g.uniform(0.5, 2.0, Z).tolist()}
             for k in ("hr_latent", "lr_latent")}
    (root / "latent_stats.json").write_text(json.dumps(stats))


class _StubSampler:
    """``sample`` gives a fixed latent per seed, NHWC for the JAX package and
    NCHW for the port, and checks the shape and cond it is given."""

    def __init__(self, latents: list[np.ndarray], nchw: bool):
        self.latents, self.nchw = latents, nchw

    def sample(self, state, shape, cond, seed=0):
        z = self.latents[seed]
        if self.nchw:
            z = np.transpose(z, (0, 3, 1, 2))
        assert tuple(shape) == z.shape and np.shape(cond) == z.shape
        return torch.from_numpy(np.ascontiguousarray(z)) if self.nchw else z


def test_evaluate_sr_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from eovax.cli.eval_metric_super_res import evaluate_sr as jax_evaluate_sr
    from eovax.core import config as jcfg
    from eovax.data.sen2naip import Sen2NaipCrossSensorLatent as JaxLatents
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
    from eovax_torch import EOFluxVAE
    from eovax_torch.cli.eval_metric_super_res import evaluate_sr
    from eovax_torch.core import config as tcfg
    from eovax_torch.data.sen2naip import Sen2NaipCrossSensorLatent

    jm = JaxVAE(_tiny_vae_config(jcfg), seed=0)
    g = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.02, a.shape)).astype(np.float32), jm.variables)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tm = EOFluxVAE(_tiny_vae_config(tcfg), state_dict_from_variables(variables), device="cpu")

    _write_latent_tree(tmp_path)
    latents = [g.normal(size=(2, 16, 16, Z)).astype(np.float32) for _ in range(2)]
    kw = dict(batch_size=2, num_batches=2)
    ref = jax_evaluate_sr(jm, _StubSampler(latents, nchw=False), None,
                          JaxLatents(str(tmp_path), "test"), **kw)
    out = evaluate_sr(tm, _StubSampler(latents, nchw=True), None,
                      Sen2NaipCrossSensorLatent(str(tmp_path), "test"), **kw)
    assert set(out) == set(ref) == {"rmse", "psnr", "ssim", "sam"}
    for k in ref:
        assert np.isfinite(ref[k])
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_eval_main_on_cpu(tmp_path):
    """The CLI end to end: a YAML config and a .ckpt of the VAE, a state dict of
    the full-width UNet, 2 DDIM steps in bf16 on the CPU: finite metrics."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.cli.eval_metric_super_res import main
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core import config as tcfg

    cfg, ckpt, sr_ckpt = (tmp_path / n for n in ("model_config.yaml", "eo-vae.ckpt", "unet.pt"))
    cfg.write_text(yaml.safe_dump(_VAE_YAML))
    vae = EOFluxVAE(_tiny_vae_config(tcfg), device="cpu", seed=1)
    torch.save({"state_dict": vae.core.state_dict()}, ckpt)
    _, unet = build_denoiser_from_config(
        {"denoiser": {"backbone": {"in_channels": Z, "out_channels": Z, "cond_channels": Z}}},
        seed=2, device="cpu")
    with torch.no_grad():  # conv2, proj and conv_out start at zero: make the output move
        for p in unet.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    torch.save(unet.state_dict(), sr_ckpt)
    _write_latent_tree(tmp_path / "latents")
    main(["--vae-config", str(cfg), "--vae-ckpt", str(ckpt), "--sr-ckpt", str(sr_ckpt),
          "--data-root", str(tmp_path / "latents"), "--batch-size", "2", "--num-batches", "1",
          "--sr-steps", "2", "--output", str(tmp_path / "out"), "--device", "cpu"])
    metrics = json.loads((tmp_path / "out" / "all_metrics.json").read_text())
    assert set(metrics) == {"rmse", "psnr", "ssim", "sam"}
    assert all(np.isfinite(v) for v in metrics.values())


# ---------------------------------------------------------------------------
# DiffusionSuperRes, build_denoiser_from_config, the training side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config,denoiser,schedule", [
    ("eo_vae_latent.yaml", "SimpleDenoiser", "RectifiedSchedule"),
    ("eo_vae_latent_batch.yaml", "KarrasDenoiser", "DecaySchedule"),
    ("pixel.yaml", "KarrasDenoiser", "VPSchedule"),
])
def test_build_denoiser_from_shipped_configs(config, denoiser, schedule):
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.config import load_yaml

    lm = load_yaml(f"configs_superres/{config}")["lightning_module"]
    den, unet = build_denoiser_from_config(lm, device="cpu")
    bb = lm["denoiser"]["backbone"]
    assert type(den).__name__ == denoiser and type(den.schedule).__name__ == schedule
    assert unet.hid_channels == tuple(bb["hid_channels"]) and not unet.training
    assert unet.conv_in.in_channels == bb["in_channels"] + bb["cond_channels"]
    assert unet.conv_out.out_channels == bb["out_channels"]
    assert not unet.conv_out.weight.any() and not unet.up[0].block[0].conv2.weight.any()
    assert unet.mid_attn.proj.weight.abs().sum() == 0 and unet.conv_in.weight.std() > 0


def test_sr_sample_is_seeded_and_checks_the_batch(unets):
    from eovax_torch.train.sr import DiffusionSuperRes

    _, _, tu = unets
    sr = DiffusionSuperRes(denoiser=tsr.SimpleDenoiser(), init_params=tu, sampler_steps=3)
    state = sr.init_state()
    assert state.step == 0 and state.model is not tu and not state.model.training
    cond = np.random.default_rng(6).standard_normal((B, C, HW, HW)).astype(np.float32)
    a = sr.sample(state, (B, C, HW, HW), cond, seed=4)
    b = sr.sample(state, (B, C, HW, HW), cond, seed=4)
    x1 = torch.randn((B, C, HW, HW), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = tsr.DDIMSampler(tsr.SimpleDenoiser(), steps=3)(tu, x1, torch.from_numpy(cond))
    assert torch.equal(a, b) and not torch.equal(a, sr.sample(state, a.shape, cond, seed=5))
    torch.testing.assert_close(a, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="batch mismatch"):
        sr.sample(state, (B + 1, C, HW, HW), cond)
    assert type(DiffusionSuperRes(tsr.SimpleDenoiser(), tu, sampler_type="dpm++2m").sampler) \
        is tsr.DPMSolverPlusPlus2M


def test_sr_training_raises_until_ported(unets):
    """SR training is ported (tests/test_torch_sr_train.py): the trainer has the
    JAX trainer's fields, its data mesh among them, with the same defaults, and the
    training methods; the CLI's main no longer raises (its missing --config is
    argparse's)."""
    from eovax.train.sr import DiffusionSuperRes as JaxSR
    from eovax_torch.cli import train_super_res
    from eovax_torch.train.sr import DiffusionSuperRes

    with pytest.raises(SystemExit):
        train_super_res.main([])
    ours = {f.name: f.default for f in dataclasses.fields(DiffusionSuperRes)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxSR)}
    assert ours == ref
    sr = DiffusionSuperRes(denoiser=tsr.SimpleDenoiser(), init_params=unets[2])
    assert all(callable(getattr(sr, m)) for m in ("fit", "validate", "save_checkpoint",
                                                  "restore_checkpoint", "restore_best"))


def test_new_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from eovax_torch.cli import eval_metric_super_res
    from eovax_torch.cli.train_super_res import build_denoiser_from_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"denoiser": {"backbone": {"in_channels": 4, "out_channels": 4, "cond_channels": 4,
                                     "hid_channels": [32, 16], "hid_blocks": [1, 1]}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_denoiser_from_config(cfg)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(_VAE_YAML))
    torch.save({"state_dict": {}}, tmp_path / "m.ckpt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_metric_super_res.main(["--vae-config", str(tmp_path / "c.yaml"), "--vae-ckpt",
                                    str(tmp_path / "m.ckpt"), "--sr-ckpt", "u.pt",
                                    "--data-root", str(tmp_path)])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 1e-1)],
                         ids=["fp32", "bf16"])
def test_unet_and_ddim_on_card_match_cpu(cuda_device, dtype, tol):
    """A UNet whose convs, norms (2 channels a group at the bottom) and D = 64
    attention reach the hand kernels, on the card against fp32 on the CPU,
    relative to max |CPU|: fp32 (TF32 off) other summation orders; bf16, bf16
    activations between the layers."""
    from eovax_torch.core.precision import FULL_PRECISION, Policy
    from eovax_torch.kernels import attention, conv3x3, groupnorm
    from eovax_torch.nn.init import init_parameters

    FULL_PRECISION.activate()
    kw = dict(in_channels=8, out_channels=8, cond_channels=8, hid_channels=(32, 64),
              hid_blocks=(1, 1))
    ref_unet = UNet(**kw)
    init_parameters(ref_unet, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in ref_unet.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    card = UNet(**kw, policy=Policy(compute_dtype=dtype))
    card.load_state_dict(ref_unet.state_dict())
    card.to(cuda_device).eval()
    g = torch.Generator().manual_seed(2)
    x, cond = torch.randn(2, 8, 32, 32, generator=g), torch.randn(2, 8, 32, 32, generator=g)
    t = torch.tensor([0.7, 0.2])
    sampler = tsr.DDIMSampler(tsr.SimpleDenoiser(), steps=4)
    with torch.inference_mode():
        conv3x3.conv3x3.launches = groupnorm.group_norm.launches = 0
        attention.flash_attention.launches = 0
        out = card(x.to(cuda_device), t.to(cuda_device), cond.to(cuda_device))
        counts = (conv3x3.conv3x3.launches, groupnorm.group_norm.launches,
                  attention.flash_attention.launches)
        pairs = [(out, ref_unet(x, t, cond)),
                 (sampler(card, x.to(cuda_device), cond.to(cuda_device)),
                  sampler(ref_unet, x, cond))]
    assert counts == (2 * 8, 2 * 8 + 2, 1)  # 8 blocks, their norms, mid_attn and norm_out
    for got, ref in pairs:
        assert torch.isfinite(got).all()
        err = (got.float().cpu() - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), err
