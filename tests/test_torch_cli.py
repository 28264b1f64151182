"""The port's bulk-encode and tiled-reconstruct entry points against the JAX package's.

Both models hold the same variables (the JAX package's init, perturbed, with
non-trivial latent BatchNorm statistics, through
``state_dict_from_variables``) at the tiny config of
``tests/test_cli_and_data.py`` and run the same numpy inputs in fp32 on the
CPU. The host-side helpers these paths use (``RunningStats``,
``resize_nhwc``, the Sen2NAIP collates, ``tile_grid``) are held against
their JAX-package counterparts too.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from eovax.core import config as jcfg
from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.utils.convert import state_dict_from_variables

# fp32 end to end through the tiny model: the tolerance tests/test_torch_model.py
# uses for the whole pass.
TOL = dict(rtol=1e-4, atol=1e-4)
WVS4 = np.asarray([0.665, 0.56, 0.49, 0.842], np.float32)
RGB = np.asarray([0.665, 0.56, 0.49], np.float32)

_MODEL_YAML = {
    "model": {
        part: {"z_channels": 8, "resolution": 32, channels: 4, "ch": 32, "ch_mult": [1, 2],
               "num_res_blocks": 1, "use_dynamic_ops": True,
               "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
        for part, channels in (("encoder", "in_channels"), ("decoder", "out_ch"))
    }
}


def _tiny(m):
    stem = m.StemConfig(num_layers=1, wv_planes=64)
    kw = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              use_dynamic_ops=True, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(in_channels=4, **kw),
                       decoder=m.DecoderConfig(out_ch=4, **kw))


@pytest.fixture(scope="module")
def models():
    jm = JaxVAE(_tiny(jcfg), seed=0)
    g = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.02, a.shape)).astype(np.float32),
        jm.variables,
    )
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    sd = state_dict_from_variables(variables)
    return jm, EOFluxVAE(_tiny(tcfg), sd, device="cpu"), sd


def _batches(n=2, b=2, res=32, seed=6):
    g = np.random.default_rng(seed)
    return [
        {"image_lr": g.normal(size=(b, res, res, 4)).astype(np.float32),
         "image_hr": g.normal(size=(b, res, res, 4)).astype(np.float32),
         "aoi": [f"a{i}_{j}" for j in range(b)]}
        for i in range(n)
    ]


@pytest.mark.parametrize("use_spatial_norm", [True, False], ids=["spatial-norm", "encoder-mean"])
def test_encode_split_matches_jax(models, tmp_path, use_spatial_norm):
    from eovax.cli.encode_latents import encode_split as jax_encode_split
    from eovax.utils.stats import RunningStats as JaxStats
    from eovax_torch.cli.encode_latents import encode_split
    from eovax_torch.utils.stats import RunningStats

    jm, tm, _ = models
    results = {}
    for name, model, split, stats_cls in (("jax", jm, jax_encode_split, JaxStats),
                                           ("torch", tm, encode_split, RunningStats)):
        stats_lr, stats_hr = stats_cls((8,), (0, 1, 2)), stats_cls((8,), (0, 1, 2))
        out = tmp_path / name
        n = split(model, iter(_batches()), str(out / "train"), wvs=WVS4, stats_lr=stats_lr,
                  stats_hr=stats_hr, use_spatial_norm=use_spatial_norm)
        assert n == 4
        stats = {"lr_latent": stats_lr.to_dict(), "hr_latent": stats_hr.to_dict()}
        results[name] = (out / "train", json.loads(json.dumps(stats)))

    (jdir, jstats), (tdir, tstats) = results["jax"], results["torch"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for fname in sorted(os.listdir(jdir)):
        with np.load(jdir / fname) as ref, np.load(tdir / fname) as out:
            assert sorted(out.files) == sorted(ref.files) == [
                "hr_image", "hr_latent", "lr_image", "lr_latent"]
            assert out["lr_latent"].shape == (8, 16, 16)  # CHW reference schema
            for key in ref.files:
                np.testing.assert_allclose(out[key], ref[key], **TOL)
    assert tstats.keys() == jstats.keys()
    for part in jstats:
        assert tstats[part].keys() == jstats[part].keys()
        for key in jstats[part]:
            np.testing.assert_allclose(tstats[part][key], jstats[part][key], **TOL)


def test_transposed_input_reaches_the_norms_contiguous(models):
    """encode_split hands the model NHWC batches transposed to NCHW views; the
    kernels on the card take contiguous NCHW only, so the API makes it so."""
    _, tm, _ = models
    seen = []
    hook = tm.core.encoder.down[0].block[0].norm1.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].is_contiguous()))
    try:
        tm.encode_spatial_normalized(np.transpose(_batches(n=1)[0]["image_hr"], (0, 3, 1, 2)),
                                     WVS4)
    finally:
        hook.remove()
    assert seen == [True]


def test_tiled_reconstruct_matches_jax(models):
    from eovax.utils.tiling import tiled_reconstruct as jax_tiled
    from eovax_torch.utils.tiling import tiled_reconstruct

    jm, tm, _ = models
    scene = np.random.default_rng(1).standard_normal((4, 80, 72)).astype(np.float32)
    kw = dict(tile=32, overlap=8, batch_size=4)
    out = tiled_reconstruct(tm, scene, WVS4, **kw)
    assert out.shape == scene.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, jax_tiled(jm, scene, WVS4, **kw), **TOL)


@pytest.mark.parametrize("size,tile,overlap", [(1024, 256, 32), (80, 32, 8), (32, 32, 0),
                                               (100, 48, 47)])
def test_tile_grid_matches_jax(size, tile, overlap):
    from eovax.utils.tiling import tile_grid as jax_tile_grid
    from eovax_torch.utils.tiling import tile_grid

    assert tile_grid(size, tile, overlap) == jax_tile_grid(size, tile, overlap)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled-normalized"])
def test_reconstruct_main_on_cpu(models, tmp_path, tiled):
    """The CLI end to end from a YAML config and a Lightning-style .ckpt, held
    against the JAX model with the same weights."""
    from eovax.data.normalize import make_normalizer
    from eovax.utils.tiling import tiled_reconstruct as jax_tiled
    from eovax_torch.cli.reconstruct import main

    jm, _, sd = models
    cfg, ckpt = tmp_path / "model_config.yaml", tmp_path / "eo-vae.ckpt"
    cfg.write_text(yaml.safe_dump(_MODEL_YAML))
    torch.save({"state_dict": sd}, ckpt)
    scene = (np.random.default_rng(2).standard_normal((3, 48, 48)) * 50 + 100).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    args = ["--config", str(cfg), "--ckpt", str(ckpt), "--image", str(tmp_path / "scene.npy"),
            "--modality", "S2RGB", "--output", str(tmp_path / "recon.npy"), "--device", "cpu"]
    x = scene[None]
    if tiled:
        args += ["--tiled", "--normalize", "--tile", "32", "--overlap", "16", "--tile-batch", "2"]
        x = np.transpose(make_normalizer("S2RGB")(np.transpose(x, (0, 2, 3, 1))), (0, 3, 1, 2))
        ref = jax_tiled(jm, x[0], RGB, tile=32, overlap=16, batch_size=2)[None]
    else:
        ref = np.asarray(jm.reconstruct(x, RGB))
    main(args)
    out = np.load(tmp_path / "recon.npy")
    assert out.shape == (1, 3, 48, 48)
    np.testing.assert_allclose(out, ref, **TOL)


def test_reconstruction_check_writes_grid(models, tmp_path):
    from eovax.cli.encode_latents import reconstruction_check as jax_check
    from eovax_torch.cli.encode_latents import reconstruction_check

    jm, tm, _ = models
    batch = _batches(n=1, b=3)[0]
    path, mse = reconstruction_check(tm, batch, WVS4, str(tmp_path), max_images=2)
    assert os.path.exists(path) and path.endswith("reconstruction_check.png")
    (tmp_path / "jax").mkdir()
    _, ref_mse = jax_check(jm, batch, WVS4, str(tmp_path / "jax"), max_images=2)
    np.testing.assert_allclose(mse, ref_mse, rtol=1e-4)


def test_running_stats_matches_jax():
    from eovax.utils.stats import RunningStats as JaxStats
    from eovax_torch.utils.stats import RunningStats

    g = np.random.default_rng(3)
    ours, ref = RunningStats((5,), (0, 1, 2)), JaxStats((5,), (0, 1, 2))
    for shape in ((2, 4, 4, 5), (1, 1, 1, 5), (3, 2, 6, 5)):
        x = g.normal(2.0, 3.0, size=shape)
        ours(x)
        ref(x)
    assert ours.to_dict() == ref.to_dict()


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "area"])
@pytest.mark.parametrize("out_hw", [(64, 48), (10, 7)])
def test_resize_nhwc_matches_jax(mode, out_hw):
    from eovax.utils.resize import resize_nhwc as jax_resize
    from eovax_torch.utils.resize import resize_nhwc

    x = np.random.default_rng(4).standard_normal((2, 16, 20, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), out_hw, mode))
    np.testing.assert_allclose(resize_nhwc(x, out_hw, mode), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resize_nhwc(torch.from_numpy(x), out_hw, mode).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("collate", ["sen2naip_collate", "sen2naip_domain_adapted_collate"])
def test_sen2naip_collate_matches_jax(collate):
    from eovax.data import sen2naip as jax_sen2naip
    from eovax_torch.data import sen2naip

    g = np.random.default_rng(5)
    samples = [{"image_lr": g.uniform(0, 4000, (8, 8, 4)).astype(np.float32),
                "image_hr": g.uniform(0, 255, (32, 32, 4)).astype(np.float32),
                "aoi": f"aoi{i}"} for i in range(3)]
    out = getattr(sen2naip, collate)(samples)
    ref = getattr(jax_sen2naip, collate)(samples)
    assert out["aoi"] == ref["aoi"]
    assert out["image_lr"].shape == (3, 32, 32, 4)
    for key in ("image_lr", "image_hr"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sen2naip.SEN2NAIP_WVS, jax_sen2naip.SEN2NAIP_WVS)
