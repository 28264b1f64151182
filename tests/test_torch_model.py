"""The slice as a whole: the port's EOFluxVAE against the JAX package's.

Both models hold the same variables (the JAX package's init, perturbed, with
non-trivial latent BatchNorm statistics) and run the same numpy inputs in
fp32 on the CPU, at a tiny config and at 12-band S2L2A and 4-band Sen2NAIP
wavelengths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eovax.core import config as jcfg
from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.data.wavelengths import SEN2NAIP_WAVELENGTHS, WAVELENGTHS
from eovax_torch.utils.convert import state_dict_from_variables

# fp32 end to end through ~20 conv layers: XLA's and PyTorch's CPU kernels
# sum in other orders, and the Upsample tap sums are reassociated.
TOL = dict(rtol=1e-4, atol=1e-4)

BANDS = {"S2L2A": WAVELENGTHS["S2L2A"], "SEN2NAIP": SEN2NAIP_WAVELENGTHS}


def _tiny(m, adain=False, generator="transformer"):
    stem = m.StemConfig(num_layers=1, wv_planes=32, use_adain=adain, generator_type=generator)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(**kw), decoder=m.DecoderConfig(**kw))


@pytest.fixture(scope="module", params=["transformer", "adain-factorized"])
def models(request):
    adain = request.param != "transformer"
    gen = "factorized" if adain else "transformer"
    jm = JaxVAE(_tiny(jcfg, adain, gen), seed=0)
    g = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.02, a.shape)).astype(np.float32),
        jm.variables,
    )
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tm = EOFluxVAE(_tiny(tcfg, adain, gen), state_dict_from_variables(variables), device="cpu")
    return jm, tm


def _inputs(bands, seed=0):
    wvs = np.asarray(BANDS[bands], np.float32)
    x = np.random.default_rng(seed).standard_normal((2, len(wvs), 32, 32)).astype(np.float32)
    return x, wvs


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("bands", list(BANDS))
def test_reconstruct(models, bands):
    jm, tm = models
    x, wvs = _inputs(bands)
    out = tm.reconstruct(x, wvs)
    assert out.shape == x.shape
    _close(out, jm.reconstruct(x, wvs))


@pytest.mark.parametrize("bands", list(BANDS))
def test_encode_posterior(models, bands):
    jm, tm = models
    x, wvs = _inputs(bands)
    post, ref = tm.encode(x, wvs), jm.encode(x, wvs)
    _close(post.mean, ref.mean)
    _close(post.logvar, ref.logvar)


@pytest.mark.parametrize("bands", list(BANDS))
def test_decode_packed_latent(models, bands):
    jm, tm = models
    _, wvs = _inputs(bands)
    z = np.random.default_rng(1).standard_normal((2, 32, 8, 8)).astype(np.float32)
    _close(tm.decode(z, wvs), jm.decode(z, wvs))
    _close(tm.decode_raw(z[:, :8], wvs), jm.decode_raw(z[:, :8], wvs))


@pytest.mark.parametrize("bands", list(BANDS))
def test_encode_to_latent(models, bands):
    jm, tm = models
    x, wvs = _inputs(bands)
    out = tm.encode_to_latent(x, wvs)
    assert out.shape == (2, 32, 8, 8)
    _close(out, jm.encode_to_latent(x, wvs))


@pytest.mark.parametrize("bands", list(BANDS))
def test_spatial_normalized_roundtrip(models, bands):
    jm, tm = models
    x, wvs = _inputs(bands)
    z = tm.encode_spatial_normalized(x, wvs)
    assert z.shape == (2, 8, 16, 16)
    _close(z, jm.encode_spatial_normalized(x, wvs))
    zn = z.numpy()
    _close(tm.decode_spatial_normalized(zn, wvs), jm.decode_spatial_normalized(zn, wvs))


@pytest.mark.parametrize("scale,angle", [(None, 1), (0.5, None), ((0.75, 0.5), 3)])
def test_forward_with_scale_and_rotation(models, scale, angle):
    jm, tm = models
    x, wvs = _inputs("S2L2A", seed=2)
    recon, post = tm.forward(x, wvs, sample_posterior=False, scale=scale, angle=angle)
    jrecon, jpost = jm.forward(x, wvs, sample_posterior=False, scale=scale, angle=angle)
    _close(recon, jrecon)
    _close(post.mean, jpost.mean)


def test_forward_sampling_is_seeded(models):
    _, tm = models
    x, wvs = _inputs("S2L2A")
    a, _ = tm.forward(x, wvs, seed=3)
    b, _ = tm.forward(x, wvs, seed=3)
    c, _ = tm.forward(x, wvs, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_param_count_matches(models):
    jm, tm = models
    assert tm.param_count() == jm.param_count()


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EOFluxVAE(_tiny(tcfg))


def test_basis_stem_not_ported_yet():
    """Named when the port refused ``stem.mode: basis``; it now holds the basis
    stems' model against the JAX package's: the tiny config with shared-basis
    stems (8 bases, rank 16) on both sides, the JAX init perturbed as the
    ``models`` fixture's, ``reconstruct`` at both band sets within TOL."""
    def basis(m):
        cfg = _tiny(m)
        stem = dataclasses.replace(cfg.encoder.stem, mode="basis", num_bases=8, rank_dim=16)
        return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, stem=stem),
                                   decoder=dataclasses.replace(cfg.decoder, stem=stem))

    jm = JaxVAE(basis(jcfg), seed=1)
    g = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.02, a.shape)).astype(np.float32),
        jm.variables)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tm = EOFluxVAE(basis(tcfg), state_dict_from_variables(variables), device="cpu")
    assert type(tm.core.encoder.conv_in).__name__ == "DynamicInputLayer"
    assert type(tm.core.decoder.conv_out).__name__ == "DynamicOutputLayer"
    for bands in BANDS:
        x, wvs = _inputs(bands)
        _close(tm.reconstruct(x, wvs), jm.reconstruct(x, wvs))
