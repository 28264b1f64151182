"""Each module of the port against its flax counterpart in the JAX package.

The flax module is initialized, every variable is perturbed with numpy
noise (so zero inits such as the AdaIN projection are exercised), the
variables go through ``eovax_torch.utils.convert`` into the port's module
with ``load_state_dict(strict=True)``, and both run the same numpy input in
fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eovax.nn import blocks as jb
from eovax.nn import distributions as jd
from eovax.nn import dynamic_conv as jdc
from eovax.nn import latent as jl
from eovax.nn import transformer as jt
from eovax_torch.data.wavelengths import SEN2NAIP_WAVELENGTHS, WAVELENGTHS
from eovax_torch.nn import blocks as tb
from eovax_torch.nn import distributions as td
from eovax_torch.nn import dynamic_conv as tdc
from eovax_torch.nn import latent as tl
from eovax_torch.nn import transformer as tt
from eovax_torch.nn.init import init_parameters
from eovax_torch.utils.convert import state_dict_from_variables

# fp32 on both sides; XLA's and PyTorch's CPU kernels sum in other orders.
TOL = dict(rtol=1e-4, atol=1e-5)
WVS = np.asarray(WAVELENGTHS["S2L2A"][:5], np.float32)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def _variables(module, *args, seed=0, **kw):
    """Flax variables with every leaf perturbed by N(0, 0.05)."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    g = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.05, a.shape)).astype(np.float32), variables
    )


def _port(module, variables, scope=None):
    """Load flax variables into the port's module. ``scope`` nests them under
    the name the module has inside the model, where the bridge's renames
    (``layers_0`` → ``layers.0``, ``mlp_0`` → ``mlp.0``) apply."""
    if scope is None:
        sd = state_dict_from_variables(variables)
    else:
        sd = state_dict_from_variables({"params": {scope: variables["params"]}})
        sd = {k.removeprefix(scope + "."): v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _apply(module, variables, *args, **kw):
    return module.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize(
    "cin,cout,emb_shape",
    [(64, 128, None), (64, 64, (512,)), (64, 128, (2, 512))],
    ids=["plain", "adain-shared", "adain-batched"],
)
def test_resnet_block(cin, cout, emb_shape):
    x = _rand((2, cin, 8, 8))
    cond = 512 if emb_shape else None
    emb = _rand(emb_shape, seed=1) if emb_shape else None
    jmod = jb.ResnetBlock(in_channels=cin, out_channels=cout, cond_dim=cond)
    jemb = None if emb is None else jnp.asarray(emb)
    variables = _variables(jmod, _nhwc(x), jemb)
    ref = _nchw(_apply(jmod, variables, _nhwc(x), jemb))
    mod = _port(tb.ResnetBlock(cin, cout, cond), variables)
    with torch.no_grad():
        out = mod(_t(x), None if emb is None else _t(emb)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_attn_block():
    x = _rand((2, 64, 16, 16))
    jmod = jb.AttnBlock(in_channels=64)
    variables = _variables(jmod, _nhwc(x))
    ref = _nchw(_apply(jmod, variables, _nhwc(x)))
    with torch.no_grad():
        out = _port(tb.AttnBlock(64), variables)(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("res", [16, 15])
def test_downsample(res):
    x = _rand((2, 32, res, res))
    jmod = jb.Downsample(in_channels=32)
    variables = _variables(jmod, _nhwc(x))
    ref = _nchw(_apply(jmod, variables, _nhwc(x)))
    with torch.no_grad():
        out = _port(tb.Downsample(32), variables)(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_upsample_matches_subpixel_conv():
    """Plain nearest ×2 + conv vs the JAX package's input-dilated form
    (subpixel_upsample_conv): equal up to the tap-sum reassociation."""
    x = _rand((2, 32, 8, 8))
    jmod = jb.Upsample(in_channels=32)
    variables = _variables(jmod, _nhwc(x))
    ref = _nchw(_apply(jmod, variables, _nhwc(x)))
    with torch.no_grad():
        out = _port(tb.Upsample(32), variables)(_t(x)).numpy()
    assert out.shape == (2, 32, 16, 16)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("modality", ["S2RGB", "S1RTC", "S2L2A"])
def test_wavelength_conditioner(modality):
    wvs = jnp.asarray(WAVELENGTHS[modality], jnp.float32)
    jmod = jb.WavelengthConditioner(embed_dim=512)
    variables = _variables(jmod, wvs)
    ref = np.asarray(_apply(jmod, variables, wvs))
    mod = _port(tb.WavelengthConditioner(512), variables, scope="conditioner")
    with torch.no_grad():
        out = mod(_t(wvs)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("norm_first", [False, True], ids=["post-norm", "pre-norm"])
def test_transformer_encoder(norm_first):
    x = jnp.asarray(_rand((20, 32)))
    jmod = jt.TransformerEncoder(d_model=32, nhead=4, num_layers=2, dim_feedforward=64,
                                 norm_first=norm_first)
    variables = _variables(jmod, x)
    ref = np.asarray(_apply(jmod, variables, x))
    mod = tt.TransformerEncoder(32, 4, 2, dim_feedforward=64, norm_first=norm_first)
    with torch.no_grad():
        out = _port(mod, variables, scope="transformer_encoder")(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("modality", list(WAVELENGTHS) + ["SEN2NAIP"])
def test_sincos_wavelength_embed_with_plain_sin(modality):
    """Plain fp32 torch.sin/cos of wvs·1000 (up to ~12000 rad) against the
    JAX package's 3-part 2π range reduction."""
    wvs = np.asarray(WAVELENGTHS.get(modality, SEN2NAIP_WAVELENGTHS), np.float32) * 1000.0
    ref = np.asarray(jdc.sincos_wavelength_embed(256, jnp.asarray(wvs)))
    out = tdc.sincos_wavelength_embed(256, _t(wvs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("generator", ["transformer", "factorized"])
@pytest.mark.parametrize("variant", ["encoder", "decoder"])
def test_dynamic_conv(variant, generator):
    n, e = len(WVS), 32
    if variant == "encoder":
        jmod = jdc.DynamicConv(wv_planes=32, embed_dim=e, num_layers=1, generator_type=generator)
        mod = tdc.DynamicConv(32, embed_dim=e, num_layers=1, generator_type=generator)
        x = _rand((2, n, 8, 8))
    else:
        jmod = jdc.DynamicConvDecoder(wv_planes=32, embed_dim=e, generator_type=generator)
        mod = tdc.DynamicConvDecoder(32, embed_dim=e, generator_type=generator)
        x = _rand((2, e, 8, 8))
    wvs = jnp.asarray(WVS)
    variables = _variables(jmod, _nhwc(x), wvs)
    mod = _port(mod, variables)
    with torch.no_grad():
        out = mod(_t(x), _t(WVS)).numpy()
        weight, bias = mod.generate(_t(WVS))
        dweight, dbias = mod.get_distillation_weight(_t(WVS))
    np.testing.assert_allclose(out, _nchw(_apply(jmod, variables, _nhwc(x), wvs)), **TOL)
    jkernel, jbias = _apply(jmod, variables, wvs, method="generate")
    # The JAX package generates HWIO; the port generates torch's OIHW.
    np.testing.assert_allclose(weight.numpy(), np.transpose(jkernel, (3, 2, 0, 1)), **TOL)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), **TOL)
    jdw, jdb = _apply(jmod, variables, wvs, method="get_distillation_weight")
    np.testing.assert_allclose(dweight.numpy(), np.asarray(jdw), **TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(jdb), **TOL)
    if variant == "decoder":  # forward bias ·0.01, distillation bias ·0.1
        np.testing.assert_allclose(bias.numpy() * 10.0, dbias.numpy(), rtol=1e-6)


def test_factorized_dropout_only_in_train_mode():
    mod = tdc.DynamicConv(32, embed_dim=32, num_layers=1, generator_type="factorized")
    init_parameters(mod, torch.Generator().manual_seed(0))
    wvs = _t(WVS)
    with torch.no_grad():
        mod.eval()
        a, b = mod.generate(wvs)[0], mod.generate(wvs)[0]
        assert torch.equal(a, b)
        mod.train()
        torch.manual_seed(0)
        c = mod.generate(wvs)[0]
    assert not torch.allclose(a, c)


def test_diagonal_gaussian():
    moments = _rand((2, 16, 4, 4), seed=3, scale=20.0)  # logvar beyond [-30, 20] too
    other = _rand((2, 16, 4, 4), seed=4)
    sample = _rand((2, 8, 4, 4), seed=5)
    jp = jd.DiagonalGaussian.from_moments(_nhwc(moments))
    jo = jd.DiagonalGaussian.from_moments(_nhwc(other))
    tp = td.DiagonalGaussian.from_moments(_t(moments))
    to = td.DiagonalGaussian.from_moments(_t(other))
    for name in ("mean", "logvar", "std", "var"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), _nchw(getattr(jp, name)), **TOL)
    np.testing.assert_allclose(tp.mode().numpy(), _nchw(jp.mode()))
    np.testing.assert_allclose(tp.kl().numpy(), np.asarray(jp.kl()), rtol=1e-5)
    np.testing.assert_allclose(tp.kl(to).numpy(), np.asarray(jp.kl(jo)), rtol=1e-5)
    np.testing.assert_allclose(tp.nll(_t(sample)).numpy(), np.asarray(jp.nll(_nhwc(sample))),
                               rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    draw = tp.sample(g)
    assert draw.shape == tp.mean.shape and torch.isfinite(draw).all()


@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (1, 32, 4, 4)])
def test_patch_shuffle_roundtrip(shape):
    z = _rand(shape)
    packed = tl.patch_shuffle(_t(z))
    np.testing.assert_array_equal(packed.numpy(), _nchw(jl.patch_shuffle(_nhwc(z))))
    np.testing.assert_array_equal(
        tl.patch_unshuffle(packed).numpy(), _nchw(jl.patch_unshuffle(jl.patch_shuffle(_nhwc(z))))
    )
    np.testing.assert_array_equal(tl.patch_unshuffle(packed).numpy(), z)


@pytest.fixture
def latent_bn():
    x = _rand((4, 32, 4, 4), seed=6, scale=3.0) + 1.0
    jmod = jl.LatentBatchNorm(num_features=32)
    variables = _variables(jmod, _nhwc(x), use_running_average=True)
    g = np.random.default_rng(7)
    variables["batch_stats"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    return x, jmod, variables, _port(tl.LatentBatchNorm(32), variables)


def test_latent_batchnorm_running_stats_and_inverse(latent_bn):
    x, jmod, variables, mod = latent_bn
    ref = _nchw(_apply(jmod, variables, _nhwc(x), use_running_average=True))
    inv = _nchw(_apply(jmod, variables, _nhwc(x), method=jl.LatentBatchNorm.inverse))
    with torch.no_grad():
        np.testing.assert_allclose(mod(_t(x), use_running_average=True).numpy(), ref, **TOL)
        np.testing.assert_allclose(mod.inverse(_t(x)).numpy(), inv, **TOL)


def test_latent_batchnorm_train_update(latent_bn):
    x, jmod, variables, mod = latent_bn
    ref, updates = _apply(jmod, variables, _nhwc(x), use_running_average=False,
                          mutable=["batch_stats"])
    with torch.no_grad():
        out = mod(_t(x), use_running_average=False).numpy()
    np.testing.assert_allclose(out, _nchw(ref), **TOL)
    np.testing.assert_allclose(mod.running_mean.numpy(), updates["batch_stats"]["mean"], **TOL)
    np.testing.assert_allclose(mod.running_var.numpy(), updates["batch_stats"]["var"], **TOL)
    assert int(mod.num_batches_tracked) == 1
