"""The port's adversarial stage 2 against the JAX package's, on the CPU in fp32.

The tiny VAE of ``tests/test_torch_train.py`` (ch 32, ch_mult (1, 2), 4 bands)
and small discriminators (ndf 16-32, two layers), every JAX parameter drawn
from numpy and carried over through ``state_dict_from_variables`` and
``discriminator_state_dict`` with ``strict=True``: the objectives, both
discriminators with and without the spectral-norm update, the spectral-norm
conv's gradient, ``adaptive_weight``, both composite losses, ``forward_gan``,
a 3-step ``gen_step`` + ``disc_step`` trajectory against
``make_adversarial_steps``, a ``Stage2Trainer.fit`` against the JAX fit's CSV
rows, a bit-exact resume with the discriminator's state, and the train CLI.

JAX is imported only inside the tests that need it, so the card's machine
runs the ``gpu`` test without it:

    python -m pytest tests/test_torch_gan.py -m gpu --noconftest
"""

import csv
import dataclasses
import functools
import os
import types

import numpy as np
import pytest
import torch

from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.data.synthetic import synthetic_terramesh_batches
from eovax_torch.losses import gan
from eovax_torch.losses.factory import build_loss_from_config
from eovax_torch.nn.dynamic_conv import apply_dynamic_kernel
from eovax_torch.train import stage2
from eovax_torch.utils import checkpoint
from eovax_torch.utils.convert import discriminator_state_dict, state_dict_from_variables

WVS = np.asarray([0.665, 0.56, 0.49, 0.842], np.float32)
BASE_LR = 1e-4
# Losses, logs and logits: fp32 through the VAE's ~20 conv layers or the
# discriminator's 4, summed in other orders by XLA and PyTorch.
TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# Activations of the VAE (of order 1): an absolute floor of 1e-5 for the entries
# near 0, where the summation order's round-off is a larger share.
ACT_TOL = dict(rtol=1e-4, atol=1e-5)
# Parameters after STEPS applied Adam updates: where the true gradient is 0 the
# two sides move by ±lr with the sign of their round-off (ROADMAP Queue 3, kept
# difference 7): every entry within 2·STEPS·lr, all but a thousandth within a
# hundredth of STEPS·lr (tests/test_torch_train.py's rules).
STEPS = 3
PARAM_ATOL = 2 * STEPS * BASE_LR
PARAM_CLOSE = 1e-2 * STEPS * BASE_LR
PARAM_FAR_SHARE = 1e-3
# The discriminator after its two Adam steps: 0.29 % of its entries, nearly
# all in its hypernetwork stem (the 2048-wide feed-forward, the weight tokens),
# are further than PARAM_CLOSE, each within PARAM_ATOL; their gradients are
# sums that cancel, so either side's round-off sets much of each Adam step. Its
# logits with either side's final weights agree at TOL
# (test_trajectory_discriminator_and_spectral_stats_match_jax).
DISC_FAR_SHARE = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(m, **over):
    stem = m.StemConfig(num_layers=1, wv_planes=32, use_adain=True)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem,
              in_channels=4, out_ch=4)
    enc = {k: v for k, v in kw.items() if k != "out_ch"}
    dec = {k: v for k, v in kw.items() if k != "in_channels"}
    train = dict(base_lr=BASE_LR, final_lr=1e-5, warmup_epochs=0, decay_end_epoch=1,
                 clip_grad=1.0, sample_posterior=False, latent_noise_p=0.0)
    return m.VAEConfig(encoder=m.EncoderConfig(**enc), decoder=m.DecoderConfig(**dec),
                       **{**train, **over})


PATCH_CFG = {"_target_": "eo_vae.models.modules.consistency_loss.EOPatchLoss",
             "disc_start": 1, "disc_weight": 0.5, "ssim_weight": 0.0,
             "discriminator": {"n_layers": 2}}
GEN_CFG = {"_target_": "eo_vae.models.modules.loss_functions.EOGenerativeLoss",
           "perceptual_weight": 1.0, "disc_weight": 0.9, "gan_start_step": 1,
           "disc_update_start_step": 0, "max_d_weight": 1e4, "disc_loss_type": "hinge",
           "focal_loss_weight": 1.0, "focal_loss_alpha": 1.0,
           "discriminator": {"ndf": 16, "n_layers": 2}}


def _drawn(module, *args, seed=0, **kw):
    """Variables of a flax module drawn from numpy, by the shapes of its init
    (traced, not run): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.02),
    spectral-norm u N(0, 1) and σ 1, every other leaf N(0, 0.02)."""
    import jax

    g = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if name == "kernel":
            a = g.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            a = 1.0 + g.normal(0.0, 0.02, shape)
        elif name.endswith("/u"):
            a = g.normal(0.0, 1.0, shape)
        elif name.endswith("/sigma"):
            a = np.ones(shape)
        else:
            a = g.normal(0.0, 0.02, shape)
        return np.asarray(a, np.float32)

    shapes = jax.eval_shape(functools.partial(module.init, **kw), jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_vae(jcfg_):
    """The JAX model with drawn variables and non-trivial latent BN statistics."""
    import jax.numpy as jnp

    from eovax.models.backbone import EOVAECore as JaxCore
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE

    g = np.random.default_rng(0)
    core = JaxCore(encoder_cfg=jcfg_.encoder, decoder_cfg=jcfg_.decoder)
    n = jcfg_.encoder.in_channels
    variables = _drawn(core, jnp.zeros((1, 32, 32, n)), jnp.linspace(0.4, 2.5, n),
                       sample_posterior=False, method=JaxCore.forward)
    jm = JaxVAE(jcfg_, variables)
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    return jm, variables


def _jax_disc_vars(jdisc, channels, seed=1):
    import jax.numpy as jnp

    return _drawn(jdisc, jnp.zeros((1, 32, 32, channels)), jnp.linspace(0.4, 2.5, channels),
                  seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_disc(kind):
    from eovax.losses import gan as jgan

    jd = (jgan.DynamicPatchGAN(ndf=16, n_layers=2, wv_planes=32) if kind == "patch"
          else jgan.NLayerDiscriminator(ndf=16, n_layers=2))
    return jd, _jax_disc_vars(jd, len(WVS))


def _discs(kind):
    """A JAX discriminator, its drawn variables and a fresh port copy of it."""
    jd, v = _jax_disc(kind)
    td = (gan.DynamicPatchGAN(ndf=16, n_layers=2, wv_planes=32) if kind == "patch"
          else gan.NLayerDiscriminator(ndf=16, n_layers=2))
    td.load_state_dict(discriminator_state_dict(v), strict=True)
    return jd, v, td.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# -- objectives, discriminators, spectral norm, adaptive weight ---------------------------------


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss", "vanilla_g_loss",
                                  "robust_normalize"])
def test_objectives_match_jax(name):
    import jax.numpy as jnp

    from eovax.losses import gan as jgan

    g = np.random.default_rng(0)
    a, b = (3 * g.standard_normal(64).astype(np.float32) for _ in range(2))
    nargs = 2 if name.endswith("d_loss") else 1
    ref = getattr(jgan, name)(*(jnp.asarray(v) for v in (a, b)[:nargs]))
    got = getattr(gan, name)(*(torch.from_numpy(v) for v in (a, b)[:nargs]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,update_sn", [("patch", False), ("patch", True),
                                            ("nlayer", False)])
def test_discriminator_logits_and_spectral_stats_match_jax(kind, update_sn):
    import jax
    import jax.numpy as jnp

    jd, v, td = _discs(kind)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 4)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(WVS))
    wvs = torch.from_numpy(WVS)
    if not update_sn:
        ref = np.asarray(jd.apply(v, *args))
        with torch.no_grad():
            got = _nhwc(td(_nchw(x), wvs))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **LOGIT_TOL)
        return
    # The JAX discriminator step's forward with update_sn=True stores one
    # power-iteration step; the port stores the same step through
    # update_spectral_stats(), and moves nothing else.
    _, upd = jax.jit(functools.partial(jd.apply, update_sn=True, mutable=["spectral_stats"]))(
        v, *args)
    before = {k: t.clone() for k, t in td.state_dict().items()}
    td.update_spectral_stats()
    stats = discriminator_state_dict(
        {"spectral_stats": jax.tree_util.tree_map(np.asarray, upd["spectral_stats"])})
    assert sorted(stats) == sorted(k for k in before if k.endswith((".u", ".sigma")))
    for key, value in td.state_dict().items():
        if key in stats:
            assert not torch.equal(value, before[key]), key
            torch.testing.assert_close(value, stats[key], rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(value, before[key]), key
    # A forward from the updated statistics matches JAX's on the updated ones.
    ref = np.asarray(jd.apply({**v, "spectral_stats": upd["spectral_stats"]}, *args))
    with torch.no_grad():
        got = _nhwc(td(_nchw(x), wvs))
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_spectral_norm_conv_gradient_matches_jax_grad():
    """Kernel, bias and input gradients of sum(r · SN-conv(x)): the gradient
    reaches the kernel through σ as well."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            conv = fnn.Conv(8, (4, 4), strides=(2, 2), padding=((1, 1), (1, 1)), name="c")
            return fnn.SpectralNorm(conv, collection_name="spectral_stats")(
                x, update_stats=False)

    g = np.random.default_rng(3)
    x = g.standard_normal((2, 12, 12, 5)).astype(np.float32)
    r = g.standard_normal((2, 6, 6, 8)).astype(np.float32)
    net = Net()
    v = _drawn(net, jnp.asarray(x), seed=4)

    def f(params, x):
        return jnp.sum(jnp.asarray(r) * net.apply({**v, "params": params}, x))

    (jgrads, jdx) = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(x))
    conv = gan.SpectralNormConv4x4(5, 8, 2, True)
    conv.load_state_dict({"weight": torch.from_numpy(v["params"]["c"]["kernel"].transpose(3, 2, 0, 1)),
                          "bias": torch.from_numpy(v["params"]["c"]["bias"]),
                          "u": torch.from_numpy(v["spectral_stats"]["SpectralNorm_0"]["c/kernel/u"]),
                          "sigma": torch.from_numpy(
                              v["spectral_stats"]["SpectralNorm_0"]["c/kernel/sigma"])})
    xt = _nchw(x).requires_grad_()
    (conv(xt) * _nchw(r)).sum().backward()
    torch.testing.assert_close(conv.weight.grad.permute(2, 3, 1, 0),
                               torch.from_numpy(np.array(jgrads["c"]["kernel"])),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(conv.bias.grad, torch.from_numpy(np.asarray(jgrads["c"]["bias"])),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xt.grad, _nchw(jdx), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_weight", [2.0, 0.05])
def test_adaptive_weight_matches_jax_on_a_closure_pair(max_weight):
    """rec(k) = mean|conv(h, k) + b − t| and gan(k) = −mean(D(conv(h, k) + b)):
    the port differentiates the two terms' graph, JAX the closures."""
    import jax
    import jax.numpy as jnp

    from eovax.losses.gan import adaptive_weight as jax_adaptive_weight
    from eovax.nn.dynamic_conv import apply_dynamic_kernel as jax_apply

    jd, v, td = _discs("patch")
    g = np.random.default_rng(4)
    h = g.standard_normal((2, 16, 16, 8)).astype(np.float32)
    k = (0.1 * g.standard_normal((3, 3, 8, 4))).astype(np.float32)
    b = (0.1 * g.standard_normal(4)).astype(np.float32)
    t = g.standard_normal((2, 16, 16, 4)).astype(np.float32)
    wvs = jnp.asarray(WVS)

    def recon_fn(kk):
        return jax_apply(jnp.asarray(h), kk, jnp.asarray(b))

    ref = jax.jit(lambda kk: jax_adaptive_weight(
        lambda k2: jnp.mean(jnp.abs(recon_fn(k2) - t)),
        lambda k2: -jnp.mean(jd.apply(v, recon_fn(k2), wvs)),
        kk, eps=1e-4, max_weight=max_weight))(jnp.asarray(k))
    kernel = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    recon = apply_dynamic_kernel(_nchw(h), kernel, torch.from_numpy(b))
    got = gan.adaptive_weight((recon - _nchw(t)).abs().mean(),
                              -td(recon, torch.from_numpy(WVS)).mean(), kernel, eps=1e-4,
                              max_weight=max_weight)
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert (got.item() == np.float32(max_weight)) == (max_weight == 0.05)


# -- the composite losses ---------------------------------------------------------------------


def _closure_inputs(size, seed=5):
    g = np.random.default_rng(seed)
    h = g.standard_normal((2, size, size, 8)).astype(np.float32)
    k = (0.2 * g.standard_normal((3, 3, 8, 4))).astype(np.float32)
    b = (0.1 * g.standard_normal(4)).astype(np.float32)
    t = g.standard_normal((2, size, size, 4)).astype(np.float32)
    return h, k, b, t


def _compare_losses(jloss, tloss, jd, v, td, size, global_step, lpips=None):
    """Generator loss (with and without the kernel) and discriminator loss with
    their logs, JAX against the port."""
    import jax
    import jax.numpy as jnp

    from eovax.nn.dynamic_conv import apply_dynamic_kernel as jax_apply

    h, k, b, t = _closure_inputs(size)
    jwvs, twvs = jnp.asarray(WVS), torch.from_numpy(WVS)

    def recon_fn(kk):
        return jax_apply(jnp.asarray(h), kk, jnp.asarray(b))

    kernel = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    recon = apply_dynamic_kernel(_nchw(h), kernel, torch.from_numpy(b))
    for closure in (True, False):
        ref, rlogs = jax.jit(lambda kk, closure=closure: jloss.generator_loss(
            v, jnp.asarray(t), jwvs, recon_fn(kk), global_step=global_step,
            kernel_closure=(recon_fn, kk) if closure else None))(jnp.asarray(k))
        got, logs = tloss.generator_loss(td, _nchw(t), twvs, recon, global_step=global_step,
                                         kernel=kernel if closure else None)
        assert sorted(logs) == sorted(rlogs)
        np.testing.assert_allclose(got.item(), float(ref), **TOL)
        for key, value in rlogs.items():
            np.testing.assert_allclose(logs[key].item(), float(value), **TOL, err_msg=key)
    ref, rlogs = jax.jit(lambda kk: jloss.discriminator_loss(v, jnp.asarray(t), jwvs,
                                                             recon_fn(kk)))(jnp.asarray(k))
    got, logs = tloss.discriminator_loss(td, _nchw(t), twvs, recon)
    assert sorted(logs) == sorted(rlogs)
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    for key, value in rlogs.items():
        np.testing.assert_allclose(logs[key].item(), float(value), **TOL, err_msg=key)


@pytest.mark.parametrize("ssim_weight,size,step", [(0.0, 32, 5), (0.2, 96, 5), (0.0, 32, 0)])
def test_patch_loss_matches_jax(ssim_weight, size, step):
    """EOPatchLoss: MS-SSIM off at 32² and on at 96² (five scales need more
    than 64 pixels); the GAN term gated off before disc_start."""
    from eovax.losses.gan import EOPatchLoss as JaxPatchLoss

    jd, v, td = _discs("patch")
    kw = dict(disc_start=3, disc_weight=0.5, ssim_weight=ssim_weight)
    jloss = JaxPatchLoss(disc_apply=lambda dv, x, wv: jd.apply(dv, x, wv), **kw)
    _compare_losses(jloss, gan.EOPatchLoss(**kw), jd, v, td, size, step)


@pytest.mark.parametrize("loss_type", ["hinge", "vanilla"])
def test_generative_loss_matches_jax(loss_type):
    """EOGenerativeLoss with FFL and a perceptual term (a stand-in function on
    both sides): the adaptive weight differentiates the whole rec loss."""
    import jax.numpy as jnp

    from eovax.losses.gan import EOGenerativeLoss as JaxGenLoss

    jd, v, td = _discs("nlayer")
    kw = dict(perceptual_weight=0.5, disc_weight=0.9, gan_start_step=0, max_d_weight=1e4,
              disc_loss_type=loss_type, focal_loss_weight=1.0, focal_loss_alpha=1.0)
    jloss = JaxGenLoss(disc_apply=lambda dv, x, wv: jd.apply(dv, x, wv),
                       lpips_apply=lambda a, r, w: jnp.mean((jnp.tanh(r) - jnp.tanh(a)) ** 2),
                       **kw)
    tloss = gan.EOGenerativeLoss(
        lpips_apply=lambda a, r, w: ((torch.tanh(r) - torch.tanh(a)) ** 2).mean(), **kw)
    _compare_losses(jloss, tloss, jd, v, td, 32, 2)


# -- forward_gan ------------------------------------------------------------------------------


@pytest.mark.parametrize("dynamic", [True, False])
def test_forward_gan_matches_jax(dynamic):
    """recon, h_pre, the generated output stem and the updated latent statistics
    in train mode (the posterior's mode); a static decoder returns no kernel."""
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.models.backbone import EOVAECore as JaxCore

    over = {} if dynamic else dict(
        decoder=dataclasses.replace(_cfg(jcfg).decoder, use_dynamic_ops=False))
    jc = dataclasses.replace(_cfg(jcfg), **over)
    tc = dataclasses.replace(_cfg(tcfg), **({} if dynamic else dict(
        decoder=dataclasses.replace(_cfg(tcfg).decoder, use_dynamic_ops=False))))
    jm, variables = _jax_vae(jc)
    image = np.random.default_rng(6).standard_normal((2, 32, 32, 4)).astype(np.float32)
    (recon, _, h_pre, kernel, bias), mutated = jax.jit(functools.partial(
        jm.core.apply, sample_posterior=False, train=True, method=JaxCore.forward_gan,
        mutable=["batch_stats"]))(variables, jnp.asarray(image), jnp.asarray(WVS))
    core = EOFluxVAE(tc, state_dict_from_variables(variables), device="cpu").core.train()
    out = core.forward_gan(_nchw(image), torch.from_numpy(WVS), sample_posterior=False,
                           train=True)
    np.testing.assert_allclose(_nhwc(out[0]), np.asarray(recon), **ACT_TOL)
    np.testing.assert_allclose(_nhwc(out[2]), np.asarray(h_pre), **ACT_TOL)
    if dynamic:
        np.testing.assert_allclose(out[3].detach().permute(2, 3, 1, 0).numpy(),
                                   np.asarray(kernel), **TOL)
        np.testing.assert_allclose(out[4].detach().numpy(), np.asarray(bias), **TOL)
        assert out[3].grad_fn is not None  # the generated, non-leaf kernel
    else:
        assert out[3] is None and out[4] is None and kernel is None
    stats = state_dict_from_variables(jax.tree_util.tree_map(np.asarray, mutated))
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(core.state_dict()[key], stats[key], **TOL)
    # The same pass as forward's: the same reconstruction from the same start.
    core.load_state_dict(state_dict_from_variables(variables))
    recon2, _ = core(_nchw(image), torch.from_numpy(WVS), sample_posterior=False, train=True)
    assert torch.equal(recon2, out[0])


# -- the adversarial steps against make_adversarial_steps --------------------------------------


def _assert_params_close(got: dict, ref: dict, start: dict, label: str,
                         far_share: float = PARAM_FAR_SHARE) -> None:
    far = total = moved = 0
    for key, value in ref.items():
        if key.startswith("bn.") or key.endswith((".u", ".sigma")):
            continue
        diff = (got[key] - value.reshape(got[key].shape)).abs()
        assert diff.max().item() <= PARAM_ATOL, (label, key)
        far += int((diff > PARAM_CLOSE).sum())
        total += diff.numel()
        moved += int((got[key] != start[key]).sum())
    assert far <= far_share * total, (label, far, total)
    assert moved > 0, label


def _batches(n, size=32, modalities=("S2RGB",), seed=0, batch=2):
    return list(synthetic_terramesh_batches(batch_size=batch, target_size=(size, size),
                                            modalities=modalities, seed=seed, num_batches=n))


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX trainer over three S2RGB batches at 32², EOPatchLoss over a
    DynamicPatchGAN seeded from the encoder stem (disc_start 1: the first step
    trains the generator alone), log_every 1. Its steps are the ``gen_step`` and
    ``disc_step`` of eovax's ``make_adversarial_steps``; it starts from
    ``init_state``'s state with every variable drawn (the discriminator's eager
    init skipped, its stem seeded from the encoder's, as ``init_state`` seeds
    it). Returns the drawn variables, the CSV rows and the final state."""
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.losses.factory import build_loss_from_config as jax_build
    from eovax.parallel.mesh import make_mesh
    from eovax.train import stage2 as jstage2
    from eovax.utils.logging import CSVLogger as JaxCSVLogger

    jc = _cfg(jcfg)
    jm, variables = _jax_vae(jc)
    jloss, jdisc, seed_stem = jax_build(PATCH_CFG, jc)
    assert seed_stem
    log_dir = tmp_path_factory.mktemp("jax_fit")
    jtrainer = jstage2.Stage2Trainer(model=jm, loss_obj=jloss, cfg=jc, discriminator=jdisc,
                                     seed_disc_stem=True, mesh=make_mesh(jax.devices()[:1]),
                                     logger=JaxCSVLogger(str(log_dir)), max_steps=STEPS,
                                     log_every=1, seed=0)
    disc_vars = _jax_disc_vars(jdisc, len(WVS), seed=7)
    disc_vars["params"]["dynamic_input"] = variables["params"]["encoder"]["conv_in"]
    params, dparams = (jax.tree_util.tree_map(jnp.asarray, t)
                       for t in (variables["params"], disc_vars))
    state = jstage2.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=jtrainer.tx.init(params), disc_params=dparams,
        disc_opt_state=jtrainer.disc_tx.init(dparams["params"]))
    state = jax.tree_util.tree_map(np.asarray, jtrainer.fit(iter(_batches(STEPS)), state=state))
    return dict(variables=variables, disc_vars=disc_vars,
                rows=_csv_rows(log_dir / "metrics.csv"),
                final=state_dict_from_variables({"params": state.params,
                                                 "batch_stats": state.batch_stats}),
                disc=discriminator_state_dict(state.disc_params))


def _port(jax_fit):
    """The port's model, loss, discriminator and optimizers on the JAX fit's start."""
    cfg = _cfg(tcfg)
    model = EOFluxVAE(cfg, state_dict_from_variables(jax_fit["variables"]), device="cpu")
    loss, disc, seed_stem = build_loss_from_config(PATCH_CFG, cfg)
    disc.load_state_dict(discriminator_state_dict(jax_fit["disc_vars"]), strict=True)
    return cfg, model, loss, disc, seed_stem


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def trajectory(jax_fit):
    return _trajectory(jax_fit)


def _trajectory(jax_fit):
    """The port's ``make_adversarial_steps`` over the JAX fit's batches, with the
    trainer's gate (the discriminator from disc_start on)."""
    cfg, model, loss, disc, _ = _port(jax_fit)
    disc_start = {k: v.clone() for k, v in disc.state_dict().items()}
    opt, schedule = stage2.make_optimizer(cfg, model.core.parameters(), total_steps=STEPS)
    dopt = stage2.ClippedAdam(disc.parameters(), cfg.base_lr, clip_grad=None)
    gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, opt, disc, dopt, cfg,
                                                        schedule=schedule)
    state, logs, grads_kept = stage2.TrainState(), [], []
    for i, batch in enumerate(_batches(STEPS)):
        image = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).contiguous()
        wvs = torch.from_numpy(batch["wvs"])
        before = [None if p.grad is None else p.grad.clone() for p in disc.parameters()]
        log, recon, target = gen_step(state, image, wvs)
        grads_kept.append(all(
            (a is None and p.grad is None) or (a is not None and torch.equal(a, p.grad))
            for a, p in zip(before, disc.parameters())))
        assert not recon.requires_grad and not target.requires_grad
        if i >= loss.disc_start:
            log.update(disc_step(state, target, wvs, recon))
        logs.append({k: float(v) for k, v in log.items()})
    return dict(logs=logs, final=model.core.state_dict(), disc=disc.state_dict(),
                disc_start=disc_start, grads_kept=grads_kept)


def _assert_logs_match(rows: list[dict], logs: list[dict]) -> None:
    assert len(rows) == len(logs) == STEPS
    for row, log in zip(rows, logs):
        keys = sorted(k for k, v in row.items() if k.startswith("train/") and v
                      and k != "train/steps_per_sec")
        assert keys == sorted(log)
        for key in keys:
            np.testing.assert_allclose(log[key], float(row[key]), **TOL,
                                       err_msg=f"{key} at step {row['step']}")


def test_trajectory_logs_match_jax(jax_fit, trajectory):
    logs = trajectory["logs"]
    _assert_logs_match(jax_fit["rows"], logs)
    assert "train/loss_disc" not in logs[0] and "train/loss_disc" in logs[1]
    assert logs[0]["train/disc_weight"] == 0.0 and 0.0 < logs[1]["train/disc_weight"] <= 2.0


def test_trajectory_generator_parameters_match_jax(jax_fit, trajectory):
    start = state_dict_from_variables(jax_fit["variables"])
    _assert_params_close(trajectory["final"], jax_fit["final"], start, "generator")
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(trajectory["final"][key], jax_fit["final"][key], **TOL)


def test_trajectory_discriminator_and_spectral_stats_match_jax(jax_fit, trajectory):
    """The discriminator's parameters, its u and σ, and its logits with either
    side's final weights on one batch."""
    _assert_params_close(trajectory["disc"], jax_fit["disc"], trajectory["disc_start"],
                         "discriminator", DISC_FAR_SHARE)
    for key, ref in jax_fit["disc"].items():
        if key.endswith((".u", ".sigma")):
            torch.testing.assert_close(trajectory["disc"][key], ref, rtol=1e-5, atol=1e-6)
            assert not torch.equal(trajectory["disc"][key], trajectory["disc_start"][key]), key
    # The logits with the final weights: the port is as close to JAX as to itself
    # run from a start moved by 1e-6 of each entry (Adam's amplified round-off).
    g = np.random.default_rng(0)
    moved = dict(jax_fit, disc_vars=_map(
        lambda a: np.asarray(a * (1 + 1e-6 * g.standard_normal(a.shape)), np.float32),
        jax_fit["disc_vars"]))
    batch = _batches(1, seed=5)[0]
    x = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    logits = []
    for state in (trajectory["disc"], jax_fit["disc"], _trajectory(moved)["disc"]):
        disc = build_loss_from_config(PATCH_CFG, _cfg(tcfg))[1]
        disc.load_state_dict(state)
        with torch.no_grad():
            logits.append(disc(x, torch.from_numpy(batch["wvs"])))
    to_jax, to_self = ((logits[0] - ref).abs().max().item() for ref in logits[1:])
    assert 0 < to_self and to_jax <= 4 * to_self, (to_jax, to_self)
    assert to_jax <= 1e-3 * logits[1].abs().max().item()


def test_generator_step_leaves_no_gradient_in_the_discriminator(trajectory):
    """Each generator step leaves the discriminator's gradients as it found them:
    none before its first step, its own step's after that."""
    assert trajectory["grads_kept"] == [True] * STEPS


# -- the trainer --------------------------------------------------------------------------------


def test_fit_matches_the_jax_trainer(tmp_path, jax_fit, trajectory):
    """``Stage2Trainer.fit`` on the JAX fit's batches: the CSV rows (header order,
    the generator's and the discriminator's keys, values) of both trainers, and
    a final state equal bit for bit to the port's trajectory's.

    The multi-step comparisons use the DynamicPatchGAN: the NLayerDiscriminator's
    stem (128 wavelength planes, a 2048-wide feed-forward) has about 0.25 % of
    its entries with gradients near 1e-4 of their tensor's largest, whose first
    Adam step takes the sign of either side's round-off (ROADMAP Queue 3, kept
    difference 7), and the adaptive weight moved 0.6 % with them a step later.
    EOGenerativeLoss and the NLayerDiscriminator are held a step at a time by
    the loss tests above."""
    from eovax_torch.utils.logging import CSVLogger

    cfg, model, loss, disc, seed_stem = _port(jax_fit)
    trainer = stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, discriminator=disc,
                                   seed_disc_stem=seed_stem, max_steps=STEPS, log_every=1,
                                   logger=CSVLogger(str(tmp_path)), seed=0)
    assert trainer.fit(iter(_batches(STEPS))).step == STEPS
    rows = _csv_rows(tmp_path / "metrics.csv")
    assert list(rows[0]) == list(jax_fit["rows"][0])
    assert [r["step"] for r in rows] == [str(i + 1) for i in range(STEPS)]
    _assert_logs_match(jax_fit["rows"], [
        {k: float(v) for k, v in r.items() if k.startswith("train/") and v
         and k != "train/steps_per_sec"} for r in rows])
    for got, ref in ((model.core.state_dict(), trajectory["final"]),
                     (disc.state_dict(), trajectory["disc"])):
        for key, value in ref.items():
            assert torch.equal(got[key], value), key


def test_trainer_seeds_the_stem_and_validates_with_the_discriminator(tmp_path):
    cfg = _cfg(tcfg)
    model = EOFluxVAE(cfg, device="cpu", seed=2)
    loss, disc, seed_stem = build_loss_from_config(PATCH_CFG, cfg, seed=2)
    trainer = stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, discriminator=disc,
                                   seed_disc_stem=seed_stem, log_every=0)
    for key, value in model.core.encoder.conv_in.state_dict().items():
        assert torch.equal(disc.dynamic_input.state_dict()[key], value), key
    assert not disc.training
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    means = trainer.validate(stage2.TrainState(step=5),
                             iter(_batches(2, size=32, modalities=("S2L2A",))), max_batches=2)
    assert sorted(means) == ["val/disc_weight", "val/logits_fake_g", "val/loss_g",
                             "val/loss_msssim", "val/loss_rec"]
    assert means["val/disc_weight"] == 1.0  # no kernel in validation: weight 1
    assert all(torch.equal(before[k], v) for k, v in disc.state_dict().items())


def _resume_trainer(ckpt_dir, variables, disc_state):
    cfg = _cfg(tcfg)
    model = EOFluxVAE(cfg, variables, device="cpu")
    loss, disc, _ = build_loss_from_config(PATCH_CFG, cfg)
    disc.load_state_dict(disc_state)
    return stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, discriminator=disc,
                                seed_disc_stem=True, max_steps=4, accumulate_steps=2,
                                log_every=0, ckpt_dir=str(ckpt_dir))


def test_resume_with_the_discriminator_is_bit_exact(tmp_path):
    """Four micro-steps (two generator updates, three discriminator updates)
    straight, and stopped after step 3 (the accumulator holds a gradient, the
    discriminator has taken two steps) and resumed by a fresh trainer: the
    model, Adam's and the accumulator's state, the discriminator's parameters,
    its spectral-norm u and σ and its Adam state equal bit for bit."""
    variables = EOFluxVAE(_cfg(tcfg), device="cpu", seed=3).core.state_dict()
    disc_state = build_loss_from_config(PATCH_CFG, _cfg(tcfg), seed=5)[1].state_dict()
    batches = _batches(4, size=32, modalities=("S2L2A", "S1RTC", "S2RGB"), seed=11)
    straight = _resume_trainer(tmp_path / "straight", variables, disc_state)
    assert straight.fit(iter(batches)).step == 4
    first = _resume_trainer(tmp_path / "stopped", variables, disc_state)
    assert first.fit(iter(batches[:3])).step == 3
    saved = checkpoint.TrainCheckpointer(str(tmp_path / "stopped")).restore_latest()
    assert saved["step"] == 3 and saved["disc_optimizer"]["count"] == 2
    assert "final.sigma" in saved["discriminator"]
    assert any(a.abs().sum() > 0 for a in first.optimizer.acc)
    second = _resume_trainer(tmp_path / "stopped", variables, disc_state)
    assert second.fit(iter(batches[3:])).step == 4
    for a, b in ((straight.core, second.core), (straight.discriminator, second.discriminator)):
        for name, value in a.state_dict().items():
            assert torch.equal(b.state_dict()[name], value), name
    for a, b in ((straight.optimizer, second.optimizer),
                 (straight.disc_optimizer, second.disc_optimizer)):
        sa, sb = a.state_dict(), b.state_dict()
        assert (sa["count"], sa["mini_step"]) == (sb["count"], sb["mini_step"])
        for key in ("mu", "nu", "acc"):
            assert all(torch.equal(x, y) for x, y in zip(sa[key], sb[key], strict=True)), key
    assert straight.disc_optimizer.count == 3 and straight.optimizer.count == 2


# -- the factory, the bridge and the CLI --------------------------------------------------------


def test_factory_disables_the_absent_perceptual_term(capsys):
    """finetune_dyn_conv_rgb.yaml: DOFA's checkpoint is not on disk, so the
    perceptual term is off with the JAX factory's message (the fields against
    the JAX factory's: tests/test_torch_trainer.py)."""
    from eovax_torch.core.config import load_yaml

    raw = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                 "finetune_dyn_conv_rgb.yaml"))
    loss, disc, seed_stem = build_loss_from_config(raw["model"]["loss_fn"],
                                                   tcfg.VAEConfig.from_dict(raw))
    assert isinstance(loss, gan.EOGenerativeLoss) and isinstance(disc, gan.NLayerDiscriminator)
    assert loss.perceptual_weight == 0.0 and loss.lpips_apply is None and not seed_stem
    assert loss.gan_start_step == 2000 and loss.disc_update_start_step == 1000
    assert "not found — perceptual/feature term disabled" in capsys.readouterr().out


def test_factory_raises_for_a_present_dofa_checkpoint_and_unknown_keys(tmp_path):
    """A present DOFA checkpoint builds the perceptual term (a frozen DOFALPIPS
    over the file's weights; the term against the JAX package's:
    tests/test_torch_dofa.py); unknown keys raise."""
    from eovax_torch.models import dofa

    cfg = _cfg(tcfg)
    net = dict(img_size=28, embed_dim=32, depth=2, num_heads=4, wv_planes=32, out_indices=[0, 1])
    vit, _ = dofa.dofav2_base_patch14_224(**net)
    torch.save({f"model.{k}": v for k, v in vit.state_dict().items()}, tmp_path / "dofa.pth")
    lpips = {"dofa_net": {"_target_": "eo_vae.models.dofa.dofav2_base_patch14_224",
                          "ckpt_data": str(tmp_path / "dofa.pth"), **net}}
    loss = build_loss_from_config({**GEN_CFG, "lpips": lpips}, cfg)[0]
    assert loss.perceptual_weight == 1.0 and isinstance(loss.lpips_apply, dofa.DOFALPIPS)
    assert not loss.lpips_apply.training
    for key, value in vit.state_dict().items():
        assert torch.equal(loss.lpips_apply.dofa.state_dict()[key], value), key
    with pytest.raises(ValueError, match="Unknown DynamicPatchGAN"):
        build_loss_from_config({**PATCH_CFG, "discriminator": {"width": 3}}, cfg)
    with pytest.raises(ValueError, match="Unknown EOPatchLoss"):
        build_loss_from_config({**PATCH_CFG, "lpips": {}}, cfg)
    with pytest.raises(ValueError, match="expects an NLayerDiscriminator"):
        build_loss_from_config({**GEN_CFG, "discriminator": {"_target_": "x.DynamicPatchGAN"}},
                               cfg)


def test_train_cli_on_a_shrunk_finetune_gan(tmp_path):
    """``main --device cpu`` on finetune_gan.yaml shrunk to the tiny VAE at 32²
    (disc_start 0, MS-SSIM off: five scales need more than 64 pixels): the
    discriminator's keys in the CSV, its state in the checkpoints, and
    ``eo-vae-final.pt``."""
    import yaml

    from eovax_torch.cli import train
    from eovax_torch.core.config import load_yaml

    raw = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                 "finetune_gan.yaml"))
    stem = {"num_layers": 1, "wv_planes": 32}
    for part in ("encoder", "decoder"):
        raw["model"][part].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=8,
                                  dynamic_conv_kwargs=stem)
    raw["model"]["loss_fn"].update(disc_start=0, ssim_weight=0.0)
    raw["model"].update(decay_end_epoch=1)
    raw["experiment"]["exp_dir"] = str(tmp_path / "exps")
    raw["datamodule"].update(modalities=["S2L2A", "S1RTC"], batch_size=2, eval_batch_size=2,
                             target_size=[32, 32])
    raw["trainer"].update(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
                          log_every_n_steps=1)
    config = tmp_path / "gan.yaml"
    config.write_text(yaml.safe_dump(raw))
    train.main(["--config", str(config), "--synthetic-data", "--max-steps", "2", "--device",
                "cpu", "--precision", "32-true"])
    (exp,) = (tmp_path / "exps").iterdir()
    for name in ("metrics.csv", "eo-vae-final.pt", "eo-vae-best.pt"):
        assert (exp / name).exists(), name
    rows = _csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2", "2"]
    assert all(rows[i]["train/loss_disc"] and rows[i]["train/loss_g"] for i in (0, 1))
    assert rows[2]["val/loss_rec"] and rows[2]["val/logits_fake_g"]
    saved = checkpoint.TrainCheckpointer(str(exp / "checkpoints")).restore_latest()
    assert saved["step"] == 2 and "block_0.u" in saved["discriminator"]
    assert saved["disc_optimizer"]["count"] == 2


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("loss_cfg", [PATCH_CFG, GEN_CFG], ids=["patch", "generative"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_adversarial_step_on_card_matches_cpu(cuda_device, precision, loss_cfg, monkeypatch):
    """One generator + discriminator step of the tiny model on the card (every
    conv3x3 and GroupNorm through the hand kernels, both ways, and nothing
    more: the adaptive weight and the discriminator run no generator kernel)
    against fp32 on the CPU: the generator's and the discriminator's
    gradients, the adaptive weight (EOPatchLoss's sits at its clamp, 2.0, in
    this model; EOGenerativeLoss's, ~15, does not) and the spectral-norm u and
    σ, each within 1e-3 in fp32 and 1e-1 in bf16.

    fp32 runs the step at the GAN's start step. bf16 runs it one step before,
    where the GAN term is gated off (its backward still runs, so the launches
    are the same) and the generator's gradient is the reconstruction term's:
    with the term on, bf16 alone moves the tiny model's generator gradients by
    18-21 % on the CPU, since the term holds most of them and its input
    gradient through the small random discriminator cancels in the sums over
    pixels. The weight is read where the loss computes it, before the gate."""
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.kernels import attention, conv3x3, groupnorm
    from eovax_torch.nn.blocks import AttnBlock, Conv3x3, GroupNorm

    FULL_PRECISION.activate()
    cfg = _cfg(tcfg)
    variables = EOFluxVAE(cfg, device="cpu", seed=0).core.state_dict()
    disc_state = build_loss_from_config(loss_cfg, cfg, seed=4)[1].state_dict()
    image = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 4, 64, 64)).astype(np.float32))
    weights = []
    weight_fn = gan.adaptive_weight

    def recorded_weight(*args, **kw):
        weights.append(weight_fn(*args, **kw))
        return weights[-1]

    monkeypatch.setattr(gan, "adaptive_weight", recorded_weight)
    start = loss_cfg.get("disc_start", loss_cfg.get("gan_start_step"))
    step = start if precision == "fp32" else start - 1
    results = []
    for device, policy in (("cpu", FULL_PRECISION),
                           (cuda_device, FULL_PRECISION if precision == "fp32"
                            else DEFAULT_POLICY)):
        model = EOFluxVAE(cfg, variables, policy=policy, device=device)
        loss, disc, _ = build_loss_from_config(loss_cfg, cfg, policy=policy)
        disc.load_state_dict(disc_state)
        disc.to(device)
        keep = types.SimpleNamespace(zero_grad=lambda: None, step=lambda: torch.zeros(()))
        gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, keep, disc, keep,
                                                            cfg)
        counters = (conv3x3.conv3x3, conv3x3.conv3x3_dx, groupnorm.group_norm,
                    groupnorm.group_norm_backward)
        before = [f.launches for f in counters] + [attention.flash_attention.launches,
                                                   attention.flash_attention_backward.calls]
        state = stage2.TrainState(step=step)
        wvs = torch.from_numpy(WVS).to(device)
        weights.clear()
        _, recon, target = gen_step(state, image.to(device), wvs)
        grads = {f"g.{n}": p.grad.float().cpu() for n, p in model.core.named_parameters()}
        disc_step(state, target, wvs, recon)
        grads.update({f"d.{n}": p.grad.float().cpu() for n, p in disc.named_parameters()})
        if device != "cpu":
            torch.cuda.synchronize()
            n_conv = sum(isinstance(m, Conv3x3) for m in model.core.modules())
            n_gn = sum(isinstance(m, GroupNorm) for m in model.core.modules())
            n_attn = sum(isinstance(m, AttnBlock) for m in model.core.modules())
            after = [f.launches for f in counters] + [attention.flash_attention.launches,
                                                      attention.flash_attention_backward.calls]
            assert [a - b for a, b in zip(after, before)] == [n_conv, n_conv, n_gn, n_gn,
                                                              n_attn, n_attn]
        stats = {k: v.cpu() for k, v in disc.state_dict().items() if k.endswith((".u", ".sigma"))}
        (weight,) = weights
        results.append((grads, weight.item(), stats))

    (g, w, st), (rg, rw, rst) = results[1], results[0]
    card = {"weight": abs(w - rw) / abs(rw)}
    for prefix in ("g.", "d."):
        keys = [k for k in rg if k.startswith(prefix)]
        norm = torch.sqrt(sum(rg[k].double().square().sum() for k in keys))
        diff = torch.sqrt(sum((g[k].double() - rg[k].double()).square().sum() for k in keys))
        card[prefix] = (diff / norm).item()
    for key, value in rst.items():
        card[key] = ((st[key] - value).norm() / value.norm()).item()
    assert len(rst) == (6 if loss_cfg is PATCH_CFG else 0)
    tol = 1e-3 if precision == "fp32" else 1e-1
    assert all(v <= tol for v in card.values()), card
