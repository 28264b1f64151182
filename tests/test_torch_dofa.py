"""The port's DOFA against the JAX package's, on the CPU in fp32.

Tiny models (embed 32, depth 3, 4 heads, 32 wavelength planes, 28²-64²) whose
JAX variables are drawn from numpy by the shapes of their traced init and
carried over by ``dofa_state_dict`` with ``strict=True``: the position
embedding, the patch embed at patch 14 and 16 and 14→16, the ViT block with
and without LayerScale and RoPE, the three families (v2 also at a grid that
resamples its position embedding, v3 in both RoPE conventions), DOFALPIPS
with its gradient, the discriminator and the wavelength tables. A ``.pth``
written by ``torch.save`` in the reference's key layout goes through the
port's loader and the JAX package's for each family. Both factories build the
perceptual and feature terms from one config, and a 2-step adversarial fit and
the train CLI run with the perceptual term on.

Tolerances, each relative to the largest reference entry: TOL (2e-6) for
activations in fp32 through a few layers (the sums run in other orders, and
XLA's and torch's fp32 sin/cos/pow of the RoPE and sin/cos embeddings differ
in the last ulp); GRAD_TOL (1e-5) for gradients through the whole ViT.

JAX is imported only inside the tests that need it, so the card's machine
runs the ``gpu`` test without it:

    python -m pytest tests/test_torch_dofa.py -m gpu --noconftest
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import test_torch_gan as tg
from eovax_torch.losses.factory import build_loss_from_config
from eovax_torch.models import dofa
from eovax_torch.nn.init import init_parameters
from eovax_torch.utils.convert import dofa_state_dict, state_dict_from_variables

TOL = 2e-6
GRAD_TOL = 1e-5
WVS = np.asarray([0.665, 0.56, 0.49, 0.842, 1.61], np.float32)
TINY = dict(embed_dim=32, depth=3, num_heads=4, wv_planes=32)
FAMILIES = {
    "v1": ("OFAViT", dict(img_size=32, patch_size=16, out_indices=(0, 2), **TINY)),
    "v2": ("DOFAViTv2", dict(img_size=28, patch_size=14, out_indices=(0, 2), **TINY)),
    "v3": ("DOFAViTv3", dict(img_size=32, patch_size=16, out_indices=(0, 1), num_reg_tokens=2,
                             **TINY)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, tol=TOL, label=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (label, err, np.abs(ref).max())


def _images(n, size, bands=len(WVS), seed=0):
    """NHWC numpy images and their NCHW tensor."""
    x = np.random.default_rng(seed).standard_normal((n, size, size, bands)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _draw(module, *args, seed=1, method=None):
    """Variables of a flax module drawn from numpy by the shapes of its traced
    init: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), LayerScale gains
    N(0.5, 0.1) (so that every branch counts), the cls/register tokens and the
    position embedding N(0, 0.5), LPIPS weights U(0, 2/D), every other leaf
    N(0, 0.02); v1's constant position embedding as its init computes it."""
    import jax

    from eovax.models.dofa import get_2d_sincos_pos_embed

    g = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if name == "kernel":
            a = g.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            a = 1.0 + g.normal(0.0, 0.1, shape)
        elif name == "gamma":
            a = g.normal(0.5, 0.1, shape)
        elif name in ("cls_token", "reg_token", "pos_embed"):
            a = g.normal(0.0, 0.5, shape)
        elif name.startswith("lin_"):
            a = g.uniform(0.0, 2.0 / shape[0], shape)
        else:
            a = g.normal(0.0, 0.02, shape)
        return np.asarray(a, np.float32)

    shapes = jax.eval_shape(functools.partial(module.init, method=method),
                            jax.random.PRNGKey(0), *args)
    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    if "constants" in variables:  # v1's sin/cos table, under the ViT or its "dofa" child
        vit = getattr(module, "dofa", module)
        table = get_2d_sincos_pos_embed(vit.embed_dim, vit.img_size // vit.patch_size)
        consts = variables["constants"]
        (consts["dofa"] if "dofa" in consts else consts)["pos_embed"] = table
    return variables


def _pair(family, **over):
    """A JAX ViT of ``family`` and the port's, both of ``FAMILIES``' tiny size."""
    from eovax.models import dofa as jdofa

    name, kw = FAMILIES[family]
    kw = {**kw, **over}
    return getattr(jdofa, name)(**kw), getattr(dofa, name)(**kw)


@functools.lru_cache(maxsize=None)
def _drawn_vit(family):
    """A JAX ViT with drawn variables, and the port's copy of it."""
    import jax.numpy as jnp

    jvit, tvit = _pair(family)
    x = jnp.zeros((1, jvit.img_size, jvit.img_size, len(WVS)))
    variables = _draw(jvit, x, jnp.asarray(WVS))
    tvit.load_state_dict(dofa_state_dict(variables), strict=True)
    return jvit, variables, tvit.eval()


def _taps_method(jvit):
    return getattr(type(jvit), "forward_lpips", type(jvit).forward_features)


# -- the parts ----------------------------------------------------------------------------------


@pytest.mark.parametrize("grid,cls_token", [(4, True), (16, True), (7, False)])
def test_sincos_pos_embed_equals_jax(grid, cls_token):
    from eovax.models.dofa import get_2d_sincos_pos_embed

    np.testing.assert_array_equal(dofa.get_2d_sincos_pos_embed(48, grid, cls_token),
                                  get_2d_sincos_pos_embed(48, grid, cls_token))


@pytest.mark.parametrize("kernel,convert,size", [(14, False, 28), (16, False, 32), (14, True, 48),
                                                 (14, False, 64)])
def test_patch_embed_matches_jax(kernel, convert, size):
    """Tokens and wavelength features; patch 14 at 28² and 64² (the odd padding:
    a 2×2 and a 4×4 grid), 16 at 32², and 14 resized to 16 at 48²."""
    import jax.numpy as jnp

    from eovax.models.dofa import DynamicPatchEmbed as JaxEmbed

    kw = dict(wv_planes=32, embed_dim=32, kernel_size=kernel, convert_patch_14_to_16=convert)
    jm = JaxEmbed(**kw)
    x, tx = _images(2, size)
    variables = _draw(jm, jnp.asarray(x), jnp.asarray(WVS))
    tm = dofa.DynamicPatchEmbed(**kw)
    tm.load_state_dict(dofa_state_dict(variables), strict=True)
    tokens, waves = jm.apply(variables, jnp.asarray(x), jnp.asarray(WVS))
    got_tokens, got_waves = tm(tx, torch.from_numpy(WVS))
    grid = (size + 2 - (16 if convert else kernel)) // (16 if convert else kernel) + 1
    assert got_tokens.shape == (2, grid * grid, 32)
    _close(got_tokens, tokens, label="tokens")
    _close(got_waves, waves, label="waves")


@pytest.mark.parametrize("coords", ["box", "grid"])
def test_rope_tables_match_jax(coords):
    from eovax.models.dofa import _rope_2d

    for got, ref in zip(dofa._rope_2d(4, 4, 16, coords=coords), _rope_2d(4, 4, 16, coords=coords)):
        _close(got, ref)
    with pytest.raises(ValueError, match="box.*grid"):
        dofa._rope_2d(2, 2, 8, coords="diagonal")


@pytest.mark.parametrize("init_values,rope", [(None, None), (0.5, None), (0.5, "box"),
                                              (0.5, "grid")])
def test_vit_block_matches_jax(init_values, rope):
    """Without and with LayerScale, and with RoPE on all but 2 prefix tokens."""
    import jax.numpy as jnp

    from eovax.models.dofa import ViTBlock as JaxBlock
    from eovax.models.dofa import _rope_2d

    jm = JaxBlock(32, 4, init_values=init_values, num_prefix=2)
    x = np.random.default_rng(3).standard_normal((2, 18, 32)).astype(np.float32)
    jrope = trope = None
    if rope:
        jrope = _rope_2d(4, 4, 8, coords=rope)
        trope = dofa._rope_2d(4, 4, 8, coords=rope)
    variables = _draw(jm, jnp.asarray(x), jrope)
    tm = dofa.ViTBlock(32, 4, init_values=init_values, num_prefix=2)
    tm.load_state_dict(dofa_state_dict(variables), strict=True)
    _close(tm(torch.from_numpy(x), trope), jm.apply(variables, jnp.asarray(x), jrope))


# -- the three families -------------------------------------------------------------------------


@pytest.mark.parametrize("family,size", [("v1", 32), ("v2", 28), ("v2", 56), ("v3", 32),
                                         ("v3", 64)])
def test_vit_features_match_jax(family, size):
    """Every tap of each family (v1/v2 with the cls token; v3's forward_lpips
    without its 3 prefix tokens, and its forward_features); v2 at 56², whose
    4×4 grid resamples the 2×2 position embedding; v3 at 64² (a 4×4 grid)."""
    import jax.numpy as jnp

    jvit, variables, tvit = _drawn_vit(family)
    x, tx = _images(2, size, seed=size)
    ref = jvit.apply(variables, jnp.asarray(x), jnp.asarray(WVS), method=_taps_method(jvit))
    got = dofa.dofa_taps(tvit, tx, torch.from_numpy(WVS))
    assert len(got) == len(ref) == tvit.num_taps == 2
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, label=f"tap {i}")
    if family == "v3":
        _close(tvit(tx, torch.from_numpy(WVS)), jvit.apply(variables, jnp.asarray(x),
                                                           jnp.asarray(WVS)))
        assert len(tvit.blocks) == tvit.depth - 1


def test_v3_rope_conventions_differ_and_match_jax():
    """The same weights under "grid" RoPE: as JAX, and unlike "box" at a 4×4 grid."""
    import jax.numpy as jnp

    jbox, variables, tbox = _drawn_vit("v3")
    jgrid, tgrid = _pair("v3", rope_coords="grid")
    tgrid.load_state_dict(tbox.state_dict())
    x, tx = _images(1, 64, seed=4)
    got = tgrid(tx, torch.from_numpy(WVS))
    _close(got, jgrid.apply(variables, jnp.asarray(x), jnp.asarray(WVS)))
    assert not torch.allclose(got, tbox(tx, torch.from_numpy(WVS)))


@pytest.mark.parametrize("family", ["v1", "v2", "v3"])
def test_lpips_value_and_gradient_match_jax(family):
    """DOFALPIPS (drawn tap weights) and its gradient with respect to the
    reconstruction against ``jax.value_and_grad``."""
    import jax
    import jax.numpy as jnp

    from eovax.models.dofa import DOFALPIPS as JaxLPIPS

    jvit, tvit = _pair(family)
    size = jvit.img_size
    x, tx = _images(2, size, seed=5)
    r, tr = _images(2, size, seed=6)
    jl = JaxLPIPS(dofa=jvit)
    variables = _draw(jl, jnp.asarray(x), jnp.asarray(r), jnp.asarray(WVS))
    tl = dofa.DOFALPIPS(tvit)
    tl.load_state_dict(dofa_state_dict(variables), strict=True)
    ref, ref_grad = jax.value_and_grad(
        lambda rr: jl.apply(variables, jnp.asarray(x), rr, jnp.asarray(WVS)))(jnp.asarray(r))
    tr.requires_grad_()
    got = tl(tx, tr, torch.from_numpy(WVS))
    got.backward()
    assert got.dtype == torch.float32 and got.item() > 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(tr.grad.permute(0, 2, 3, 1), ref_grad, GRAD_TOL)


@pytest.mark.parametrize("family", ["v2", "v3"])
def test_discriminator_logits_match_jax(family):
    import jax.numpy as jnp

    from eovax.models.dofa import DOFADiscriminator as JaxDisc

    jvit, tvit = _pair(family)
    x, tx = _images(2, jvit.img_size, seed=7)
    jd = JaxDisc(dofa=jvit, hidden_dim=16)
    variables = _draw(jd, jnp.asarray(x), jnp.asarray(WVS))
    td = dofa.DOFADiscriminator(tvit, hidden_dim=16)
    td.load_state_dict(dofa_state_dict(variables), strict=True)
    got = td(tx, torch.from_numpy(WVS))
    tokens = 5 if family == "v2" else 4  # 2×2 patches, v2 with its cls token
    assert got.shape == (2, 2 * tokens)
    _close(got, jd.apply(variables, jnp.asarray(x), jnp.asarray(WVS)))


@pytest.mark.parametrize("bands", ["S2L2A", "S1RTC", ["RED", "GREEN", "BLUE"],
                                   ["S2.NIR_NARROW", "SWIR_1", "VV"]])
def test_wavelengths_match_jax(bands):
    from eovax.models.dofa import get_wavelengths

    assert dofa.get_wavelengths(bands) == get_wavelengths(bands)
    assert dofa.get_wavelenghts is dofa.get_wavelengths


def test_encoder_wrapper_binds_the_wavelengths():
    _, _, tvit = _drawn_vit("v2")
    wrapper = dofa.DOFAEncoderWrapper(tvit, WVS)
    _, tx = _images(1, 28, seed=8)
    feats = wrapper(tx)
    assert isinstance(feats, tuple) and wrapper.out_channels == [32, 32]
    for a, b in zip(feats, tvit(tx, torch.from_numpy(WVS))):
        assert torch.equal(a, b)


# -- the checkpoint loader ----------------------------------------------------------------------


def _reference_file(path, family, variables, extras=True):
    """A ``.pth`` in the reference's layout from JAX variables: v2/v3 under
    ``model.``, with timm's ``norm``/``fc_norm``/``head``, v1's ``pos_embed``, v3's
    last block (14 keys) and a ``num_batches_tracked``."""
    sd = dofa_state_dict(variables)
    g = torch.Generator().manual_seed(3)
    d = FAMILIES[family][1]["embed_dim"]
    if extras:
        sd.update({"norm.weight": torch.ones(d), "norm.bias": torch.zeros(d),
                   "fc_norm.weight": torch.ones(d), "head.weight": torch.randn(10, d, generator=g),
                   "head.bias": torch.zeros(10),
                   "norm.num_batches_tracked": torch.tensor(0)})
        if family == "v1":
            sd["pos_embed"] = torch.randn(1, 5, d, generator=g)
        if family == "v3":
            last = dofa.ViTBlock(d, 4, init_values=1e-5, num_prefix=3).state_dict()
            depth = FAMILIES[family][1]["depth"]
            sd.update({f"blocks.{depth - 1}.{k}": torch.randn(v.shape, generator=g)
                       for k, v in last.items()})
    if family != "v1":
        sd = {f"model.{k}": v for k, v in sd.items()}
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("family", ["v1", "v2", "v3"])
def test_loader_matches_the_jax_converter(tmp_path, family):
    """The port's loader and the JAX package's ``_maybe_load`` on one complete
    file: the same converted, skipped and unexpected keys in the same order,
    and the same features."""
    import jax
    import jax.numpy as jnp

    from eovax.models import dofa as jdofa
    from eovax.utils.torch_convert import convert_state_dict, load_torch_file

    jvit, variables, _ = _drawn_vit(family)
    path = str(_reference_file(tmp_path / "dofa.pth", family, variables))
    strip = () if family == "v1" else ("model.",)
    loaded = jdofa._maybe_load(jvit, path, strip_prefixes=strip)
    x0 = jnp.zeros((1, jvit.img_size, jvit.img_size, 3))
    template = jvit.init(jax.random.PRNGKey(0), x0, jnp.linspace(0.4, 2.5, 3))
    raw = {k[len("model."):] if strip and k.startswith("model.") else k: v
           for k, v in load_torch_file(path).items()}
    _, ref = convert_state_dict(raw, template)

    _, tvit = _pair(family)
    init_parameters(tvit, torch.Generator().manual_seed(0))
    report = dofa._maybe_load(tvit, path, strip)
    assert (report.converted, report.skipped, report.unexpected) == (
        ref.converted, ref.skipped, ref.unexpected)
    n_unexpected = {"v1": 6, "v2": 5, "v3": 19}[family]
    assert len(report.unexpected) == n_unexpected and report.skipped == [
        "norm.num_batches_tracked"]
    assert len(report.converted) == len(tvit.state_dict())
    x, tx = _images(2, jvit.img_size, seed=9)
    ref_feats = jvit.apply(loaded, jnp.asarray(x), jnp.asarray(WVS), method=_taps_method(jvit))
    for a, b in zip(dofa.dofa_taps(tvit.eval(), tx, torch.from_numpy(WVS)), ref_feats):
        _close(a, b)


def test_loader_raises_on_a_shape_mismatch(tmp_path):
    _, tvit = _pair("v2")
    torch.save({"model.cls_token": torch.zeros(1, 2, 32)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="Shape mismatch for cls_token"):
        dofa._maybe_load(tvit, str(tmp_path / "bad.pth"), ("model.",))


# -- the factory, the adversarial fit and the CLI -----------------------------------------------


def _dofa_net(family, path):
    """A ``dofa_net`` block: the shipped builder of ``family`` with tiny kwargs."""
    builder = {"v2": "dofav2_base_patch14_224", "v3": "dofav3_large_patch16_224"}[family]
    kw = {k: list(v) if isinstance(v, tuple) else v for k, v in FAMILIES[family][1].items()
          if k != "patch_size"}
    return {"_target_": f"eo_vae.models.dofa.{builder}", "model_bands": ["RED", "GREEN", "BLUE"],
            "ckpt_data": str(path), **kw}


@functools.lru_cache(maxsize=None)
def _written(family, directory):
    jvit, variables, _ = _drawn_vit(family)
    return _reference_file(os.path.join(directory, f"dofa_{family}.pth"), family, variables)


def _gen_cfg(path, **over):
    lpips = {"_target_": "eo_vae.models.modules.loss_utils.DOFALPIPS",
             "dofa_net": _dofa_net("v2", path)}
    return {**tg.GEN_CFG, "lpips": lpips, **over}


def test_factories_build_the_same_perceptual_generator_loss(tmp_path):
    """Both factories on one config: ``generator_loss`` with its kernel (the
    perceptual term inside the adaptive weight) and without, and the
    discriminator loss, JAX against the port at test_torch_gan.py's TOL."""
    from eovax.core import config as jcfg
    from eovax.losses.factory import build_loss_from_config as jax_build

    path = _written("v2", str(tmp_path))
    cfg = _gen_cfg(path)
    jloss, _, _ = jax_build(cfg, tg._cfg(jcfg))
    tloss, _, _ = build_loss_from_config(cfg, tg._cfg(tg.tcfg))
    assert tloss.perceptual_weight == 1.0 and isinstance(tloss.lpips_apply, dofa.DOFALPIPS)
    assert not any(p.requires_grad for p in tloss.lpips_apply.parameters())
    jd, v, td = tg._discs("nlayer")
    tg._compare_losses(jloss, tloss, jd, v, td, 32, 2)


def test_factories_build_the_same_consistency_feature_term(tmp_path):
    """The feature term over a v3 (its taps are ``forward_lpips``'s): the loss and
    its gradient with respect to the reconstruction against ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.losses.factory import build_loss_from_config as jax_build

    path = _written("v3", str(tmp_path))
    cfg = {"_target_": "x.EOConsistencyLoss", "feature_weight": 0.5,
           "dofa_net": _dofa_net("v3", path)}
    jloss, _, _ = jax_build(cfg, tg._cfg(jcfg))
    tloss, _, _ = build_loss_from_config(cfg, tg._cfg(tg.tcfg))
    assert tloss.feature_weight == 0.5 and isinstance(tloss.dofa_features, dofa.DOFAFeatures)
    x, tx = _images(2, 32, seed=10)
    r, tr = _images(2, 32, seed=11)
    (ref, logs), ref_grad = jax.value_and_grad(
        lambda rr: jloss(jnp.asarray(x), jnp.asarray(WVS), rr), has_aux=True)(jnp.asarray(r))
    tr.requires_grad_()
    got, got_logs = tloss(tx, torch.from_numpy(WVS), tr)
    got.backward()
    assert float(got_logs["train/loss_feature"]) > 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(got_logs["train/loss_feature"]),
                               float(logs["train/loss_feature"]), rtol=1e-5)
    _close(tr.grad.permute(0, 2, 3, 1), ref_grad, GRAD_TOL)


def test_shipped_rgb_finetune_config_builds_a_live_fp32_term(tmp_path, capsys, monkeypatch):
    """finetune_dyn_conv_rgb.yaml with its checkpoint on disk (its DOFA v2
    builder, cut to the tiny width): a live perceptual term in fp32 under the
    bf16 policy; absent, the JAX factory's message; an unknown builder and a
    builder that raises ``NotImplementedError``, their messages too."""
    from eovax_torch.core.config import VAEConfig, load_yaml
    from eovax_torch.core.precision import DEFAULT_POLICY

    raw = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                 "finetune_dyn_conv_rgb.yaml"))
    loss_cfg = raw["model"]["loss_fn"]
    shipped = loss_cfg["lpips"]["dofa_net"]
    path = _written("v2", str(tmp_path))
    net = {**_dofa_net("v2", path), "_target_": shipped["_target_"],
           "model_bands": shipped["model_bands"]}
    cfg = VAEConfig.from_dict(raw)
    loss, _, _ = build_loss_from_config({**loss_cfg, "lpips": {"dofa_net": net}}, cfg,
                                        policy=DEFAULT_POLICY)
    assert loss.perceptual_weight == 1.0 and isinstance(loss.lpips_apply, dofa.DOFALPIPS)
    assert all(p.dtype == torch.float32 for p in loss.lpips_apply.parameters())
    _, tx = _images(1, 28, bands=3, seed=12)
    wvs = torch.tensor(dofa.get_wavelengths(shipped["model_bands"]))
    value = loss.lpips_apply(tx, (tx + 0.5).bfloat16(), wvs)
    assert value.dtype == torch.float32 and value.item() > 0
    loss, _, _ = build_loss_from_config(loss_cfg, cfg, policy=DEFAULT_POLICY)
    assert loss.perceptual_weight == 0.0 and loss.lpips_apply is None
    assert "not found — perceptual/feature term disabled" in capsys.readouterr().out
    loss, _, _ = build_loss_from_config(
        {**loss_cfg, "lpips": {"dofa_net": {**net, "_target_": "x.dofav9"}}}, cfg)
    assert loss.perceptual_weight == 0.0
    assert "unknown DOFA builder 'dofav9' — term disabled" in capsys.readouterr().out

    def not_ported(**kw):
        raise NotImplementedError("no such weights")

    monkeypatch.setattr(dofa, "dofav2_base_patch14_224", not_ported)
    loss, _, _ = build_loss_from_config({**loss_cfg, "lpips": {"dofa_net": net}}, cfg)
    assert loss.perceptual_weight == 0.0 and loss.lpips_apply is None
    assert "no such weights — term disabled" in capsys.readouterr().out


@pytest.fixture(scope="module")
def lpips_fit(tmp_path_factory):
    """The JAX trainer over two S2RGB batches at 32² with EOGenerativeLoss and the
    v2 LPIPS, ``freeze_body``; the GAN term on from step 0 and the discriminator
    from step 1 (so that both generator steps score against the drawn
    discriminator; its first Adam step amplifies round-off, ROADMAP Queue 3,
    kept difference 7). Returns the drawn variables, its CSV rows, its final
    state and the config."""
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.losses.factory import build_loss_from_config as jax_build
    from eovax.parallel.mesh import make_mesh
    from eovax.train import stage2 as jstage2
    from eovax.utils.logging import CSVLogger as JaxCSVLogger

    tmp = tmp_path_factory.mktemp("lpips_fit")
    cfg = _gen_cfg(_written("v2", str(tmp)), gan_start_step=0, disc_update_start_step=1)
    jc = tg._cfg(jcfg, freeze_body=True)
    jm, variables = tg._jax_vae(jc)
    jloss, jdisc, _ = jax_build(cfg, jc)
    jtrainer = jstage2.Stage2Trainer(model=jm, loss_obj=jloss, cfg=jc, discriminator=jdisc,
                                     mesh=make_mesh(jax.devices()[:1]),
                                     logger=JaxCSVLogger(str(tmp)), max_steps=2, log_every=1,
                                     seed=0)
    disc_vars = tg._jax_disc_vars(jdisc, len(tg.WVS), seed=7)
    params, dparams = (jax.tree_util.tree_map(jnp.asarray, t)
                       for t in (variables["params"], disc_vars))
    state = jstage2.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=jtrainer.tx.init(params), disc_params=dparams,
        disc_opt_state=jtrainer.disc_tx.init(dparams["params"]))
    state = jax.tree_util.tree_map(np.asarray, jtrainer.fit(iter(tg._batches(2)), state=state))
    return dict(cfg=cfg, variables=variables, disc_vars=disc_vars,
                rows=tg._csv_rows(tmp / "metrics.csv"),
                final=state_dict_from_variables({"params": state.params,
                                                 "batch_stats": state.batch_stats}),
                disc=tg.discriminator_state_dict(state.disc_params))


def test_two_step_fit_with_the_perceptual_term_matches_jax(tmp_path, lpips_fit):
    """``Stage2Trainer.fit`` with the factory's LPIPS (placed by the trainer): the
    CSV rows with a positive ``train/loss_lpips``, the generator's parameters and
    the discriminator's after its step, at test_torch_gan.py's tolerances; the
    LPIPS network takes no gradient and stays as loaded."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.train import stage2
    from eovax_torch.utils.logging import CSVLogger

    cfg = dataclasses.replace(tg._cfg(tg.tcfg), freeze_body=True)
    model = EOFluxVAE(cfg, state_dict_from_variables(lpips_fit["variables"]), device="cpu")
    loss, disc, _ = build_loss_from_config(lpips_fit["cfg"], cfg)
    disc.load_state_dict(tg.discriminator_state_dict(lpips_fit["disc_vars"]), strict=True)
    lpips_before = {k: v.clone() for k, v in loss.lpips_apply.state_dict().items()}
    trainer = stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, discriminator=disc,
                                   max_steps=2, log_every=1, logger=CSVLogger(str(tmp_path)),
                                   seed=0)
    assert stage2.loss_networks(loss) == [loss.lpips_apply]
    assert trainer.fit(iter(tg._batches(2))).step == 2
    rows, ref_rows = tg._csv_rows(tmp_path / "metrics.csv"), lpips_fit["rows"]
    assert list(rows[0]) == list(ref_rows[0]) and len(rows) == len(ref_rows) == 2
    for row, ref in zip(rows, ref_rows):
        keys = [k for k, v in ref.items() if k.startswith("train/") and v
                and k != "train/steps_per_sec"]
        assert [k for k, v in row.items() if k.startswith("train/") and v
                and k != "train/steps_per_sec"] == keys
        for key in keys:
            np.testing.assert_allclose(float(row[key]), float(ref[key]), **tg.TOL,
                                       err_msg=f"{key} at step {ref['step']}")
        assert float(row["train/loss_lpips"]) > 0
    assert "train/loss_disc" not in rows[0] or not rows[0]["train/loss_disc"]
    assert rows[1]["train/loss_disc"]
    start = state_dict_from_variables(lpips_fit["variables"])
    tg._assert_params_close(model.core.state_dict(), lpips_fit["final"], start, "generator")
    tg._assert_params_close(disc.state_dict(), lpips_fit["disc"],
                            tg.discriminator_state_dict(lpips_fit["disc_vars"]),
                            "discriminator", tg.DISC_FAR_SHARE)
    for key, value in loss.lpips_apply.state_dict().items():
        assert torch.equal(value, lpips_before[key]), key
    assert all(p.grad is None for p in loss.lpips_apply.parameters())


def test_train_cli_with_the_perceptual_term(tmp_path):
    """``main --device cpu`` for 2 steps on finetune_dyn_conv_rgb.yaml shrunk to
    the tiny VAE at 28² (start steps 0) with a test-written DOFA v2 file: a
    positive ``train/loss_lpips`` in the CSV, and no DOFA tensor in the
    checkpoint (the model's, the discriminator's and two optimizer states)."""
    import yaml

    from eovax_torch.cli import train
    from eovax_torch.core.config import load_yaml
    from eovax_torch.utils import checkpoint

    raw = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                 "finetune_dyn_conv_rgb.yaml"))
    stem = {"num_layers": 1, "wv_planes": 32}
    for part in ("encoder", "decoder"):
        raw["model"][part].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=8,
                                  dynamic_conv_kwargs=stem)
    loss = raw["model"]["loss_fn"]
    loss.update(gan_start_step=0, disc_update_start_step=0)
    loss["lpips"]["dofa_net"] = _dofa_net("v2", _written("v2", str(tmp_path)))
    raw["model"].update(decay_end_epoch=1)
    raw["experiment"]["exp_dir"] = str(tmp_path / "exps")
    raw["datamodule"].update(batch_size=2, eval_batch_size=2, target_size=[28, 28])
    raw["trainer"].update(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
                          log_every_n_steps=1)
    config = tmp_path / "rgb.yaml"
    config.write_text(yaml.safe_dump(raw))
    train.main(["--config", str(config), "--synthetic-data", "--max-steps", "2", "--device",
                "cpu", "--precision", "32-true"])
    (exp,) = (tmp_path / "exps").iterdir()
    rows = tg._csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2", "2"]
    assert all(float(rows[i]["train/loss_lpips"]) > 0 for i in (0, 1))
    assert float(rows[2]["val/loss_lpips"]) > 0
    saved = checkpoint.TrainCheckpointer(str(exp / "checkpoints")).restore_latest()
    assert sorted(saved) == ["disc_optimizer", "discriminator", "model", "optimizer", "step"]
    for part in ("model", "discriminator"):
        assert not [k for k in saved[part] if "patch_embed" in k or "lin_" in k
                    or k.startswith(("dofa", "blocks."))], part
    n_model = len([k for k in saved["model"] if not k.startswith("bn.")])
    assert len(saved["optimizer"]["mu"]) == n_model


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("recon_dtype", [torch.float32, torch.bfloat16])
def test_lpips_on_card_matches_cpu(cuda_device, recon_dtype):
    """DOFALPIPS over a v2 (embed 64, depth 3, 56²: a 4×4 grid, its position
    embedding resampled) on the card, TF32 off, against the CPU: the value within
    1e-4 relative and the gradient with respect to the reconstruction within 1e-3
    (norm of the difference over the norm), for an fp32 and a bf16
    reconstruction (cast to fp32 in the patch embed); no hand kernel launches."""
    from eovax_torch.core.precision import FULL_PRECISION
    from eovax_torch.kernels import attention, conv3x3, groupnorm

    FULL_PRECISION.activate()
    vit = dofa.DOFAViTv2(img_size=28, patch_size=14, embed_dim=64, depth=3, num_heads=4,
                         wv_planes=32, out_indices=(0, 1, 2))
    init_parameters(vit, torch.Generator().manual_seed(0))
    lpips = dofa.DOFALPIPS(vit).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 56, 56, generator=g)
    r = (x + 0.3 * torch.randn(2, 4, 56, 56, generator=g)).to(recon_dtype)
    wvs = torch.tensor(WVS[:4])
    counters = (conv3x3.conv3x3, conv3x3.conv3x3_dx, groupnorm.group_norm,
                groupnorm.group_norm_backward, attention.flash_attention)
    results = []
    for device in ("cpu", cuda_device):
        lpips.to(device)
        before = [f.launches for f in counters]
        rr = r.detach().to(device).requires_grad_()
        value = lpips(x.to(device), rr, wvs.to(device))
        value.backward()
        if device != "cpu":
            torch.cuda.synchronize()
            assert [f.launches for f in counters] == before
        results.append((value.item(), rr.grad.float().cpu()))
    (ref, ref_grad), (got, grad) = results
    assert abs(got - ref) <= 1e-4 * abs(ref)
    assert ((grad - ref_grad).norm() / ref_grad.norm()).item() <= 1e-3
