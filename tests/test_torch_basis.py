"""The shared-basis stems (``stem.mode: basis``) against the JAX package's, in fp32 on the CPU.

The layers alone at 8 bases, rank 16, with 3 and 12 bands; the VAE on
``configs/finetune_consistency_bases.yaml`` shrunk to ch 32, ch_mult (1, 2),
one res block, z 8, at 32² (its 128 bases and ranks 64 / 32 kept); stage-1
distillation on the basis stems. Every JAX variable is drawn from numpy by the
shapes of its traced init (``tests/test_torch_gan.py``'s ``_drawn``) and
carried over by ``state_dict_from_variables`` with ``strict=True``.

The JAX package's ``EOVAECore.forward_gan`` calls ``conv_out._conv``, which its
``DynamicOutputLayer`` lacks (``eovax/models/backbone.py:373``,
``eovax/nn/dynamic_basis.py``): its adversarial step on a basis config raises
``AttributeError``. These tests give that class the method, for their own run
only, as the stem's own forward convolves (``apply_dynamic_kernel``, padding
K // 2); the port's output layer has it.

JAX is imported only inside the tests that need it, so the card's machine
runs the ``gpu`` tests of ``tests/test_torch_basis_gan.py`` without it.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import test_torch_gan as tg
from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.core.config import load_yaml
from eovax_torch.nn import dynamic_basis as tb
from eovax_torch.train import distill
from eovax_torch.utils.convert import state_dict_from_variables

BASES_YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "finetune_consistency_bases.yaml")
WVS = {3: np.asarray([0.665, 0.56, 0.49], np.float32),
       12: np.asarray([0.443, 0.49, 0.56, 0.665, 0.705, 0.74, 0.783, 0.842, 0.865, 0.945,
                       1.61, 2.19], np.float32)}
# One layer: fp32 through the small MLP and one conv, summed in other orders.
LAYER_TOL = 1e-5
# The VAE: fp32 through ~20 conv layers (tests/test_torch_model.py's TOL).
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def jax_basis_conv():
    """The JAX ``DynamicOutputLayer`` with the ``_conv`` its ``forward_gan`` calls."""
    from eovax.nn.dynamic_basis import DynamicOutputLayer
    from eovax.nn.dynamic_conv import apply_dynamic_kernel

    def _conv(self, x, kernel, bias):
        return apply_dynamic_kernel(x, kernel, bias, padding=self.kernel_size // 2,
                                    policy=self.policy)

    DynamicOutputLayer._conv = _conv
    try:
        yield
    finally:
        del DynamicOutputLayer._conv


def bases_raw(**model_over) -> dict:
    """The shipped bases config, shrunk: ch 32, ch_mult (1, 2), one res block,
    z 8; the warmup cut (constant-then-cosine from step 0), the posterior's mode."""
    raw = load_yaml(BASES_YAML)
    for part in ("encoder", "decoder"):
        raw["model"][part].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=8,
                                  resolution=32)
    raw["model"].update(base_lr=tg.BASE_LR, final_lr_sched=1e-5, warmup_epochs=0,
                        decay_end_epoch=1, sample_posterior=False, **model_over)
    return raw


def bases_cfg(m, **model_over):
    return m.VAEConfig.from_dict(bases_raw(**model_over))


def jax_bases_model(seed: int = 0):
    """The JAX model on the shrunk bases config with drawn variables and
    non-trivial latent BatchNorm statistics; returns (model, variables)."""
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.models.backbone import EOVAECore as JaxCore
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE

    jc = bases_cfg(jcfg)
    core = JaxCore(encoder_cfg=jc.encoder, decoder_cfg=jc.decoder)
    variables = tg._drawn(core, jnp.zeros((1, 32, 32, 3)), jnp.asarray(WVS[3]), seed=seed,
                          sample_posterior=False, method=JaxCore.forward)
    g = np.random.default_rng(seed)
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    return JaxVAE(jc, variables), variables


def _rel(got: torch.Tensor, ref) -> float:
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(got.shape)
    return (got.detach() - ref).abs().max().item() / ref.abs().max().item()


# -- the layers ---------------------------------------------------------------------------------


def _layers(kind: str, bands: int):
    """(JAX layer, its drawn variables, port layer, input NHWC numpy)."""
    import jax.numpy as jnp

    from eovax.nn import dynamic_basis as jb

    g = np.random.default_rng(bands)
    if kind == "input":
        jl, tl = (m.DynamicInputLayer(out_channels=32, num_bases=8, rank_dim=16) for m in (jb, tb))
        x = g.standard_normal((2, 16, 16, bands)).astype(np.float32)
    else:
        jl, tl = (m.DynamicOutputLayer(in_channels=32, num_bases=8, rank_dim=16) for m in (jb, tb))
        x = g.standard_normal((2, 16, 16, 32)).astype(np.float32)
    variables = tg._drawn(jl, jnp.asarray(x), jnp.asarray(WVS[bands]), seed=bands)
    tl.load_state_dict(state_dict_from_variables(variables), strict=True)
    return jl, variables, tl, x


@pytest.mark.parametrize("bands", [3, 12])
@pytest.mark.parametrize("kind", ["input", "output"])
def test_basis_layer_matches_jax(kind, bands):
    """``generate`` (JAX HWIO, the port OIHW), ``get_distillation_weight`` (both
    torch layout) and the forward."""
    import jax.numpy as jnp

    jl, variables, tl, x = _layers(kind, bands)
    wvs = jnp.asarray(WVS[bands])
    with torch.no_grad():
        weight, bias = tl.generate(torch.from_numpy(WVS[bands]))
        kernel, jbias = jl.apply(variables, wvs, method=type(jl).generate)
        assert _rel(weight, np.asarray(kernel).transpose(3, 2, 0, 1)) <= LAYER_TOL
        assert _rel(bias, jbias) <= LAYER_TOL
        shapes = ((32, bands, 3, 3), (32,)) if kind == "input" else ((bands, 32, 3, 3), (bands,))
        assert (tuple(weight.shape), tuple(bias.shape)) == shapes
        for got, ref in zip(tl.get_distillation_weight(torch.from_numpy(WVS[bands])),
                            jl.apply(variables, wvs, method=type(jl).get_distillation_weight)):
            assert _rel(got, ref) <= LAYER_TOL
        out = tl(tg._nchw(x), torch.from_numpy(WVS[bands]))
    ref = np.asarray(jl.apply(variables, jnp.asarray(x), wvs))
    assert _rel(out.permute(0, 2, 3, 1), ref) <= LAYER_TOL


@pytest.mark.parametrize("bands", [3, 12])
@pytest.mark.parametrize("kind", ["input", "output"])
def test_basis_layer_gradients_match_jax(kind, bands):
    """Every parameter's gradient and the input's, of ⟨forward, c⟩ for a drawn
    cotangent c, against ``jax.grad``: within 1e-5 of each tensor's largest."""
    import jax
    import jax.numpy as jnp

    jl, variables, tl, x = _layers(kind, bands)
    wvs = jnp.asarray(WVS[bands])
    out_c = 32 if kind == "input" else bands
    cot = np.random.default_rng(9).standard_normal((2, 16, 16, out_c)).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(jl.apply({"params": params}, xx, wvs) * cot)

    jgrads, jdx = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = tg._nchw(x).requires_grad_(True)
    (tl(xt, torch.from_numpy(WVS[bands])) * tg._nchw(cot)).sum().backward()
    ref = state_dict_from_variables({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    assert sorted(ref) == sorted(n for n, _ in tl.named_parameters())
    for name, p in tl.named_parameters():
        assert _rel(p.grad, ref[name]) <= LAYER_TOL, name
    assert _rel(xt.grad.permute(0, 2, 3, 1), jdx) <= LAYER_TOL


def test_basis_layers_init_follows_the_jax_initializers():
    """The seeded init: the bank uniform in ±1/K, the hypernetwork's Linears
    xavier-uniform with zero biases, the expansion N(0, 0.001), the input
    layer's bias zero; ``wv_proj`` and the bias generator take the port's
    default (LeCun normal, zero bias), as flax's Dense default."""
    from eovax_torch.nn.init import init_parameters

    layer = tb.DynamicOutputLayer(in_channels=64, num_bases=128, rank_dim=32)
    init_parameters(layer, torch.Generator().manual_seed(0))
    bank = layer.basis_bank
    assert bank.abs().max().item() <= 1 / 3 and bank.abs().max().item() > 0.3
    hyper = layer.hypernet
    for i in range(4):
        lin = getattr(hyper, f"backbone_{i}")
        bound = (6 / sum(lin.weight.shape)) ** 0.5
        assert lin.weight.abs().max().item() <= bound and not lin.bias.any()
    assert abs(hyper.expansion.weight.std().item() - 0.001) < 1e-4
    assert not layer.bias_generator_0.bias.any()
    inp = tb.DynamicInputLayer(out_channels=32, num_bases=8, rank_dim=16)
    init_parameters(inp, torch.Generator().manual_seed(0))
    assert not inp.bias.any()


# -- the model on the bases config -------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_bases_model()
    tm = EOFluxVAE(bases_cfg(tcfg), state_dict_from_variables(variables), device="cpu")
    return jm, variables, tm


def test_bases_config_builds_the_basis_stems(models):
    _, _, tm = models
    enc, dec = tm.core.encoder.conv_in, tm.core.decoder.conv_out
    assert isinstance(enc, tb.DynamicInputLayer) and isinstance(dec, tb.DynamicOutputLayer)
    assert (enc.num_bases, dec.num_bases) == (128, 128)
    assert (enc.hypernet.backbone_out.out_features, dec.hypernet.backbone_out.out_features) == (
        64, 32)


@pytest.mark.parametrize("bands", [3, 12])
def test_bases_model_reconstruct_matches_jax(models, bands):
    jm, _, tm = models
    x = np.random.default_rng(bands).standard_normal((2, bands, 32, 32)).astype(np.float32)
    out = tm.reconstruct(x, WVS[bands])
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.reconstruct(x, WVS[bands])),
                               **MODEL_TOL)


def test_bases_model_forward_gan_matches_jax(models):
    """``forward_gan``'s reconstruction, penultimate activation, generated kernel
    and bias (the JAX kernel HWIO), in train mode (batch statistics)."""
    import jax.numpy as jnp

    from eovax.models.backbone import EOVAECore as JaxCore

    jm, variables, tm = models
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 12)).astype(np.float32)
    with jax_basis_conv():
        (recon, _, h_pre, kernel, bias), _ = jm.core.apply(
            variables, jnp.asarray(x), jnp.asarray(WVS[12]), sample_posterior=False,
            train=True, method=JaxCore.forward_gan, mutable=["batch_stats"])
    core = EOFluxVAE(bases_cfg(tcfg), state_dict_from_variables(variables), device="cpu").core
    with torch.no_grad():
        got = core.forward_gan(tg._nchw(x), torch.from_numpy(WVS[12]), sample_posterior=False,
                               train=True)
    assert got[3].shape == (12, 32, 3, 3) and got[4].shape == (12,)
    for a, ref in ((got[0], tg._nchw(recon)), (got[2], tg._nchw(h_pre)),
                   (got[3], torch.from_numpy(np.asarray(kernel).transpose(3, 2, 0, 1))),
                   (got[4], torch.from_numpy(np.asarray(bias)))):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), **MODEL_TOL)
    # recon = conv(h_pre, kernel) + bias, through the output layer's own conv.
    assert torch.equal(core.decoder.conv_out._conv(got[2], got[3], got[4]), got[0])


def test_param_count_matches(models):
    jm, _, tm = models
    assert tm.param_count() == jm.param_count()


# -- distillation on the basis stems ------------------------------------------------------------


@pytest.fixture(scope="module")
def distilled(models):
    """20 steps of ``run_distillation`` on both sides against one numpy teacher."""
    from eovax.train import distill as jdistill

    jm, variables, _ = models
    g = np.random.default_rng(0)
    teacher = {"encoder_weight": g.normal(0, 0.1, (32, 3, 3, 3)).astype(np.float32),
               "encoder_bias": g.normal(0, 0.05, (32,)).astype(np.float32),
               "decoder_weight": g.normal(0, 0.1, (3, 32, 3, 3)).astype(np.float32),
               "decoder_bias": g.normal(0, 0.05, (3,)).astype(np.float32)}
    kw = dict(max_steps=20, lr=3e-3, val_every_n_steps=5, log_every_n_steps=1, patience=100)
    jlogs, tlogs = [], []
    new_vars, _ = jdistill.run_distillation(jm.core, variables, teacher,
                                            jdistill.DistillConfig(**kw),
                                            log_fn=lambda s, v: jlogs.append(v))
    model = EOFluxVAE(bases_cfg(tcfg), state_dict_from_variables(variables), device="cpu")
    start = {k: v.clone() for k, v in model.core.state_dict().items()}
    distill.run_distillation(model.core, {k: torch.from_numpy(v) for k, v in teacher.items()},
                             distill.DistillConfig(**kw), log_fn=lambda s, v: tlogs.append(v))
    return jm, new_vars, jlogs, tlogs, model, start


def test_basis_distillation_matches_jax(distilled):
    """The logs of every step, and the stems each side's final parameters
    generate at the RGB wavelengths, within 1e-4; only the basis stems moved,
    and the body keeps its bits."""
    jm, new_vars, jlogs, tlogs, model, start = distilled
    assert len(tlogs) == len(jlogs) == 20
    for j, t in zip(jlogs, tlogs):
        assert list(t) == list(j)
        for key in j:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert tlogs[-1]["total_loss"] < 0.5 * tlogs[0]["total_loss"]
    wvs = np.asarray(distill.DistillConfig().rgb_wavelengths, np.float32)
    with torch.no_grad():
        for name in ("encoder.conv_in", "decoder.conv_out"):
            part, stem = name.split(".")
            ref = jm.core.apply(new_vars, wvs, method=lambda c, w: getattr(
                getattr(c, part), stem).get_distillation_weight(w))
            got = model.core.get_submodule(name).get_distillation_weight(torch.from_numpy(wvs))
            for a, r in zip(got, ref):
                assert _rel(a, r) <= 1e-4, name
    moved = set()
    for key, value in model.core.state_dict().items():
        if not key.startswith(("encoder.conv_in.", "decoder.conv_out.")):
            assert torch.equal(value, start[key]), key
        elif not torch.equal(value, start[key]):
            moved.add(key.split(".")[2])
    assert moved == {"basis_bank", "hypernet", "wv_proj", "bias", "bias_generator_0",
                     "bias_generator_2"}


def test_distilled_basis_checkpoint_loads_into_a_fresh_model(tmp_path, distilled):
    """``save_distilled_checkpoint`` → ``EOFluxVAE.load_checkpoint``: the stems
    equal; and ``eo-vae-final.pt``'s full state dict (the train CLI's) loads
    the basis stems too, where a static teacher's conv_in/conv_out is skipped."""
    _, _, _, _, model, _ = distilled
    path = tmp_path / "distilled.pt"
    distill.save_distilled_checkpoint(str(path), model.core, distill.DistillConfig())
    fresh = EOFluxVAE(bases_cfg(tcfg), device="cpu", seed=5)
    fresh.load_checkpoint(str(path))
    full = EOFluxVAE(bases_cfg(tcfg), device="cpu", seed=6)
    torch.save({"state_dict": model.core.state_dict()}, tmp_path / "full.pt")
    full.load_checkpoint(str(tmp_path / "full.pt"))
    for key, value in model.core.state_dict().items():
        if key.startswith(("encoder.conv_in.", "decoder.conv_out.")):
            assert torch.equal(fresh.core.state_dict()[key], value), key
        assert torch.equal(full.core.state_dict()[key], value), key
    teacher = {"encoder.conv_in.weight": torch.ones(32, 3, 3, 3),
               "encoder.conv_in.bias": torch.ones(32),
               "decoder.conv_out.weight": torch.ones(3, 32, 3, 3),
               "decoder.conv_out.bias": torch.ones(3)}
    torch.save({"state_dict": {**model.core.state_dict(), **teacher}}, tmp_path / "teacher.pt")
    body = EOFluxVAE(bases_cfg(tcfg), device="cpu", seed=6)
    before = body.core.encoder.conv_in.bias.clone()
    body.load_checkpoint(str(tmp_path / "teacher.pt"))
    assert torch.equal(body.core.encoder.conv_in.bias, before)


def test_hypernet_init_and_compare_take_a_basis_config(tmp_path, capsys):
    """``cli/hypernet_init`` distills the basis stems of a basis config against
    its random teacher, and ``cli/compare_weight_distill`` reads the result."""
    import json

    import yaml

    from eovax_torch.cli import compare_weight_distill, hypernet_init

    config = tmp_path / "bases.yaml"
    config.write_text(yaml.safe_dump(bases_raw()))
    out = tmp_path / "init.pt"
    hypernet_init.main(["--config", str(config), "--output", str(out), "--steps", "3",
                        "--device", "cpu"])
    saved = torch.load(out, weights_only=True)
    assert "basis_bank" in saved["encoder_conv_in_state_dict"]
    assert "bias_generator_0.weight" in saved["decoder_conv_out_state_dict"]
    g = np.random.default_rng(1)
    teacher = {"encoder.conv_in.weight": g.normal(0, 0.1, (32, 3, 3, 3)),
               "encoder.conv_in.bias": g.normal(0, 0.1, (32,)),
               "decoder.conv_out.weight": g.normal(0, 0.1, (3, 32, 3, 3)),
               "decoder.conv_out.bias": g.normal(0, 0.1, (3,))}
    torch.save({k: torch.tensor(v, dtype=torch.float32) for k, v in teacher.items()},
               tmp_path / "teacher.pt")
    capsys.readouterr()
    compare_weight_distill.main(["--config", str(config), "--distilled", str(out),
                                 "--teacher", str(tmp_path / "teacher.pt"), "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert sorted(report) == ["decoder", "encoder"]
    assert all(np.isfinite(v) for part in report.values() for v in part.values())
