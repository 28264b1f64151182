"""``FluxAutoencoderKL`` (distill / finetune / flow-refine) and the legacy
``AutoencoderKL`` against the JAX package's, in fp32 on the CPU.

The tiny config of ``tests/test_model_variants.py`` (ch 32, ch_mult (1, 2),
one res block, z 8, transformer stems with one layer and 64 planes, 3 bands
in and out; static stems for ``AutoencoderKL``), every JAX variable drawn from
numpy by the shapes of its traced init (``tests/test_torch_gan.py``'s
``_drawn``) and carried over by ``state_dict_from_variables`` with
``strict=True``. The flow-refine UNet, (64, 64) × (1, 1) at 32², holds drawn
parameters on both sides (the shipped init zeroes ``conv2``, ``proj`` and
``conv_out``), and its fit takes the JAX fit's t and noise, drawn from the JAX
trainer's key sequence and injected into the port's train step.

JAX is imported only inside the tests that need it, so the card's machine runs
the ``gpu`` tests without it:

    python -m pytest tests/test_torch_flux_autoencoder.py -m gpu --noconftest
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_gan as tg
from eovax_torch.core import config as tcfg
from eovax_torch.models.flux_autoencoder import AutoencoderKL, FluxAutoencoderKL
from eovax_torch.models.unet import UNet
from eovax_torch.train import distill, stage2
from eovax_torch.utils.convert import state_dict_from_variables

WVS = np.asarray([0.665, 0.56, 0.49], np.float32)
# The VAE through ~20 conv layers; the refiner's losses, the UNet fed by it
# (tests/test_torch_model.py's and tests/test_torch_sr_train.py's TOL).
TOL = dict(rtol=1e-4, atol=1e-4)
REFINER = dict(hid_channels=(64, 64), hid_blocks=(1, 1), sampler_steps=4)
BASE_LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(m, dynamic: bool = True):
    stem = m.StemConfig(num_layers=1, wv_planes=64) if dynamic else None
    kw = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              use_dynamic_ops=dynamic, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(in_channels=3, **kw),
                       decoder=m.DecoderConfig(out_ch=3, **kw), base_lr=BASE_LR)


def _jax_variables(cfg, seed=0):
    import jax.numpy as jnp

    from eovax.models.backbone import EOVAECore as JaxCore

    core = JaxCore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    variables = tg._drawn(core, jnp.zeros((1, 32, 32, 3)), jnp.asarray(WVS), seed=seed,
                          sample_posterior=False, method=JaxCore.forward)
    g = np.random.default_rng(seed)
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    return variables


def _image(seed, b=2, size=32):
    return np.random.default_rng(seed).standard_normal((b, 3, size, size)).astype(np.float32)


# -- the modes -----------------------------------------------------------------------------------


def test_training_modes_and_an_unknown_mode():
    """The three modes, finetune by default; another raises with the JAX class's
    message (``eovax/models/flux_autoencoder.py``), before the model is built."""
    for mode in ("distill", "finetune", "flow-refine"):
        assert FluxAutoencoderKL(tiny_cfg(tcfg), training_mode=mode,
                                 device="cpu").training_mode == mode
    assert FluxAutoencoderKL(tiny_cfg(tcfg), device="cpu").training_mode == "finetune"
    with pytest.raises(ValueError, match="Unknown training_mode: bogus"):
        FluxAutoencoderKL(tiny_cfg(tcfg), training_mode="bogus", device="cpu")


def test_distill_runner_matches_jax(tmp_path):
    """``make_distill_runner`` on a test-written teacher file: 20 steps, each
    side's logs of every step and its final stems at the RGB wavelengths within
    1e-4, the inference surface intact after."""
    from eovax.core import config as jcfg
    from eovax.models.flux_autoencoder import FluxAutoencoderKL as JaxFlux

    g = np.random.default_rng(0)
    teacher = {"encoder.conv_in.weight": g.normal(0, 0.1, (32, 3, 3, 3)),
               "encoder.conv_in.bias": g.normal(0, 0.05, (32,)),
               "decoder.conv_out.weight": g.normal(0, 0.1, (3, 32, 3, 3)),
               "decoder.conv_out.bias": g.normal(0, 0.05, (3,))}
    path = str(tmp_path / "ae.pt")
    torch.save({k: torch.tensor(v, dtype=torch.float32) for k, v in teacher.items()}, path)
    variables = _jax_variables(tiny_cfg(jcfg))
    kw = dict(max_steps=20, lr=3e-3, log_every_n_steps=1, val_every_n_steps=5, patience=100)
    jm = JaxFlux(tiny_cfg(jcfg), variables, training_mode="distill")
    jlogs, tlogs = [], []
    jfinal = jm.make_distill_runner(path, **kw)(log_fn=lambda s, v: jlogs.append(v))
    tm = FluxAutoencoderKL(tiny_cfg(tcfg), state_dict_from_variables(variables),
                           training_mode="distill", device="cpu")
    tfinal = tm.make_distill_runner(path, **kw)(log_fn=lambda s, v: tlogs.append(v))
    assert len(jlogs) == len(tlogs) == 20 and list(tfinal) == list(jfinal)
    for j, t in zip(jlogs, tlogs):
        for key in j:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert tfinal["total_loss"] < 0.5 * tlogs[0]["total_loss"]
    wvs = np.asarray(distill.DistillConfig().rgb_wavelengths, np.float32)
    with torch.no_grad():
        for part, stem in (("encoder", "conv_in"), ("decoder", "conv_out")):
            ref = jm.core.apply(jm.variables, wvs, method=lambda c, w: getattr(
                getattr(c, part), stem).get_distillation_weight(w))
            got = tm.core.get_submodule(f"{part}.{stem}").get_distillation_weight(
                torch.from_numpy(wvs))
            for a, r in zip(got, ref):
                r = torch.from_numpy(np.array(r))
                assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item(), part
    out = tm.reconstruct(_image(1, b=1), WVS)
    assert out.shape == (1, 3, 32, 32) and torch.isfinite(out).all()


def test_finetune_and_gan_trainers_are_stage2_trainers():
    from eovax_torch.losses import EOConsistencyLoss
    from eovax_torch.losses.factory import build_loss_from_config

    model = FluxAutoencoderKL(tiny_cfg(tcfg), device="cpu")
    trainer = model.make_finetune_trainer(EOConsistencyLoss(), max_steps=3, log_every=0)
    assert isinstance(trainer, stage2.Stage2Trainer) and trainer.model is model
    assert trainer.max_steps == 3 and trainer.cfg is model.config
    legacy = AutoencoderKL(tiny_cfg(tcfg, dynamic=False), device="cpu")
    loss, disc, _ = build_loss_from_config(
        {**tg.GEN_CFG, "perceptual_weight": 0.0}, legacy.config)
    gan_trainer = legacy.make_gan_trainer(loss, disc, log_every=0)
    assert gan_trainer.adversarial and gan_trainer.discriminator is disc
    batch = tg._batches(1, modalities=("S2RGB",))[0]
    assert gan_trainer.fit(iter([batch])).step == 1


# -- the legacy AutoencoderKL -------------------------------------------------------------------


def test_legacy_autoencoder_matches_jax():
    """Static stems: ``reconstruct`` and ``encode`` against the JAX class on
    the same variables; a dynamic config is refused on both sides."""
    from eovax.core import config as jcfg
    from eovax.models.flux_autoencoder import AutoencoderKL as JaxLegacy

    variables = _jax_variables(tiny_cfg(jcfg, dynamic=False), seed=2)
    jm = JaxLegacy(tiny_cfg(jcfg, dynamic=False), variables)
    tm = AutoencoderKL(tiny_cfg(tcfg, dynamic=False), state_dict_from_variables(variables),
                       device="cpu")
    x = _image(2)
    out = tm.reconstruct(x, WVS)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.reconstruct(x, WVS)), **TOL)
    post, ref = tm.encode(x, WVS), jm.encode(x, WVS)
    assert tuple(post.mean.shape) == (2, 8, 16, 16)
    np.testing.assert_allclose(post.mean.numpy(), np.asarray(ref.mean), **TOL)
    np.testing.assert_allclose(post.logvar.numpy(), np.asarray(ref.logvar), **TOL)
    for cls, cfg, kw in ((AutoencoderKL, tiny_cfg(tcfg), dict(device="cpu")),
                         (JaxLegacy, tiny_cfg(jcfg), {})):
        with pytest.raises(ValueError, match="static-stem legacy model"):
            cls(cfg, **kw)


def test_legacy_autoencoder_default_config_matches_jax():
    """Without a config: the default architecture with static stems and
    ``embed_dim`` latent channels, parameter for parameter the model the JAX
    class builds (its shapes traced, not run)."""
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.models.backbone import EOVAECore as JaxCore

    # The JAX class's default: jcfg's defaults with static stems, z = embed_dim.
    jc = jcfg.VAEConfig(
        encoder=jcfg.EncoderConfig(z_channels=4, use_dynamic_ops=False, stem=None),
        decoder=jcfg.DecoderConfig(z_channels=4, use_dynamic_ops=False, stem=None))
    core = JaxCore(encoder_cfg=jc.encoder, decoder_cfg=jc.decoder)
    shapes = jax.eval_shape(functools.partial(core.init, sample_posterior=False,
                                              method=JaxCore.forward),
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.asarray(WVS))
    ref = state_dict_from_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = AutoencoderKL(embed_dim=4, device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jc)
    own = tm.core.state_dict()
    assert sorted(own) == sorted(ref)
    assert all(tuple(own[k].shape) == tuple(ref[k].shape) for k in ref)


# -- flow-refine ----------------------------------------------------------------------------------


def _refine_pair(seed=0):
    """The JAX and the port's flow-refine models on the same variables, their
    trainers, and the refiner's drawn parameters loaded on both sides."""
    import jax

    from eovax.core import config as jcfg
    from eovax.models.flux_autoencoder import FluxAutoencoderKL as JaxFlux
    from eovax.parallel.mesh import make_mesh

    variables = _jax_variables(tiny_cfg(jcfg), seed=seed)
    jm = JaxFlux(tiny_cfg(jcfg), variables, training_mode="flow-refine")
    tm = FluxAutoencoderKL(tiny_cfg(tcfg), state_dict_from_variables(variables),
                           training_mode="flow-refine", device="cpu")
    kw = dict(base_lr=BASE_LR, log_every=1)
    jtrainer = jm.make_flow_refine_trainer(**REFINER, **kw, mesh=make_mesh(jax.devices()[:1]))
    ttrainer = tm.make_flow_refine_trainer(**REFINER, **kw)
    g = np.random.default_rng(seed + 10)

    def draw(path, a):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + g.normal(0.0, 0.1, a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, jtrainer.init_params)
    jtrainer.init_params = params
    ttrainer.init_params.load_state_dict(state_dict_from_variables({"params": params}),
                                         strict=True)
    return jtrainer, ttrainer


def _batches(n, seed=3):
    from eovax_torch.data.synthetic import synthetic_terramesh_batches

    return list(synthetic_terramesh_batches(batch_size=2, target_size=(32, 32),
                                            modalities=("S2RGB",), mode="S2RGB", seed=seed,
                                            num_batches=n))


def test_refine_adapter_matches_jax():
    """``refine_batches``: the target is the image and the condition the frozen
    VAE's reconstruction (within 1e-4 of JAX's), both NHWC views of fp32
    tensors on the model's device; a batch's own wvs win."""
    jtrainer, ttrainer = _refine_pair()
    batches = _batches(2)
    other = np.asarray([0.49, 0.56, 0.665], np.float32)
    jpairs = list(jtrainer.refine_batches(iter(batches), other))
    tpairs = list(ttrainer.refine_batches(iter(batches), other))
    nowvs = [{"image": b["image"]} for b in batches[:1]]
    jpairs += list(jtrainer.refine_batches(iter(nowvs), other))
    tpairs += list(ttrainer.refine_batches(iter(nowvs), other))
    assert len(tpairs) == len(jpairs) == 3
    for t, j, b in zip(tpairs, jpairs, batches + batches[:1]):
        assert torch.is_tensor(t["image_lr"]) and t["image_lr"].dtype == torch.float32
        assert t["image_lr"].shape == (2, 32, 32, 3)
        assert torch.equal(t["image_hr"], torch.from_numpy(b["image"]))
        np.testing.assert_allclose(t["image_lr"].numpy(), np.asarray(j["image_lr"], np.float32),
                                   **TOL)
    assert not torch.allclose(tpairs[0]["image_lr"], tpairs[2]["image_lr"])


@pytest.fixture(scope="module")
def refiner_fits(tmp_path_factory):
    """The JAX trainer's 2-step fit over the adapted batches (its CSV rows and
    parameters), and the port's with the JAX fit's t and noise injected."""
    import jax
    import jax.numpy as jnp

    from eovax.utils.logging import CSVLogger as JaxCSV
    from eovax_torch.utils.logging import CSVLogger

    jtrainer, ttrainer = _refine_pair()
    root = tmp_path_factory.mktemp("refine")
    jtrainer.logger, ttrainer.logger = JaxCSV(str(root / "jax")), CSVLogger(str(root / "torch"))
    batches = _batches(2)
    key, draws = jax.random.PRNGKey(0), []  # the JAX trainer's key sequence (seed 0)
    for _ in batches:
        key, k = jax.random.split(key)
        t_key, n_key = jax.random.split(k)
        draws.append((torch.from_numpy(np.array(jax.random.uniform(t_key, (2,)))),
                      tg._nchw(np.array(jax.random.normal(n_key, (2, 32, 32, 3), jnp.float32)))))
    jstate = jtrainer.fit(jtrainer.refine_batches(iter(batches), WVS), max_steps=2)
    jfinal = state_dict_from_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                         jstate.params)})
    step, injected = ttrainer.train_step, iter(draws)

    def injected_step(state, hr, lr):
        t, eps = next(injected)
        return step(state, hr, lr, t=t, eps=eps)

    ttrainer.train_step = injected_step
    start = {k: v.clone() for k, v in ttrainer.init_params.state_dict().items()}
    tstate = ttrainer.fit(ttrainer.refine_batches(iter(batches), WVS), max_steps=2)
    return (tg._csv_rows(root / "jax" / "metrics.csv"),
            tg._csv_rows(root / "torch" / "metrics.csv"), jfinal, tstate, start)


def test_refiner_fit_logs_match_jax(refiner_fits):
    jrows, trows, _, tstate, _ = refiner_fits
    assert tstate.step == 2
    assert list(trows[0]) == list(jrows[0]) == ["step", "wall_time", "train_loss",
                                                "steps_per_sec"]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == ["1", "2"]
    for t, j in zip(trows, jrows):
        np.testing.assert_allclose(float(t["train_loss"]), float(j["train_loss"]), rtol=1e-5)


def test_refiner_fit_parameters_match_jax(refiner_fits):
    """The UNet after two Adam steps at lr 1e-3 by tests/test_torch_gan.py's
    rule and bounds (set for its three steps at 1e-4, tighter than this fit's
    Σlr asks): every entry within 6e-4, all but a thousandth within 3e-6, every
    tensor moved."""
    _, _, jfinal, tstate, start = refiner_fits
    final = tstate.model.state_dict()
    assert sorted(final) == sorted(jfinal)
    tg._assert_params_close(final, jfinal, start, "refiner")


def _refine_yaml(tmp_path, **model_over):
    import yaml

    part = {"z_channels": 8, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "use_dynamic_ops": True, "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
    raw = {
        "experiment": {"experiment_name": "refine", "exp_dir": str(tmp_path / "exps")},
        "wandb": {"mode": "disabled"},
        "model": {"base_lr": BASE_LR, "training_mode": "flow-refine",
                  "refiner": {"hid_channels": [16, 16], "hid_blocks": [1, 1],
                              "sampler_steps": 4},
                  "loss_fn": {"_target_": "x.EOConsistencyLoss"},
                  "encoder": {**part, "in_channels": 3}, "decoder": {**part, "out_ch": 3},
                  **model_over},
        "datamodule": {"modalities": ["S2RGB"], "batch_size": 2, "eval_batch_size": 2,
                       "train_collate_mode": "S2RGB", "val_collate_mode": "S2RGB",
                       "target_size": 32},
        "trainer": {"max_epochs": 1, "limit_train_batches": 1, "limit_val_batches": 1,
                    "log_every_n_steps": 1},
    }
    path = tmp_path / "refine.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_train_cli_flow_refine(tmp_path, monkeypatch):
    """``main --device cpu`` with ``training_mode: flow-refine``: 2 steps of the
    refiner (no loss or discriminator built), ``metrics.csv`` with its loss,
    and ``refiner-final.pt`` loading ``strict`` into the refiner's UNet; with
    ``--distilled-ckpt`` and no ``--vae-ckpt`` the mode falls back to finetune."""
    from eovax_torch.cli import train
    from eovax_torch.losses import factory

    config = _refine_yaml(tmp_path)
    args = ["--config", config, "--synthetic-data", "--device", "cpu", "--precision",
            "32-true", "--max-steps", "2"]
    built = []
    build = factory.build_loss_from_config
    monkeypatch.setattr(factory, "build_loss_from_config",
                        lambda *a, **k: built.append(a) or build(*a, **k))
    train.main(args)
    assert built == []
    (exp,) = (tmp_path / "exps").iterdir()
    files = sorted(p.name for p in exp.iterdir())
    assert "refiner-final.pt" in files and "eo-vae-final.pt" not in files
    rows = tg._csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2"] and all(
        np.isfinite(float(r["train_loss"])) for r in rows)
    unet = UNet(in_channels=3, out_channels=3, cond_channels=3, hid_channels=(16, 16),
                hid_blocks=(1, 1))
    unet.load_state_dict(torch.load(exp / "refiner-final.pt", weights_only=True), strict=True)

    model = FluxAutoencoderKL(tiny_cfg(tcfg), device="cpu")
    distill.save_distilled_checkpoint(str(tmp_path / "stems.pt"), model.core,
                                      distill.DistillConfig())
    (tmp_path / "exps").rename(tmp_path / "refine_exps")
    train.main(args + ["--distilled-ckpt", str(tmp_path / "stems.pt")])
    assert len(built) == 1
    (exp,) = (tmp_path / "exps").iterdir()
    files = sorted(p.name for p in exp.iterdir())
    assert "eo-vae-final.pt" in files and "refiner-final.pt" not in files


def test_refiner_rejects_another_band_count():
    """The refiner is built for ``decoder.out_ch`` bands, as in the JAX package:
    a 12-band batch fails in the UNet's first conv."""
    model = FluxAutoencoderKL(tiny_cfg(tcfg), training_mode="flow-refine", device="cpu")
    trainer = model.make_flow_refine_trainer(**REFINER, log_every=0)
    from eovax_torch.data.synthetic import synthetic_terramesh_batches

    batches = synthetic_terramesh_batches(batch_size=2, target_size=(32, 32),
                                          modalities=("S2L2A",), mode="S2L2A", num_batches=1)
    with pytest.raises(RuntimeError):
        trainer.fit(trainer.refine_batches(batches, WVS), max_steps=1)


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_refine_step_on_card_matches_cpu(cuda_device, precision):
    """One refiner train step over the adapter's pair on the card (the frozen
    VAE's reconstruct and the UNet through the hand kernels) against fp32 on
    the CPU at [2,3,32,32] with the same t and noise: the UNet's gradients
    within 1e-3 in fp32 and 1e-1 in bf16 (‖diff‖/‖ref‖), and the step's exact
    hand-kernel launches."""
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.kernels import attention, conv3x3, groupnorm
    from eovax_torch.nn.blocks import AttnBlock, Conv3x3, GroupNorm

    FULL_PRECISION.activate()
    cfg = tiny_cfg(tcfg)
    variables = FluxAutoencoderKL(cfg, device="cpu", seed=0).core.state_dict()
    # Every UNet weight drawn (the shipped init zeroes conv2, proj and conv_out).
    gen = torch.Generator().manual_seed(1)
    unet = UNet(3, 3, 3, REFINER["hid_channels"], REFINER["hid_blocks"])
    unet_sd = {k: (1.0 if "norm" in k and k.endswith("weight") else 0.0)
               + 0.05 * torch.randn(v.shape, generator=gen)
               for k, v in unet.state_dict().items()}
    batch = _batches(1)[0]
    gen = torch.Generator().manual_seed(5)
    t, eps = torch.rand(2, generator=gen), torch.randn(2, 3, 32, 32, generator=gen)
    results = []
    for device, policy in (("cpu", FULL_PRECISION),
                           (cuda_device, FULL_PRECISION if precision == "fp32"
                            else DEFAULT_POLICY)):
        model = FluxAutoencoderKL(cfg, variables, training_mode="flow-refine", policy=policy,
                                  device=device)
        trainer = model.make_flow_refine_trainer(**REFINER, log_every=0)
        trainer.init_params.load_state_dict(unet_sd)
        state = trainer.init_state()
        counters = (conv3x3.conv3x3, conv3x3.conv3x3_dx, groupnorm.group_norm,
                    groupnorm.group_norm_backward)
        before = [f.launches for f in counters] + [attention.flash_attention.launches]
        (pair,) = list(trainer.refine_batches(iter([batch]), WVS))
        hr, cond = trainer._place(pair)
        loss = trainer.denoiser.loss(state.model, hr, t.to(device), cond=cond,
                                     eps=eps.to(device))
        loss.backward()
        if device != "cpu":
            torch.cuda.synchronize()
            vae = [sum(isinstance(m, c) for m in model.core.modules())
                   for c in (Conv3x3, GroupNorm, AttnBlock)]
            unet = [sum(isinstance(m, c) for m in state.model.modules())
                    for c in (Conv3x3, GroupNorm)]
            after = [f.launches for f in counters] + [attention.flash_attention.launches]
            assert [a - b for a, b in zip(after, before)] == [
                vae[0] + unet[0], unet[0], vae[1] + unet[1], unet[1], vae[2] + 1]
        results.append({n: p.grad.float().cpu() for n, p in state.model.named_parameters()})
    ref, got = results
    norm = torch.sqrt(sum(g.double().square().sum() for g in ref.values()))
    diff = torch.sqrt(sum((got[k].double() - g.double()).square().sum() for k, g in ref.items()))
    assert (diff / norm).item() <= (1e-3 if precision == "fp32" else 1e-1), (diff / norm).item()
