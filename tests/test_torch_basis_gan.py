"""The adversarial stage 2 of ``configs/finetune_consistency_bases.yaml`` against
the JAX package's, in fp32 on the CPU: the shared-basis stems under EOPatchLoss
over a DynamicPatchGAN.

The shrunk config of ``tests/test_torch_basis.py`` (its 128 bases, ranks 64 and
32), the loss with ``disc_start`` 1 (the first step trains the generator alone),
MS-SSIM off (32² is too small for its five scales) and a two-layer
discriminator, whose stem is its own (the factory seeds it from the encoder
only for transformer stems). Held: a 3-step ``make_adversarial_steps``
trajectory against the JAX trainer's CSV rows, parameters and spectral stats
(as ``tests/test_torch_gan.py`` holds the DynamicPatchGAN's), the train CLI on
the config's copy, and the bf16 adaptive weight against the JAX package's
(ROADMAP Queue 3, item 2). The JAX side runs with the ``_conv`` its
``forward_gan`` needs (``tests/test_torch_basis.py``'s ``jax_basis_conv``).

JAX is imported only inside the tests that need it, so the card's machine runs
the ``gpu`` tests without it:

    python -m pytest tests/test_torch_basis_gan.py -m gpu --noconftest
"""

import types

import numpy as np
import pytest
import torch

import test_torch_basis as tb
import test_torch_gan as tg
from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.losses import gan
from eovax_torch.losses.factory import build_loss_from_config
from eovax_torch.train import stage2
from eovax_torch.utils.convert import discriminator_state_dict, state_dict_from_variables

LOSS_CFG = {**tb.bases_raw()["model"]["loss_fn"], "disc_start": 1, "ssim_weight": 0.0,
            "discriminator": {"_target_": "eo_vae.models.modules.consistency_loss."
                                          "DynamicPatchGAN", "n_layers": 2}}
STEPS = tg.STEPS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX trainer over three S2RGB batches at 32², log_every 1, from drawn
    generator and discriminator variables."""
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.losses.factory import build_loss_from_config as jax_build
    from eovax.parallel.mesh import make_mesh
    from eovax.train import stage2 as jstage2
    from eovax.utils.logging import CSVLogger as JaxCSVLogger

    jc = tb.bases_cfg(jcfg)
    jm, variables = tb.jax_bases_model()
    jloss, jdisc, seed_stem = jax_build(LOSS_CFG, jc)
    assert not seed_stem
    log_dir = tmp_path_factory.mktemp("jax_fit")
    jtrainer = jstage2.Stage2Trainer(model=jm, loss_obj=jloss, cfg=jc, discriminator=jdisc,
                                     mesh=make_mesh(jax.devices()[:1]),
                                     logger=JaxCSVLogger(str(log_dir)), max_steps=STEPS,
                                     log_every=1, seed=0)
    disc_vars = tg._jax_disc_vars(jdisc, 3, seed=7)
    params, dparams = (jax.tree_util.tree_map(jnp.asarray, t)
                       for t in (variables["params"], disc_vars))
    state = jstage2.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=jtrainer.tx.init(params), disc_params=dparams,
        disc_opt_state=jtrainer.disc_tx.init(dparams["params"]))
    with tb.jax_basis_conv():
        state = jtrainer.fit(iter(tg._batches(STEPS)), state=state)
    state = jax.tree_util.tree_map(np.asarray, state)
    return dict(variables=variables, disc_vars=disc_vars,
                rows=tg._csv_rows(log_dir / "metrics.csv"),
                final=state_dict_from_variables({"params": state.params,
                                                 "batch_stats": state.batch_stats}),
                disc=discriminator_state_dict(state.disc_params))


@pytest.fixture(scope="module")
def trajectory(jax_fit):
    """The port's ``make_adversarial_steps`` over the same batches from the same
    start, with the trainer's gate (the discriminator from disc_start on)."""
    cfg = tb.bases_cfg(tcfg)
    model = EOFluxVAE(cfg, state_dict_from_variables(jax_fit["variables"]), device="cpu")
    loss, disc, seed_stem = build_loss_from_config(LOSS_CFG, cfg)
    assert not seed_stem
    disc.load_state_dict(discriminator_state_dict(jax_fit["disc_vars"]), strict=True)
    disc_start = {k: v.clone() for k, v in disc.state_dict().items()}
    opt, schedule = stage2.make_optimizer(cfg, model.core.parameters(), total_steps=STEPS)
    dopt = stage2.ClippedAdam(disc.parameters(), cfg.base_lr, clip_grad=None)
    gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, opt, disc, dopt, cfg,
                                                        schedule=schedule)
    state, logs = stage2.TrainState(), []
    for i, batch in enumerate(tg._batches(STEPS)):
        image = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).contiguous()
        wvs = torch.from_numpy(batch["wvs"])
        log, recon, target = gen_step(state, image, wvs)
        if i >= loss.disc_start:
            log.update(disc_step(state, target, wvs, recon))
        logs.append({k: float(v) for k, v in log.items()})
    return dict(logs=logs, final=model.core.state_dict(), disc=disc.state_dict(),
                disc_start=disc_start)


def test_trajectory_logs_match_jax(jax_fit, trajectory):
    logs = trajectory["logs"]
    tg._assert_logs_match(jax_fit["rows"], logs)
    assert "train/loss_disc" not in logs[0] and "train/loss_disc" in logs[1]
    assert logs[0]["train/disc_weight"] == 0.0 and 0.0 < logs[1]["train/disc_weight"] <= 2.0


def test_trajectory_generator_parameters_match_jax(jax_fit, trajectory):
    """Every generator tensor by tests/test_torch_gan.py's Adam rule, the basis
    stems among them, and the latent BatchNorm's statistics."""
    start = state_dict_from_variables(jax_fit["variables"])
    tg._assert_params_close(trajectory["final"], jax_fit["final"], start, "generator")
    for stem in ("encoder.conv_in.basis_bank", "decoder.conv_out.hypernet.expansion.weight"):
        assert not torch.equal(trajectory["final"][stem], start[stem]), stem
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(trajectory["final"][key], jax_fit["final"][key], **tg.TOL)


def test_trajectory_discriminator_and_spectral_stats_match_jax(jax_fit, trajectory):
    tg._assert_params_close(trajectory["disc"], jax_fit["disc"], trajectory["disc_start"],
                            "discriminator", tg.DISC_FAR_SHARE)
    stats = [k for k in jax_fit["disc"] if k.endswith((".u", ".sigma"))]
    assert stats
    for key in stats:
        torch.testing.assert_close(trajectory["disc"][key], jax_fit["disc"][key], rtol=1e-5,
                                   atol=1e-6)


def test_train_cli_on_the_bases_config(tmp_path):
    """``main --device cpu`` for 2 steps on the config's copy (disc_start 0,
    MS-SSIM off, 32²): the discriminator's keys in the CSV, its updates in the
    checkpoint, and ``eo-vae-final.pt`` carrying the basis stems into a fresh
    model that reconstructs a batch as the checkpoint's weights do."""
    import yaml

    from eovax_torch.cli import train
    from eovax_torch.utils import checkpoint

    raw = tb.bases_raw()
    raw["model"]["loss_fn"].update(disc_start=0, ssim_weight=0.0)
    raw["experiment"]["exp_dir"] = str(tmp_path / "exps")
    raw["datamodule"].update(batch_size=2, eval_batch_size=2, target_size=[32, 32])
    raw["trainer"].update(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
                          log_every_n_steps=1)
    config = tmp_path / "bases.yaml"
    config.write_text(yaml.safe_dump(raw))
    train.main(["--config", str(config), "--synthetic-data", "--max-steps", "2", "--device",
                "cpu", "--precision", "32-true"])
    (exp,) = (tmp_path / "exps").iterdir()
    rows = tg._csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2", "2"]
    assert all(rows[i]["train/loss_disc"] for i in (0, 1)) and rows[2]["val/loss_rec"]
    saved = checkpoint.TrainCheckpointer(str(exp / "checkpoints")).restore_latest()
    assert saved["step"] == 2 and saved["disc_optimizer"]["count"] == 2
    model = EOFluxVAE(tb.bases_cfg(tcfg), device="cpu", seed=3)
    model.load_checkpoint(str(exp / "eo-vae-final.pt"))
    for key, value in saved["model"].items():
        assert torch.equal(model.core.state_dict()[key], value), key
    ref = EOFluxVAE(tb.bases_cfg(tcfg), saved["model"], device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 12, 32, 32)).astype(np.float32)
    out = model.reconstruct(x, tb.WVS[12])
    assert torch.isfinite(out).all() and torch.equal(out, ref.reconstruct(x, tb.WVS[12]))


# -- the bf16 adaptive weight (ROADMAP Queue 3, item 2) -----------------------------------------

# Each package's bf16 weight against its fp32 weight, and the two bf16 weights
# against each other: the GAN half is the norm of a gradient back through the
# bf16 discriminator's 3-4 layers, each rounding to bf16 (2^-8); 5e-2 is about
# 13 such roundings. The reconstruction halves pass one bf16 conv output.
AW_TOL = 5e-2
AW_REC_TOL = 1e-3


@pytest.mark.parametrize("kind", ["patch", "nlayer"])
def test_bf16_adaptive_weight_matches_jax(kind, capsys):
    """Both packages' ``adaptive_weight`` at the same inputs: the basis model's
    fp32 penultimate activation (rounded to bf16 for the bf16 case), its
    generated output kernel and bias, a drawn discriminator (EOPatchLoss's
    DynamicPatchGAN with its hinge generator term, or EOGenerativeLoss's
    NLayerDiscriminator on ``robust_normalize``), the clamp lifted so the ratio
    shows. In fp32 the two agree to 1e-5; in bf16 each is off its fp32 weight by
    its own discriminator's rounding, by as much in JAX as in the port."""
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import DEFAULT_POLICY as JB
    from eovax.core.precision import FULL_PRECISION as JF
    from eovax.losses import gan as jgan
    from eovax.models.backbone import EOVAECore as JaxCore
    from eovax.nn.dynamic_conv import apply_dynamic_kernel as japply
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.nn.dynamic_conv import apply_dynamic_kernel

    jm, variables = tb.jax_bases_model()
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    wvs = jnp.asarray(tb.WVS[3])
    with tb.jax_basis_conv():
        _, _, h_pre, kernel, bias = jm.core.apply(variables, jnp.asarray(x), wvs,
                                                  sample_posterior=False,
                                                  method=JaxCore.forward_gan)
    results = {}
    for label, jp, tp in (("fp32", JF, FULL_PRECISION), ("bf16", JB, DEFAULT_POLICY)):
        if kind == "patch":
            jd, td = (m.DynamicPatchGAN(ndf=32, n_layers=2, policy=p)
                      for m, p in ((jgan, jp), (gan, tp)))
        else:
            jd, td = (m.NLayerDiscriminator(ndf=16, n_layers=2, policy=p)
                      for m, p in ((jgan, jp), (gan, tp)))
        dv = tg._drawn(jd, jnp.zeros((1, 64, 64, 3)), wvs, seed=1)
        td.load_state_dict(discriminator_state_dict(dv), strict=True)
        td.eval()
        h = jnp.asarray(h_pre).astype(jp.compute_dtype)

        def recon(k):
            return japply(h, k, bias, policy=jp)

        def jrec(k):
            return jnp.mean(jnp.abs(jnp.clip(recon(k), -2.5, 5.0) - x))

        def jgan_loss(k):
            if kind == "patch":
                return -jnp.mean(jd.apply(dv, jnp.clip(recon(k), -2.5, 5.0), wvs))
            return jgan.vanilla_g_loss(jd.apply(dv, jgan.robust_normalize(recon(k)), wvs))

        jw = float(jgan.adaptive_weight(jrec, jgan_loss, kernel, max_weight=1e9))
        jhalves = [float(jnp.linalg.norm(jax.grad(f)(kernel))) for f in (jrec, jgan_loss)]

        k = torch.from_numpy(np.array(kernel).transpose(3, 2, 0, 1)).requires_grad_(True)
        ht = tg._nchw(np.asarray(h.astype(jnp.float32))).to(tp.compute_dtype)
        r = apply_dynamic_kernel(ht, k, torch.from_numpy(np.array(bias)), policy=tp)
        trec = (r.clamp(-2.5, 5.0).float() - tg._nchw(x)).abs().mean()
        if kind == "patch":
            tgan = -td(r.clamp(-2.5, 5.0), torch.from_numpy(tb.WVS[3])).float().mean()
        else:
            tgan = gan.vanilla_g_loss(td(gan.robust_normalize(r),
                                         torch.from_numpy(tb.WVS[3])).float())
        thalves = [torch.autograd.grad(f, k, retain_graph=True)[0].norm().item()
                   for f in (trec, tgan)]
        tw = float(gan.adaptive_weight(trec, tgan, k, max_weight=1e9))
        results[label] = dict(jax=jw, port=tw, jax_halves=jhalves, port_halves=thalves)

    f32, b16 = results["fp32"], results["bf16"]
    ref = f32["jax"]
    with capsys.disabled():
        print(f"\nadaptive weight ({kind}, [1,3,64,64], CPU): fp32 JAX {f32['jax']:.6f} port "
              f"{f32['port']:.6f}; bf16 JAX {b16['jax']:.6f} ({b16['jax'] / ref - 1:+.3%} of "
              f"fp32) port {b16['port']:.6f} ({b16['port'] / ref - 1:+.3%}); bf16 halves "
              f"rec JAX {b16['jax_halves'][0]:.6e} port {b16['port_halves'][0]:.6e}, gan JAX "
              f"{b16['jax_halves'][1]:.6e} port {b16['port_halves'][1]:.6e}")
    assert abs(f32["port"] - ref) <= 1e-5 * ref
    assert abs(b16["jax"] - ref) <= AW_TOL * ref and abs(b16["port"] - ref) <= AW_TOL * ref
    assert abs(b16["port"] - b16["jax"]) <= AW_TOL * ref
    rec = b16["jax_halves"][0]
    assert abs(b16["port_halves"][0] - rec) <= AW_REC_TOL * rec


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_basis_adversarial_step_on_card_matches_cpu(cuda_device, precision):
    """One generator + discriminator step of the shrunk bases model on the card
    (the body's conv3x3 and GroupNorm through the hand kernels, both ways)
    against fp32 on the CPU, one step before the GAN's start (the term gated
    off, its backward and the adaptive weight still computed): the generator's
    and the discriminator's gradients within 1e-3 in fp32 and 1e-1 in bf16,
    with exact hand-kernel launches. With the term on, this tiny model's
    adaptive weight moves by 6e-4 under a 1e-7 relative change of the weights,
    and its generator gradients differ by 1.55e-3 between two CPU runs (1 and 4
    threads): the term-on gradients are held at full width by ``chip_smoke.py``
    phase 14."""
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.kernels import attention, conv3x3, groupnorm
    from eovax_torch.nn.blocks import AttnBlock, Conv3x3, GroupNorm

    FULL_PRECISION.activate()
    cfg = tb.bases_cfg(tcfg)
    variables = EOFluxVAE(cfg, device="cpu", seed=0).core.state_dict()
    disc_state = build_loss_from_config(LOSS_CFG, cfg, seed=4)[1].state_dict()
    image = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    step = 0  # LOSS_CFG's disc_start is 1
    results = []
    for device, policy in (("cpu", FULL_PRECISION),
                           (cuda_device, FULL_PRECISION if precision == "fp32"
                            else DEFAULT_POLICY)):
        model = EOFluxVAE(cfg, variables, policy=policy, device=device)
        loss, disc, _ = build_loss_from_config(LOSS_CFG, cfg, policy=policy)
        disc.load_state_dict(disc_state)
        disc.to(device)
        keep = types.SimpleNamespace(zero_grad=lambda: None, step=lambda: torch.zeros(()))
        gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, keep, disc, keep,
                                                            cfg)
        counters = (conv3x3.conv3x3, conv3x3.conv3x3_dx, groupnorm.group_norm,
                    groupnorm.group_norm_backward)
        before = [f.launches for f in counters] + [attention.flash_attention.launches]
        state = stage2.TrainState(step=step)
        wvs = torch.from_numpy(tb.WVS[3]).to(device)
        _, recon, target = gen_step(state, image.to(device), wvs)
        grads = {f"g.{n}": p.grad.float().cpu() for n, p in model.core.named_parameters()}
        disc_step(state, target, wvs, recon)
        grads.update({f"d.{n}": p.grad.float().cpu() for n, p in disc.named_parameters()})
        if device != "cpu":
            torch.cuda.synchronize()
            n_conv = sum(isinstance(m, Conv3x3) for m in model.core.modules())
            n_gn = sum(isinstance(m, GroupNorm) for m in model.core.modules())
            n_attn = sum(isinstance(m, AttnBlock) for m in model.core.modules())
            after = [f.launches for f in counters] + [attention.flash_attention.launches]
            assert [a - b for a, b in zip(after, before)] == [n_conv, n_conv, n_gn, n_gn,
                                                              n_attn]
        results.append(grads)
    ref, got = results
    tol = 1e-3 if precision == "fp32" else 1e-1
    for prefix in ("g.", "d."):
        keys = [k for k in ref if k.startswith(prefix)]
        norm = torch.sqrt(sum(ref[k].double().square().sum() for k in keys))
        diff = torch.sqrt(sum((got[k].double() - ref[k].double()).square().sum() for k in keys))
        assert (diff / norm).item() <= tol, (prefix, (diff / norm).item())
