"""The port's stage-2 train step against the JAX package's, on the CPU in fp32.

Both sides start from the same variables (the JAX package's init, perturbed,
with non-trivial latent BatchNorm statistics) and take the same numpy batch
through five steps of ``make_train_step`` with the Charbonnier + MS-SSIM loss
(start step 0), ``clip_grad`` 1.0 and a cosine schedule. The posterior is
not sampled and the latent noise is off, as in the JAX package's own
deterministic goldens; the random branches are held by their statistics.
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eovax.core import config as jcfg
from eovax.losses import EOConsistencyLoss as JaxLoss
from eovax.models.backbone import EOVAECore as JaxCore
from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
from eovax.train import stage2 as jstage2
from eovax.train.schedule import cosine_warmup_schedule as jax_schedule
from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.losses import EOConsistencyLoss
from eovax_torch.nn.distributions import DiagonalGaussian
from eovax_torch.train import stage2
from eovax_torch.train.schedule import cosine_warmup_schedule
from eovax_torch.utils.convert import state_dict_from_variables

WVS = np.asarray([0.665, 0.56, 0.49, 0.842], np.float32)
STEPS = 5
BASE_LR = 1e-4
# Losses, grad norms and BN statistics: fp32 through ~20 conv layers and their
# gradients, summed in other orders by XLA and PyTorch, over five steps.
TOL = dict(rtol=1e-4, atol=1e-6)
# First-step gradients, per tensor: relative to the tensor's largest entry, plus
# a floor relative to the global norm for the tensors whose true gradient is 0
# (a conv bias before a one-channel GroupNorm group, the attention's key bias),
# which hold round-off of either side.
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
# Parameters after five steps: Adam moves an entry by at most about lr a step,
# lr·sign(g) on the first, so where the true gradient is 0 the two sides move
# by ±lr with the sign of their round-off. Every entry within 2·STEPS·lr; all
# but a thousandth of them within a hundredth of STEPS·lr.
PARAM_ATOL = 2 * STEPS * BASE_LR
PARAM_CLOSE = 1e-2 * STEPS * BASE_LR
PARAM_FAR_SHARE = 1e-3


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


def _variables(cfg):
    jm = JaxVAE(cfg, seed=0)
    g = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.02, a.shape)).astype(np.float32),
        jm.variables,
    )
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    return jm, variables


def _loss(m):
    return m(rec_loss_type="char", msssim_weight=1.0, msssim_start_step=0)


def _jax_run(cfg, variables, image, scale, angle):
    """Five JAX steps: per-step logs, the first step's gradients, final variables."""
    jm, loss = JaxVAE(cfg, seed=0), _loss(JaxLoss)
    tx, schedule = jstage2.make_optimizer(cfg, total_steps=10)
    step = jax.jit(functools.partial(
        jstage2.make_train_step(jm.core, loss, tx, cfg, schedule=schedule), scale=scale,
        angle=angle))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jstage2.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                  variables["batch_stats"]),
                               opt_state=tx.init(params))
    x, wvs, key = jnp.asarray(image.transpose(0, 2, 3, 1)), jnp.asarray(WVS), jax.random.PRNGKey(0)

    def loss_fn(p):
        (recon, _), _ = jm.core.apply(
            {"params": p, "batch_stats": state.batch_stats}, x, wvs, rng=key,
            sample_posterior=False, scale=scale, angle=angle, train=True,
            method=JaxCore.forward, mutable=["batch_stats"])
        return loss(jstage2._eqvae_target(x, recon, scale, angle), wvs, recon)[0]

    grads = jax.jit(jax.grad(loss_fn))(params)
    if cfg.freeze_body:
        grads = jstage2._mask_grads(grads, jstage2._freeze_mask(params, True), True)
    logs = []
    for _ in range(STEPS):
        state, log = step(state, x, wvs, key)
        logs.append({k: float(v) for k, v in log.items()})
    final = {"params": state.params, "batch_stats": state.batch_stats}
    return logs, state_dict_from_variables({"params": grads}), state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, final))


def _torch_run(cfg, variables, image, scale, angle):
    model = EOFluxVAE(cfg, state_dict_from_variables(variables), device="cpu")
    core = model.core
    opt, schedule = stage2.make_optimizer(cfg, core.parameters(), total_steps=10)
    step = stage2.make_train_step(core, _loss(EOConsistencyLoss), opt, cfg, schedule=schedule)
    grads = []
    clip_and_step = opt.step

    def spy():  # the gradients the optimizer is handed, before its clip
        grads.append({n: p.grad.clone() for n, p in core.named_parameters()
                      if p.grad is not None})
        return clip_and_step()

    opt.step = spy
    state, x, wvs = stage2.TrainState(), torch.from_numpy(image), torch.from_numpy(WVS)
    logs = [{k: float(v) for k, v in step(state, x, wvs, scale=scale, angle=angle).items()}
            for _ in range(STEPS)]
    assert state.step == STEPS
    return logs, grads[0], core.state_dict()


CASES = {
    "plain": (dict(), 96, None, None),
    "eqvae-scale0.5-angle1": (dict(), 160, 0.5, 1),
    "freeze_body": (dict(freeze_body=True), 96, None, None),
}


@pytest.fixture(scope="module", params=list(CASES))
def trajectories(request):
    over, res, scale, angle = CASES[request.param]
    jc, tc = _cfg(jcfg, **over), _cfg(tcfg, **over)
    _, variables = _variables(jc)
    image = np.random.default_rng(1).standard_normal((2, 4, res, res)).astype(np.float32)
    return (request.param, variables, _jax_run(jc, variables, image, scale, angle),
            _torch_run(tc, variables, image, scale, angle))


def test_losses_grad_norms_and_learning_rates(trajectories):
    _, _, (jlogs, _, _), (tlogs, _, _) = trajectories
    assert [sorted(t) for t in tlogs] == [sorted(j) for j in jlogs]
    for j, t in zip(jlogs, tlogs):
        for key in j:
            np.testing.assert_allclose(t[key], j[key], **TOL, err_msg=key)
    assert tlogs[-1]["train/loss_total"] < tlogs[0]["train/loss_total"]


def test_first_step_gradients_per_tensor(trajectories):
    name, _, (_, jgrads, _), (_, tgrads, _) = trajectories
    assert sorted(tgrads) == sorted(jgrads)
    floor = GRAD_FLOOR * torch.sqrt(sum(g.double().square().sum() for g in jgrads.values()))
    for key, ref in jgrads.items():
        got, ref = tgrads[key], ref.reshape(tgrads[key].shape)
        tol = GRAD_RTOL * ref.abs().max().item() + floor.item()
        assert (got - ref).abs().max().item() <= tol, (name, key)


def test_latent_batchnorm_statistics(trajectories):
    _, _, (_, _, jfinal), (_, _, tfinal) = trajectories
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(tfinal[key], jfinal[key], **TOL)
    assert tfinal["bn.num_batches_tracked"].item() == STEPS


def test_parameters_after_five_steps(trajectories):
    name, variables, (_, _, jfinal), (_, _, tfinal) = trajectories
    start = state_dict_from_variables(variables)
    moved = far = total = 0
    for key, ref in jfinal.items():
        if key.startswith("bn."):
            continue
        diff = (tfinal[key] - ref).abs()
        assert diff.max().item() <= PARAM_ATOL, (name, key)
        far += int((diff > PARAM_CLOSE).sum())
        total += diff.numel()
        moved += int((tfinal[key] != start[key]).sum())
        if name == "freeze_body" and ".conv_in." not in key and ".conv_out." not in key:
            assert torch.equal(tfinal[key], start[key]), key
    assert far <= PARAM_FAR_SHARE * total, (far, total)
    assert moved > 0


def test_schedule_matches_jax():
    for args in ((1e-3, 1e-5, 100, 1000), (2e-4, 0.0, 0, 50), (1e-4, 1e-6, 2000, 120000)):
        ours, ref = cosine_warmup_schedule(*args), jax_schedule(*args)
        for step in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 1500, 130000):
            # the JAX schedule is evaluated in fp32
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=3e-5, atol=1e-12)


def test_make_optimizer_without_schedule_and_accumulation():
    """A constant learning rate, and accumulate_steps=2 as optax.MultiSteps: the
    parameters move on every second micro-step, by Adam on the mean gradient."""
    import optax

    cfg, jc = _cfg(tcfg, final_lr=None), _cfg(jcfg, final_lr=None)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, schedule = stage2.make_optimizer(cfg, [p], accumulate_steps=2)
    assert schedule == BASE_LR and opt.lr(7) == BASE_LR
    tx, _ = jstage2.make_optimizer(jc, accumulate_steps=2)
    ref, state = jnp.zeros(3), tx.init(jnp.zeros(3))
    for t, g in enumerate(np.random.default_rng(9).standard_normal((4, 3)).astype(np.float32)):
        before = p.detach().clone()
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, ref)
        ref = optax.apply_updates(ref, updates)
        assert torch.equal(p.detach(), before) == (t % 2 == 0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=0)


@pytest.mark.parametrize("norm_scale", [0.5, 1.0, 3.0])
def test_clip_is_optax_clip_by_global_norm(norm_scale):
    """g where the norm is below the max, else g·max/norm, with no +1e-6."""
    import optax

    g = np.random.default_rng(2).standard_normal(10).astype(np.float32)
    g = g / np.linalg.norm(g) * norm_scale
    p = torch.nn.Parameter(torch.zeros(10))
    opt = stage2.ClippedAdam([p], 0.0, clip_grad=1.0)
    p.grad = torch.from_numpy(g.copy())
    norm = opt.step()
    ref, _ = optax.clip_by_global_norm(1.0).update(jnp.asarray(g), None)
    np.testing.assert_allclose(norm.item(), norm_scale, rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_eqvae_target_matches_jax():
    image = np.random.default_rng(3).standard_normal((2, 4, 20, 20)).astype(np.float32)
    recon = np.zeros((2, 4, 10, 10), np.float32)
    ref = jstage2._eqvae_target(jnp.asarray(image.transpose(0, 2, 3, 1)),
                                jnp.asarray(recon.transpose(0, 2, 3, 1)), 0.5, 3)
    out = stage2._eqvae_target(torch.from_numpy(image), torch.from_numpy(recon), 0.5, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-6,
                               atol=1e-6)


def test_roll_mode_matches_the_jax_trainer():
    cfg = _cfg(tcfg, p_prior=0.4, p_prior_s=0.5, anisotropic=True)
    trainer = jstage2.Stage2Trainer.__new__(jstage2.Stage2Trainer)
    trainer.cfg, trainer._rng = _cfg(jcfg, p_prior=0.4, p_prior_s=0.5, anisotropic=True), \
        random.Random(5)
    rng = random.Random(5)
    rolls = [stage2.roll_mode(rng, cfg) for _ in range(200)]
    assert rolls == [trainer._roll_mode() for _ in range(200)]
    assert {type(s) for s, _ in rolls} == {tuple, float, type(None)}


def _tiny_core(**over):
    cfg = _cfg(tcfg, **over)
    return cfg, EOFluxVAE(cfg, device="cpu", seed=0).core


def test_remat_gives_the_gradients_of_the_plain_blocks():
    cfg, core = _tiny_core()
    remat = stage2.EOVAECore(cfg.encoder, cfg.decoder, remat=True)
    remat.load_state_dict(core.state_dict())
    assert sum(b.remat for b in remat.modules() if hasattr(b, "remat")) == 6
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 4, 32, 32))
                         .astype(np.float32))
    wvs = torch.from_numpy(WVS)
    grads = []
    for m in (core, remat):
        recon, _ = m(x, wvs, sample_posterior=False, train=True)
        recon.square().mean().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-7)


def test_train_mode_batchnorm_matches_jax():
    from eovax.nn.latent import LatentBatchNorm as JaxBN

    from eovax_torch.nn.latent import LatentBatchNorm

    x = np.random.default_rng(6).normal(1.0, 2.0, (3, 8, 5, 4)).astype(np.float32)
    mean0, var0 = np.linspace(-1, 1, 8, dtype=np.float32), np.linspace(0.5, 2, 8,
                                                                        dtype=np.float32)
    bn = LatentBatchNorm(8)
    bn.running_mean.copy_(torch.from_numpy(mean0))
    bn.running_var.copy_(torch.from_numpy(var0))
    out = bn(torch.from_numpy(x), use_running_average=False)
    ref, upd = JaxBN(8).apply({"batch_stats": {"mean": mean0, "var": var0}},
                              jnp.asarray(x.transpose(0, 2, 3, 1)), use_running_average=False,
                              mutable=["batch_stats"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], rtol=1e-6)


def test_posterior_sample_carries_the_reparameterised_gradient():
    mean = torch.full((4000, 2, 1, 1), 0.5, requires_grad=True)
    logvar = torch.full((4000, 2, 1, 1), np.log(0.09), requires_grad=True)  # σ = 0.3
    z = DiagonalGaussian(mean, logvar).sample(torch.Generator().manual_seed(0))
    assert abs(z.mean().item() - 0.5) < 0.02 and abs(z.std().item() - 0.3) < 0.02
    z.sum().backward()
    assert torch.equal(mean.grad, torch.ones_like(mean))
    noise = (z - 0.5) / 0.3
    torch.testing.assert_close(logvar.grad, 0.5 * 0.3 * noise.detach(), rtol=1e-4, atol=1e-5)


def test_latent_noise_gate_rate_and_sigma_range():
    """Gate rate p over many draws; σ per sample in [0, τ)."""
    from eovax_torch.models.backbone import EOVAECore

    g = torch.Generator().manual_seed(0)
    z = torch.zeros(64, 4, 8, 8)
    gated = 0
    for _ in range(400):
        out = EOVAECore._latent_noise(z, 0.3, 0.8, g)
        if out.abs().sum() > 0:
            gated += 1
            sigma = out.flatten(1).std(dim=1)
            assert sigma.max().item() < 0.8 * 1.2 and sigma.min().item() >= 0.0
    assert abs(gated / 400 - 0.3) < 0.06
    sigmas = torch.cat([EOVAECore._latent_noise(torch.zeros(2000, 1, 16, 16), 1.0, 0.8, g)
                        .flatten(1).std(dim=1)])
    assert abs(sigmas.mean().item() - 0.4) < 0.02  # σ ~ U[0, 0.8)


def test_forward_in_train_mode_with_noise_and_sampling_is_seeded():
    cfg, core = _tiny_core()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4, 32, 32))
                         .astype(np.float32))
    wvs = torch.from_numpy(WVS)
    outs = []
    for seed in (0, 0, 1):
        core.load_state_dict(_tiny_core()[1].state_dict())
        recon, _ = core(x, wvs, generator=torch.Generator().manual_seed(seed), train=True,
                        latent_noise_p=1.0, noise_tau=0.8)
        outs.append(recon.detach())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_eval_step_logs_val_keys_and_updates_nothing():
    cfg, core = _tiny_core()
    before = {k: v.clone() for k, v in core.state_dict().items()}
    eval_step = stage2.make_eval_step(core, _loss(EOConsistencyLoss))
    image = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 4, 96, 96))
                             .astype(np.float32))
    logs = eval_step(stage2.TrainState(step=3), image, torch.from_numpy(WVS),
                     torch.Generator().manual_seed(0))
    assert sorted(logs) == ["val/loss_msssim", "val/loss_rec", "val/loss_total"]
    assert all(torch.equal(before[k], v) for k, v in core.state_dict().items())


def test_freeze_mask_keeps_only_the_stems():
    _, core = _tiny_core()
    mask = stage2._freeze_mask(core, True)
    trainable = sorted({n.split(".")[0] + "." + n.split(".")[1] for n, m in mask.items() if m})
    assert trainable == ["decoder.conv_out", "encoder.conv_in"]
    assert all(stage2._freeze_mask(core, False).values())


def test_train_config_fields_match_jax():
    fields = ("freeze_body", "base_lr", "final_lr", "warmup_epochs", "decay_end_epoch",
              "clip_grad", "p_prior", "p_prior_s", "anisotropic", "latent_noise_p", "noise_tau",
              "sample_posterior")
    defaults = [{f.name: f.default for f in dataclasses.fields(m.VAEConfig) if f.name in fields}
                for m in (jcfg, tcfg)]
    assert defaults[0] == defaults[1] and len(defaults[0]) == len(fields)
