"""The port's stage-3 SR training against the JAX package's, in fp32 on the CPU.

A small UNet (``hid_channels`` (32, 16), ``hid_blocks`` (1, 1), 4 latent and 4
condition channels, 16² latents) holds the JAX package's parameter tree with
every leaf drawn from a numpy seed (so ``conv2``, ``proj`` and ``conv_out``
are not the zeros of the shipped init, which would leave every gradient but
``conv_out``'s zero), loaded into the port through
``state_dict_from_variables`` with ``strict=True``. t and the noise are drawn
by the JAX side (from its key sequence where the JAX trainer draws them) and
injected into the port, whose own draws come from a ``torch.Generator``.

Held against ``eovax``: the three denoiser/schedule pairs of the shipped SR
configs' ``loss`` and its gradient with respect to every parameter; a 5-step
trajectory of the train step (warmup schedule, the clip binding); the fit's
CSV rows. Held by the port's own rules: ``validate``, bit-exact resume after a
save and after SIGTERM, ``restore_best``, the train CLI on test-written
latents (its ``sr-final.pt`` loads into the eval CLI), the pixel branch on a
stubbed dataset, and the multi-process guard.

JAX is imported inside the tests that need it, so that the ``gpu`` case runs
on a machine without JAX:

    python -m pytest tests/test_torch_sr_train.py -m gpu --noconftest
"""

import csv
import json
import os
import signal

import numpy as np
import pytest
import torch
import yaml

from eovax_torch.models import sr_diffusion as tsr
from eovax_torch.models.unet import UNet
from eovax_torch.train.sr import DiffusionSuperRes
from eovax_torch.utils import preemption
from eovax_torch.utils.convert import state_dict_from_variables

UNET_KW = dict(in_channels=4, out_channels=4, cond_channels=4, hid_channels=(32, 16),
               hid_blocks=(1, 1))
B, HW, C = 2, 16, 4
# Losses: fp32 through the UNet's convs, norms and attention, summed in other
# orders by XLA and PyTorch.
LOSS_RTOL = 1e-5
# Gradients per tensor: relative to the tensor's largest entry, plus a floor;
# logs and parameters after five steps (tests/test_torch_train.py's TOL).
TOL = dict(rtol=1e-4, atol=1e-6)
# The denoiser/schedule pairs of configs_superres/*.yaml.
DENOISERS = ["SimpleDenoiser-RectifiedSchedule", "KarrasDenoiser-VPSchedule",
             "KarrasDenoiser-DecaySchedule"]
# t of the parity tests: inside [0.2, 0.9] the Karras weight 1/c_out² stays
# below 25 under every schedule. The ends are held apart (test_loss_near_the_ends).
T_MID = np.asarray([0.83, 0.27], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models run fastest on one thread, and one thread does not
    oversubscribe the cores that the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


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
    return ju, params


def _torch_unet(params) -> UNet:
    unet = UNet(**UNET_KW)
    unet.load_state_dict(state_dict_from_variables({"params": params}), strict=True)
    return unet.eval()


def _denoisers(name: str, unet_jax):
    from eovax.models import sr_diffusion as jsr

    def apply_fn(params, x_t, t, cond=None):
        return unet_jax.apply({"params": params}, x_t, t, cond)

    cls, schedule = name.split("-")
    return (getattr(jsr, cls)(apply_fn, getattr(jsr, schedule)()),
            getattr(tsr, cls)(getattr(tsr, schedule)()))


def _pair(seed: int):
    """(hr, lr) NHWC latents."""
    g = np.random.default_rng(seed)
    return tuple(g.standard_normal((B, HW, HW, C)).astype(np.float32) for _ in range(2))


def _jax_loss_and_eps(jd, params, hr, lr, t, seed):
    """The JAX loss at injected t with its own key, and the noise it drew (NCHW)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    eps = np.asarray(jax.random.normal(key, hr.shape, jnp.float32))
    return (lambda p: jd.loss(p, key, jnp.asarray(hr), jnp.asarray(t), cond=jnp.asarray(lr))), \
        _nchw(eps)


# ---------------------------------------------------------------------------
# The losses and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENOISERS)
def test_loss_and_gradients_match_jax(unets, name):
    """The loss at rtol 1e-5, and its gradient with respect to every parameter,
    per tensor within 1e-4 of the tensor's largest entry plus 1e-6."""
    import jax

    ju, params = unets
    jd, td = _denoisers(name, ju)
    hr, lr = _pair(1)
    loss_fn, eps = _jax_loss_and_eps(jd, params, hr, lr, T_MID, seed=2)
    ref, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref_grads = state_dict_from_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                            ref_grads)})
    unet = _torch_unet(params)
    loss = td.loss(unet, _nchw(hr), torch.from_numpy(T_MID), _nchw(lr), eps=eps)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(ref), rtol=LOSS_RTOL)
    loss.backward()
    grads = {n: p.grad for n, p in unet.named_parameters()}
    assert sorted(grads) == sorted(ref_grads)
    for key, want in ref_grads.items():
        got = grads[key]
        tol = TOL["rtol"] * want.abs().max().item() + TOL["atol"]
        assert (got - want.reshape(got.shape)).abs().max().item() <= tol, key


@pytest.mark.parametrize("name", DENOISERS)
def test_loss_near_the_ends(unets, name):
    """t = 1e-3 and 0.999: near t = 0 the Karras weight 1/c_out² reaches 4e5
    (VP) and 1e6 (Decay, sigma_min 1e-3), and x0_hat − x is the difference of
    two O(1) numbers of size ~sigma, so fp32 keeps ~6e-8/sigma of it: rtol 1e-3."""
    ju, params = unets
    jd, td = _denoisers(name, ju)
    hr, lr = _pair(3)
    t = np.asarray([1e-3, 0.999], np.float32)
    loss_fn, eps = _jax_loss_and_eps(jd, params, hr, lr, t, seed=4)
    with torch.no_grad():
        loss = td.loss(_torch_unet(params), _nchw(hr), torch.from_numpy(t), _nchw(lr), eps=eps)
    np.testing.assert_allclose(float(loss), float(loss_fn(params)), rtol=1e-3)


def test_loss_draws_its_noise_from_the_generator(unets):
    _, params = unets
    unet, den = _torch_unet(params), tsr.KarrasDenoiser(tsr.DecaySchedule())
    hr, lr = (_nchw(a) for a in _pair(5))
    t = torch.from_numpy(T_MID)
    with torch.no_grad():
        a = den.loss(unet, hr, t, lr, generator=torch.Generator().manual_seed(6))
        eps = torch.randn(hr.shape, generator=torch.Generator().manual_seed(6))
        b = den.loss(unet, hr, t, lr, eps=eps)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The train step against the JAX trainer's, 5 steps
# ---------------------------------------------------------------------------

STEPS = 5
# A warmup over 152 steps to base_lr 3e-2 (lr 0 at step 0, then 1.97e-4 a
# step) and a clip at 0.05, below every step's gradient norm here.
TRAIN_KW = dict(base_lr=3e-2, final_lr=1e-3, warmup_epochs=1, decay_end_epoch=4,
                grad_clip=0.05, log_every=0, seed=0)


@pytest.fixture(scope="module")
def jax_trainer(unets):
    import jax

    from eovax.parallel.mesh import make_mesh
    from eovax.train.sr import DiffusionSuperRes as JaxSR

    ju, params = unets
    jd, _ = _denoisers("SimpleDenoiser-RectifiedSchedule", ju)
    return JaxSR(denoiser=jd, init_params=params, sampler_steps=2,
                 mesh=make_mesh(jax.devices()[:1]), **TRAIN_KW)


def _torch_trainer(params, **kw) -> DiffusionSuperRes:
    return DiffusionSuperRes(denoiser=tsr.SimpleDenoiser(), init_params=_torch_unet(params),
                             sampler_steps=2, **{**TRAIN_KW, **kw})


@pytest.fixture(scope="module")
def trajectories(unets, jax_trainer):
    import jax
    import jax.numpy as jnp

    _, params = unets
    batches = [_pair(10 + i) for i in range(STEPS)]
    state = jax_trainer.init_state()
    key, jlogs, draws = jax.random.PRNGKey(7), [], []
    for hr, lr in batches:
        key, k = jax.random.split(key)
        t_key, n_key = jax.random.split(k)
        draws.append((np.array(jax.random.uniform(t_key, (B,))),
                      np.array(jax.random.normal(n_key, hr.shape, jnp.float32))))
        state, logs = jax_trainer._train_step(state, jnp.asarray(hr), jnp.asarray(lr), k)
        jlogs.append({k2: float(v) for k2, v in logs.items()})
    jfinal = state_dict_from_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                         state.params)})

    trainer = _torch_trainer(params)
    tstate, norms, grads = trainer.init_state(), [], []
    step = tstate.optimizer.step

    def spy():  # the gradients the optimizer is handed, and their norm before the clip
        grads.append({n: p.grad.clone() for n, p in tstate.model.named_parameters()})
        norms.append(float(step()))
        return norms[-1]

    tstate.optimizer.step = spy
    tlogs = []
    for (hr, lr), (t, eps) in zip(batches, draws):
        logs = trainer.train_step(tstate, _nchw(hr), _nchw(lr), t=torch.from_numpy(t),
                                  eps=_nchw(eps))
        tlogs.append({k: float(v) for k, v in logs.items()})
    return jlogs, jfinal, tlogs, tstate, norms, grads[0]


def test_trajectory_logs_match_jax(trajectories):
    jlogs, _, tlogs, tstate, norms, _ = trajectories
    assert tstate.step == STEPS and [list(t) for t in tlogs] == [list(j) for j in jlogs]
    assert list(tlogs[0]) == ["lr", "train_loss"]
    for j, t in zip(jlogs, tlogs):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-5)
    assert tlogs[0]["lr"] == 0.0 and tlogs[1]["lr"] > 0.0  # the warmup
    assert min(norms) > TRAIN_KW["grad_clip"]  # the clip binds on every step


def test_trajectory_parameters_match_jax(trajectories):
    """Every tensor at TOL, but those whose true gradient is 0: the biases that
    feed only GroupNorms of one channel a group (every ``conv1`` here, whose
    ``norm2`` has 16 or 32 channels; the last up block's ``conv2`` and ``skip``,
    into ``norm_out``), which remove a per-channel constant. Their gradients are
    round-off, below 1e-7 of the gradient's norm (~1e-9, against ≥ 1e-4 for
    every other bias here), and Adam moves each of their entries by about ±lr a
    step with the sign of its round-off on either side: within 2·Σ lr."""
    jlogs, jfinal, _, tstate, _, grads0 = trajectories
    final = tstate.model.state_dict()
    assert sorted(final) == sorted(jfinal)
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads0.values())).item()
    zero = {k for k, g in grads0.items() if g.abs().max().item() <= 1e-7 * norm}
    assert zero == {k for k in final if k.endswith("conv1.bias")} | {
        "up.0.block.1.conv2.bias", "up.0.block.1.skip.bias"}
    adam_bound = 2.0 * sum(log["lr"] for log in jlogs)
    for key, want in jfinal.items():
        got, want = final[key], want.reshape(final[key].shape)
        if key in zero:
            assert (got - want).abs().max().item() <= adam_bound, key
        else:
            torch.testing.assert_close(got, want, **TOL, msg=key)


def test_fit_logs_the_jax_fits_rows(tmp_path, unets, jax_trainer):
    """4 steps with log_every 2: the CSV's columns, step keys and lr equal the
    JAX fit's (lr within fp32 of the float64 schedule); the losses, from other
    draws, are finite."""
    from eovax.utils.logging import CSVLogger as JaxCSV
    from eovax_torch.utils.logging import CSVLogger

    _, params = unets
    batches = [dict(zip(("image_hr", "image_lr"), _pair(20 + i))) for i in range(4)]
    jax_trainer.log_every, jax_trainer.logger = 2, JaxCSV(str(tmp_path / "jax"))
    try:
        jax_trainer.fit(iter(batches), max_steps=4)
    finally:
        jax_trainer.log_every, jax_trainer.logger = 0, None
    trainer = _torch_trainer(params, log_every=2, logger=CSVLogger(str(tmp_path / "torch")))
    assert trainer.fit(iter(batches), max_steps=4).step == 4
    rows = [_csv_rows(tmp_path / side / "metrics.csv") for side in ("jax", "torch")]
    assert list(rows[0][0]) == list(rows[1][0]) == ["step", "wall_time", "lr", "train_loss",
                                                    "steps_per_sec"]
    assert [r["step"] for r in rows[1]] == [r["step"] for r in rows[0]] == ["2", "4"]
    for j, t in zip(*rows):
        np.testing.assert_allclose(float(t["lr"]), float(j["lr"]), rtol=1e-6)
        assert np.isfinite(float(t["train_loss"])) and float(t["steps_per_sec"]) > 0


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# validate, resume, restore_best
# ---------------------------------------------------------------------------


def test_validate_mse_grid_and_best(tmp_path, unets):
    from eovax_torch.utils.image_logger import SuperResImageLogger
    from eovax_torch.utils.logging import CSVLogger

    _, params = unets
    trainer = _torch_trainer(params, ckpt_dir=str(tmp_path / "ckpt"),
                             logger=CSVLogger(str(tmp_path)),
                             image_logger=SuperResImageLogger(str(tmp_path)))
    state = trainer.init_state()
    state.step = 3
    batch = dict(zip(("image_hr", "image_lr"), _pair(30)))
    x1_state = trainer.generator.get_state()
    result = trainer.validate(state, iter([batch, batch]), max_batches=1)
    # The same x1 through the sampler by hand.
    x1 = trainer.sampler.init(torch.Generator().set_state(x1_state), (B, C, HW, HW))
    with torch.no_grad():
        x0 = trainer.sampler(state.model, x1, _nchw(batch["image_lr"]))
    want = float(torch.mean((x0 - _nchw(batch["image_hr"])) ** 2))
    assert list(result) == ["val_mse"] and result["val_mse"] == want
    assert os.path.isfile(tmp_path / "image_log" / "val" / "sr_step00000003.png")
    assert _csv_rows(tmp_path / "metrics.csv")[0]["step"] == "3"
    assert trainer.checkpointer.best_info() == {"step": 3, "metric": want, "monitor": "val_mse",
                                                "mode": "min"}
    # A worse validation keeps the best; a better one replaces it.
    state.step = 4
    worse = {k: 3.0 * v for k, v in batch.items()}
    trainer.validate(state, iter([worse]), max_batches=1)
    assert trainer.checkpointer.best_info()["step"] == 3
    state.step = 5
    trainer.validate(state, iter([{k: 0.1 * v for k, v in batch.items()}]), max_batches=1)
    assert trainer.checkpointer.best_info()["step"] == 5
    best = trainer.restore_best()
    assert best.step == 5 and all(torch.equal(best.model.state_dict()[k], v)
                                  for k, v in state.model.state_dict().items())


def _assert_same_training_state(a, b, trainer_a, trainer_b):
    assert a.step == b.step
    for name, value in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[name], value), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"]
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(sa[key], sb[key])), key
    assert torch.equal(trainer_a.generator.get_state(), trainer_b.generator.get_state())


@pytest.fixture(scope="module")
def straight_run(tmp_path_factory, unets):
    """Four steps without a stop, t and the noise drawn from the generator."""
    _, params = unets
    batches = [dict(zip(("image_hr", "image_lr"), _pair(40 + i))) for i in range(4)]
    trainer = _torch_trainer(params, ckpt_dir=str(tmp_path_factory.mktemp("straight")))
    state = trainer.fit(iter(batches), max_steps=4)
    assert state.step == 4
    return params, batches, trainer, state


@pytest.mark.parametrize("stop", [1, 3])
def test_resume_after_a_save_is_bit_exact(tmp_path, straight_run, stop):
    from eovax_torch.utils.checkpoint import TrainCheckpointer

    params, batches, straight, want = straight_run
    first = _torch_trainer(params, ckpt_dir=str(tmp_path))
    assert first.fit(iter(batches[:stop]), max_steps=4).step == stop
    assert TrainCheckpointer(str(tmp_path)).latest_step() == stop
    second = _torch_trainer(params, ckpt_dir=str(tmp_path))
    got = second.fit(iter(batches[stop:]), max_steps=4)
    _assert_same_training_state(got, want, second, straight)
    # The budget is global: a third run on the same directory takes no step.
    third = _torch_trainer(params, ckpt_dir=str(tmp_path))
    assert third.fit(iter(batches), max_steps=4).step == 4


def test_resume_after_a_validation_is_bit_exact(tmp_path, unets):
    """With a validation every 2 steps (its x1 draws advance the generator) and a
    stop at step 2: the step's save follows its validation, so the resumed run
    draws what a run without a stop draws."""
    _, params = unets
    batches = [dict(zip(("image_hr", "image_lr"), _pair(40 + i))) for i in range(4)]
    val = [dict(zip(("image_hr", "image_lr"), _pair(45)))]
    kw = dict(val_every=2, max_steps=4)
    straight = _torch_trainer(params, ckpt_dir=str(tmp_path / "straight"), val_max_batches=1)
    want = straight.fit(iter(batches), lambda: iter(val), **kw)
    first = _torch_trainer(params, ckpt_dir=str(tmp_path / "stopped"), val_max_batches=1,
                           ckpt_every=2)
    assert first.fit(iter(batches[:2]), lambda: iter(val), **kw).step == 2
    second = _torch_trainer(params, ckpt_dir=str(tmp_path / "stopped"), val_max_batches=1)
    got = second.fit(iter(batches[2:]), lambda: iter(val), **kw)
    _assert_same_training_state(got, want, second, straight)


def test_sigterm_in_the_batch_iterator_stops_saves_and_resumes(tmp_path, straight_run):
    params, batches, straight, want = straight_run
    before = signal.getsignal(signal.SIGTERM)

    def signalled_at_third_batch():
        for i, batch in enumerate(batches):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    preemption.reset_for_tests()
    try:
        first = _torch_trainer(params, ckpt_dir=str(tmp_path), ckpt_every=100)
        assert first.fit(signalled_at_third_batch(), max_steps=4).step == 3
    finally:
        preemption.reset_for_tests()
    assert signal.getsignal(signal.SIGTERM) is before
    second = _torch_trainer(params, ckpt_dir=str(tmp_path))
    _assert_same_training_state(second.fit(iter(batches[3:]), max_steps=4), want, second,
                                straight)


def test_multi_process_run_raises(tmp_path, unets):
    """Under a process group (one gloo process: every collective runs and is
    the identity) the placement keeps the batch and a 2-step fit with its
    validation is ``torch.equal`` to the fit without a group. (The name is that
    of the test of the refusal this replaced.)"""
    from eovax_torch.parallel.mesh import destroy_distributed, init_distributed

    _, params = unets
    batches = [dict(zip(("image_hr", "image_lr"), _pair(50 + i))) for i in range(2)]

    def fit():
        trainer = _torch_trainer(params)
        state = trainer.fit(iter(batches), lambda: iter(batches[:1]), max_steps=2, val_every=2)
        placed = trainer._place(batches[0])
        return state.model.state_dict(), trainer.validate(state, iter(batches[:1]), 1), placed

    ref = fit()
    created = init_distributed("cpu", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                               rank=0)
    try:
        assert created and torch.distributed.get_backend() == "gloo"
        got = fit()
    finally:
        destroy_distributed(created)
    for name, value in ref[0].items():
        assert torch.equal(got[0][name], value), name
    assert got[1] == ref[1]
    for a, b, key in zip(got[2], ref[2], ("image_hr", "image_lr")):
        assert torch.equal(a, b) and torch.equal(a, _nchw(batches[0][key]))


def test_constant_lr_without_a_schedule_and_no_clip(unets):
    """Without final_lr/warmup/decay the rate is base_lr and no lr is logged;
    grad_clip None leaves the gradients unclipped, as the JAX trainer's chain."""
    _, params = unets
    trainer = _torch_trainer(params, final_lr=None, grad_clip=None)
    state = trainer.init_state()
    assert trainer.schedule == TRAIN_KW["base_lr"] and state.optimizer.clip_grad is None
    logs = trainer.train_step(state, *(_nchw(a) for a in _pair(51)))
    assert list(logs) == ["train_loss"] and state.optimizer.count == 1


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------


def _write_latents(root, z: int, hw: int, n: int, seed: int) -> None:
    """encode_latents' schema: {train,val}/{aoi}.npz with CHW latents and images,
    and latent_stats.json."""
    g = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / split).mkdir(parents=True)
        for i in range(n):
            np.savez(root / split / f"aoi{i}.npz",
                     hr_latent=g.normal(0.3, 1.5, (z, hw, hw)).astype(np.float32),
                     lr_latent=g.normal(0.2, 1.2, (z, hw, hw)).astype(np.float32),
                     hr_image=g.normal(size=(4, 2 * hw, 2 * hw)).astype(np.float32),
                     lr_image=g.normal(size=(4, 2 * hw, 2 * hw)).astype(np.float32))
    stats = {k: {"mean": g.normal(size=z).tolist(), "std": g.uniform(0.5, 2.0, z).tolist()}
             for k in ("hr_latent", "lr_latent")}
    (root / "latent_stats.json").write_text(json.dumps(stats))


def _sr_yaml(tmp_path, root, *, backbone, denoiser="SimpleDenoiser",
             schedule="RectifiedSchedule", datamodule=None, trainer=None):
    cfg = {
        "experiment": {"experiment_name": "sr-test", "exp_dir": str(tmp_path / "exps")},
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1, "gradient_clip_val": 1.0,
                    "ckpt_every": 2, "val_every": 2, "limit_val_batches": 1, **(trainer or {})},
        "lightning_module": {
            "base_lr": 1e-4, "final_lr": 1e-5, "warmup_epochs": 1,
            "decay_end_epoch": "${trainer.max_epochs}",
            "denoiser": {"_target_": denoiser, "backbone": backbone,
                         "schedule": {"_target_": schedule}},
            "sampler": {"_target_": "DDIMSampler", "steps": 2}},
        "datamodule": {"root": str(root), "batch_size": 2, **(datamodule or {})},
    }
    path = tmp_path / "sr.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


TINY_BACKBONE = {**UNET_KW, "hid_channels": [32, 16], "hid_blocks": [1, 1]}


def test_train_cli_writes_the_experiment_resumes_and_debug_writes_nothing(tmp_path):
    from eovax_torch.cli.train_super_res import main

    _write_latents(tmp_path / "latents", C, HW, n=4, seed=60)
    config = _sr_yaml(tmp_path, tmp_path / "latents", backbone=TINY_BACKBONE)
    main(["--config", config, "--max-steps", "3", "--device", "cpu"])
    (exp,) = (tmp_path / "exps").iterdir()
    assert {"config.yaml", "metrics.csv", "checkpoints", "image_log", "sr-final.pt",
            "sr-best.pt"} <= set(os.listdir(exp))
    rows = _csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows if r["train_loss"]] == ["1", "2", "3"]
    assert [r["step"] for r in rows if r["val_mse"]] == ["2"]
    assert sorted(os.listdir(exp / "checkpoints")) == ["best", "best_metric.json", "step_2",
                                                       "step_3"]
    assert os.listdir(exp / "image_log" / "val") == ["sr_step00000002.png"]
    for name in ("sr-final.pt", "sr-best.pt"):
        UNet(**UNET_KW).load_state_dict(torch.load(exp / name), strict=True)
    main(["--config", config, "--max-steps", "5", "--device", "cpu", "--resume-dir", str(exp)])
    rows = _csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows if r["train_loss"]] == ["1", "2", "3", "4", "5"]
    # ckpt_every counts this run's steps, as the JAX fit's: the resumed run saves
    # at its second step, 5, and its tail save of step 5 is skipped.
    assert sorted(os.listdir(exp / "checkpoints"))[-2:] == ["step_3", "step_5"]
    (tmp_path / "debug").mkdir()
    debug = _sr_yaml(tmp_path / "debug", tmp_path / "latents", backbone=TINY_BACKBONE)
    main(["--config", debug, "--max-steps", "2", "--device", "cpu", "--debug"])
    assert os.listdir(tmp_path / "debug") == ["sr.yaml"]


# The tiny VAE of tests/test_torch_sr.py, whose z sets the eval CLI's UNet widths.
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


def test_train_cli_full_width_checkpoint_loads_into_the_eval_cli(tmp_path):
    """The shipped widths (256, 128, 64) × (3, 3, 3) on 8-channel 16² latents,
    B = 2, 2 steps in bf16; the eval CLI, which builds the default widths for the
    VAE's z, loads sr-final.pt strictly and samples 2 steps."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import eval_metric_super_res, train_super_res
    from eovax_torch.core import config as tcfg

    _write_latents(tmp_path / "latents", Z, HW, n=2, seed=61)
    backbone = {"in_channels": Z, "out_channels": Z, "cond_channels": Z}
    config = _sr_yaml(tmp_path, tmp_path / "latents", backbone=backbone,
                      trainer={"val_every": 100, "ckpt_every": 100})
    train_super_res.main(["--config", config, "--max-steps", "2", "--device", "cpu"])
    (exp,) = (tmp_path / "exps").iterdir()
    assert not (exp / "sr-best.pt").exists()  # no validation ran
    vae_cfg, vae_ckpt = tmp_path / "model_config.yaml", tmp_path / "eo-vae.ckpt"
    vae_cfg.write_text(yaml.safe_dump(_VAE_YAML))
    vae = EOFluxVAE(_tiny_vae_config(tcfg), device="cpu", seed=1)
    torch.save({"state_dict": vae.core.state_dict()}, vae_ckpt)
    eval_metric_super_res.main([
        "--vae-config", str(vae_cfg), "--vae-ckpt", str(vae_ckpt),
        "--sr-ckpt", str(exp / "sr-final.pt"), "--data-root", str(tmp_path / "latents"),
        "--split", "val", "--batch-size", "2", "--num-batches", "1", "--sr-steps", "2",
        "--output", str(tmp_path / "out"), "--device", "cpu"])
    metrics = json.loads((tmp_path / "out" / "all_metrics.json").read_text())
    assert set(metrics) == {"rmse", "psnr", "ssim", "sam"}
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("domain_adapted", [False, True])
def test_train_cli_pixel_branch_on_a_stubbed_dataset(tmp_path, monkeypatch, domain_adapted):
    """configs_superres/pixel.yaml's branch (Karras + VP on 4-band pixels):
    Sen2NaipCrossSensor needs rasterio, so a stub stands in for it, built with the
    collate the config asks for; 2 steps."""
    from eovax_torch.cli.train_super_res import main
    from eovax_torch.data import sen2naip

    built = []

    class StubPairs:
        def __init__(self, root, split, *, collate, lr_size, hr_size):
            built.append((split, collate, lr_size, hr_size))
            self.collate, self.lr_size, self.hr_size = collate, lr_size, hr_size

        def batches(self, batch_size, *, shuffle=False, seed=0, repeat=False,
                    process_index=0, process_count=1):
            g = np.random.default_rng(seed)
            while True:
                samples = [{"image_lr": g.uniform(0, 4000, (self.lr_size, self.lr_size, 4)),
                            "image_hr": g.uniform(0, 255, (self.hr_size, self.hr_size, 4)),
                            "aoi": "a"} for _ in range(batch_size)]
                yield {**self.collate(samples), "wvs": sen2naip.SEN2NAIP_WVS}
                if not repeat:
                    return

    monkeypatch.setattr(sen2naip, "Sen2NaipCrossSensor", StubPairs)
    config = _sr_yaml(tmp_path, tmp_path / "tifs", backbone=TINY_BACKBONE,
                      denoiser="KarrasDenoiser", schedule="VPSchedule",
                      datamodule={"_target_": "eo_vae.datasets.sen2naip."
                                              "Sen2NaipCrossSensorDataModule",
                                  "lr_size": 8, "hr_size": 16,
                                  "domain_adapted": domain_adapted})
    main(["--config", config, "--max-steps", "2", "--device", "cpu"])
    collate = (sen2naip.sen2naip_domain_adapted_collate if domain_adapted
               else sen2naip.sen2naip_collate)
    assert built == [("train", collate, 8, 16), ("val", collate, 8, 16)]
    (exp,) = (tmp_path / "exps").iterdir()
    rows = _csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows if r["train_loss"]] == ["1", "2"]
    assert all(np.isfinite(float(r["train_loss"])) for r in rows if r["train_loss"])


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
def test_sr_gradients_on_card_match_cpu(cuda_device, dtype, tol):
    """The loss's gradients through the hand kernels' backward (conv3x3_dx, the
    FiLM GroupNorm backward at 2 channels a group, the attention backward at
    D = 64) on the card against fp32 on the CPU, as ‖diff‖/‖ref‖ over all
    parameters, with exact backward launches."""
    from eovax_torch.core.precision import FULL_PRECISION, Policy
    from eovax_torch.kernels import attention, conv3x3, groupnorm
    from eovax_torch.nn.init import init_parameters

    FULL_PRECISION.activate()
    kw = dict(in_channels=8, out_channels=8, cond_channels=8, hid_channels=(32, 64),
              hid_blocks=(1, 1))
    ref_unet = UNet(**kw)
    init_parameters(ref_unet, torch.Generator().manual_seed(0))
    with torch.no_grad():  # conv2, proj and conv_out start at zero: draw every weight
        for p in ref_unet.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    card = UNet(**kw, policy=Policy(compute_dtype=dtype))
    card.load_state_dict(ref_unet.state_dict())
    card.to(cuda_device)
    g = torch.Generator().manual_seed(2)
    x, cond, eps = (torch.randn(2, 8, 32, 32, generator=g) for _ in range(3))
    t = torch.tensor([0.7, 0.2])
    den = tsr.SimpleDenoiser()
    den.loss(ref_unet, x, t, cond, eps=eps).backward()
    conv3x3.conv3x3_dx.launches = groupnorm.group_norm_backward.launches = 0
    attention.flash_attention_backward.launches = attention.flash_attention_backward.calls = 0
    den.loss(card, *(a.to(cuda_device) for a in (x, t, cond)), eps=eps.to(cuda_device)).backward()
    torch.cuda.synchronize()
    # The attention backward: one call of three kernel launches, no tensor-op call.
    assert (conv3x3.conv3x3_dx.launches, groupnorm.group_norm_backward.launches,
            attention.flash_attention_backward.launches,
            attention.flash_attention_backward.calls) == (16, 18, 3, 0)
    ref = {n: p.grad for n, p in ref_unet.named_parameters()}
    diff = sum(((p.grad.float().cpu() - ref[n]).double() ** 2).sum()
               for n, p in card.named_parameters())
    norm = sum((r.double() ** 2).sum() for r in ref.values())
    assert float((diff / norm) ** 0.5) <= tol
