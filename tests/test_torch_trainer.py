"""The port's stage-2 trainer loop and its utilities, against the JAX package.

On the CPU in fp32, with the tiny config of ``tests/test_torch_train.py``:
gradient accumulation against ``optax.MultiSteps``; one ``Stage2Trainer.fit``
against the JAX trainer's; synthetic batches, mode rolls, CSV files and
image grids equal to the JAX package's; the checkpointer; bit-exact resume
after a save and after SIGTERM; the train CLI; and no silent CPU fallback.

JAX is imported only inside the tests that need it, so the card's machine
runs the ``gpu`` test without it:

    python -m pytest tests/test_torch_trainer.py -m gpu --noconftest
"""

import csv
import dataclasses
import os
import random
import signal
import threading
import types

import numpy as np
import pytest
import torch

from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.data.synthetic import synthetic_terramesh_batches
from eovax_torch.data.wavelengths import WAVELENGTHS
from eovax_torch.losses import EOConsistencyLoss
from eovax_torch.train import stage2
from eovax_torch.utils import checkpoint, preemption
from eovax_torch.utils.logging import CSVLogger

BASE_LR = 1e-4
# Logged losses, grad norms and learning rates, and the BN statistics: the
# tolerance of tests/test_torch_train.py (fp32 through ~20 conv layers and
# their gradients, summed in other orders by XLA and PyTorch).
TOL = dict(rtol=1e-4, atol=1e-6)
# Parameters after UPDATES applied Adam updates: where the true gradient is 0
# the two sides move by ±lr with the sign of their round-off, so every entry
# within 2·UPDATES·lr, all but a thousandth within a hundredth of UPDATES·lr
# (tests/test_torch_train.py's rules).
UPDATES = 2
PARAM_ATOL = 2 * UPDATES * BASE_LR
PARAM_CLOSE = 1e-2 * UPDATES * BASE_LR
PARAM_FAR_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models run fastest on one thread, and one thread does not
    oversubscribe the cores that the other test workers share: with torch's
    default of a thread a core, the resume tests ran 20-30 times slower beside
    one other worker."""
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


def _loss(m, msssim=True):
    return m(rec_loss_type="char", msssim_weight=1.0 if msssim else 0.0, msssim_start_step=0)


def _batches(n, size=32, modalities=("S2L2A", "S1RTC", "S2RGB"), seed=0, batch=2):
    return list(synthetic_terramesh_batches(batch_size=batch, target_size=(size, size),
                                            modalities=modalities, seed=seed, num_batches=n))


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# -- (a) accumulation against optax.MultiSteps ---------------------------------


def _adam_state(opt_state):
    inner = getattr(opt_state, "inner_opt_state", opt_state)
    return inner[1][0]  # chain(clip, adam(schedule)): adam is (scale_by_adam, scale_by_schedule)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """Six micro-steps of given gradients, some above the clip and some below:
    parameters, Adam's moments and count, the accumulator and the applied
    learning rate after each, to rtol 1e-6."""
    import jax.numpy as jnp
    import optax

    from eovax.core import config as jcfg
    from eovax.train import stage2 as jstage2

    over = dict(base_lr=1e-2, final_lr=1e-3)
    tx, jschedule = jstage2.make_optimizer(_cfg(jcfg, **over), total_steps=4,
                                           accumulate_steps=k)
    rng = np.random.default_rng(k)
    start = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in start.items()}
    opt, _ = stage2.make_optimizer(_cfg(tcfg, **over), params.values(), total_steps=4,
                                   accumulate_steps=k)
    jparams = {n: jnp.asarray(v) for n, v in start.items()}
    state = tx.init(jparams)

    def close(got, ref, what):
        # rtol 1e-6, plus 1e-6 of the tensor's largest entry for entries that
        # cancel (b1·mu + (1 − b1)·g rounded in another order by XLA).
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"{what} after micro-step {t}")

    for t, scale in enumerate((0.3, 2.5, 0.7, 4.0, 0.2, 1.5)):
        grads = {n: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for n, v in start.items()}
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = opt.step()
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        adam = _adam_state(state)
        assert opt.count == int(adam.count) == (t + 1) // k
        for i, (n, p) in enumerate(params.items()):
            close(p.detach().numpy(), jparams[n], n)
            close(opt.mu[i].numpy(), adam.mu[n], f"mu {n}")
            close(opt.nu[i].numpy(), adam.nu[n], f"nu {n}")
            if k > 1:
                close(opt.acc[i].numpy(), state.acc_grads[n], f"acc {n}")
        if k > 1:
            assert opt.mini_step == int(state.mini_step) == (t + 1) % k
        if opt.count:  # the learning rate of the last applied update
            np.testing.assert_allclose(opt.lr(opt.count - 1), float(jschedule(opt.count - 1)),
                                       rtol=1e-6)
    assert opt.count == 6 // k


# -- (b) one fit against the JAX trainer's ---------------------------------------


def _jax_variables(jcfg_):
    import jax

    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE

    jm = JaxVAE(jcfg_, seed=0)
    g = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + g.normal(0.0, 0.02, a.shape)).astype(np.float32),
        jm.variables)
    variables["batch_stats"]["bn"]["mean"] = g.normal(size=32).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = g.uniform(0.5, 2.0, size=32).astype(np.float32)
    return jm, variables


def test_fit_with_accumulation_matches_the_jax_trainer(tmp_path):
    """Four synthetic S2RGB batches at 96², accumulate_steps=2, log_every=1:
    the CSV rows of both trainers agree step by step, and so do the final
    parameters and BatchNorm statistics. One JAX compile: one modality, one mode."""
    import jax

    from eovax.core import config as jcfg
    from eovax.losses import EOConsistencyLoss as JaxLoss
    from eovax.parallel.mesh import make_mesh
    from eovax.train import stage2 as jstage2
    from eovax.utils.logging import CSVLogger as JaxCSVLogger
    from eovax_torch.utils.convert import state_dict_from_variables

    batches = _batches(4, size=96, modalities=("S2RGB",))
    jm, variables = _jax_variables(_cfg(jcfg))
    jm.variables = jax.tree_util.tree_map(jax.numpy.asarray, variables)
    common = dict(max_steps=4, log_every=1, accumulate_steps=2, seed=0)
    jtrainer = jstage2.Stage2Trainer(model=jm, loss_obj=_loss(JaxLoss), cfg=_cfg(jcfg),
                                     mesh=make_mesh(jax.devices()[:1]),
                                     logger=JaxCSVLogger(str(tmp_path / "jax")), **common)
    jstate = jtrainer.fit(iter(batches))

    model = EOFluxVAE(_cfg(tcfg), state_dict_from_variables(variables), device="cpu")
    trainer = stage2.Stage2Trainer(model=model, loss_obj=_loss(EOConsistencyLoss),
                                   cfg=_cfg(tcfg), logger=CSVLogger(str(tmp_path / "torch")),
                                   **common)
    state = trainer.fit(iter(batches))
    assert state.step == int(jstate.step) == 4 and trainer.optimizer.count == UPDATES

    jrows, rows = (_csv_rows(tmp_path / side / "metrics.csv") for side in ("jax", "torch"))
    assert list(jrows[0]) == list(rows[0])
    assert [r["step"] for r in rows] == ["1", "2", "3", "4"]
    for j, t in zip(jrows, rows):
        for key in j:
            if key.startswith("train/") and key != "train/steps_per_sec":
                np.testing.assert_allclose(float(t[key]), float(j[key]), **TOL,
                                           err_msg=f"{key} at step {t['step']}")

    jfinal = state_dict_from_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    tfinal = model.core.state_dict()
    start = state_dict_from_variables(variables)
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(tfinal[key], jfinal[key], **TOL)
    assert tfinal["bn.num_batches_tracked"].item() == 4
    far = total = moved = 0
    for key, ref in jfinal.items():
        if key.startswith("bn."):
            continue
        diff = (tfinal[key] - ref).abs()
        assert diff.max().item() <= PARAM_ATOL, key
        far += int((diff > PARAM_CLOSE).sum())
        total += diff.numel()
        moved += int((tfinal[key] != start[key]).sum())
    assert far <= PARAM_FAR_SHARE * total, (far, total)
    assert moved > 0


# -- (c) synthetic batches and mode rolls -----------------------------------------


@pytest.mark.parametrize("mode,seed", [("random", 0), ("random", 3), ("S2L2A", 1)])
def test_synthetic_batches_equal_the_jax_generator(mode, seed):
    from eovax.data.synthetic import synthetic_terramesh_batches as jax_batches

    kw = dict(batch_size=2, target_size=(16, 24), mode=mode, seed=seed, num_batches=6)
    ours, ref = list(synthetic_terramesh_batches(**kw)), list(jax_batches(**kw))
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert a["modality"] == b["modality"]
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["wvs"], b["wvs"])
    if mode == "random":
        assert len({b["modality"] for b in ours}) > 1


def test_trainer_mode_rolls_equal_the_jax_trainer():
    from eovax.core import config as jcfg
    from eovax.train import stage2 as jstage2

    over = dict(p_prior=0.4, p_prior_s=0.5, anisotropic=True)
    model = EOFluxVAE(_cfg(tcfg, **over), device="cpu", seed=0)
    trainer = stage2.Stage2Trainer(model=model, loss_obj=_loss(EOConsistencyLoss),
                                   cfg=_cfg(tcfg, **over), seed=7)
    jtrainer = jstage2.Stage2Trainer.__new__(jstage2.Stage2Trainer)
    jtrainer.cfg, jtrainer._rng = _cfg(jcfg, **over), random.Random(7)
    rolls = [stage2.roll_mode(trainer._rng, trainer.cfg) for _ in range(100)]
    assert rolls == [jtrainer._roll_mode() for _ in range(100)]


# -- (d) CSV files ------------------------------------------------------------------


def _csv_without_wall_time(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    col = rows[0].index("wall_time")
    return [r[:col] + r[col + 1:] for r in rows]


def test_csv_logger_files_equal_the_jax_loggers(tmp_path):
    """Column growth, the rewrite it takes, and the append after a resume."""
    from eovax.utils.logging import CSVLogger as JaxCSVLogger

    calls = [(1, {"train/loss": 0.5}), (2, {"train/loss": 0.25}),
             (2, {"val/loss_rec": 0.125, "val/loss_total": 1 / 3}), (3, {"train/loss": 0.1})]
    resumed = [(4, {"train/loss": 0.05}), (4, {"val/new": 2.0}), (5, {"train/loss": 7e-9})]
    for cls, d in ((CSVLogger, tmp_path / "torch"), (JaxCSVLogger, tmp_path / "jax")):
        logger = cls(str(d))
        for step, scalars in calls:
            logger.log(step, scalars)
        logger = cls(str(d))  # a resumed run adopts the header
        for step, scalars in resumed:
            logger.log(step, scalars)
    ours = _csv_without_wall_time(tmp_path / "torch" / "metrics.csv")
    assert ours == _csv_without_wall_time(tmp_path / "jax" / "metrics.csv")
    assert ours[0] == ["step", "train/loss", "val/loss_rec", "val/loss_total", "val/new"]
    assert [r[0] for r in ours[1:]] == ["1", "2", "2", "3", "4", "4", "5"]


# -- (e) image grids ------------------------------------------------------------------


@pytest.mark.parametrize("modality,scheme", [("S2L2A", "custom"), ("S2L2A", "legacy"),
                                             ("S1RTC", "legacy"), ("S2RGB", "custom"),
                                             ("superres", None)])
def test_image_grid_equals_the_jax_loggers(tmp_path, modality, scheme):
    from PIL import Image

    from eovax.utils import image_logger as jlog
    from eovax_torch.utils import image_logger as tlog

    rng = np.random.default_rng(5)
    if modality == "superres":
        lr, pred, hr = (rng.standard_normal(s).astype(np.float32)
                        for s in ((5, 8, 8, 4), (5, 32, 32, 4), (5, 32, 32, 4)))
        paths = [mod.SuperResImageLogger(str(tmp_path / name)).log(lr, pred, hr, step=3)
                 for mod, name in ((tlog, "torch"), (jlog, "jax"))]
    else:
        c = len(WAVELENGTHS[modality])
        x = rng.standard_normal((10, 24, 20, c)).astype(np.float32)
        y = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        paths = [mod.ImageLogger(str(tmp_path / name)).log(x, y, modality=modality,
                                                          norm_scheme=scheme, step=12)
                 for mod, name in ((tlog, "torch"), (jlog, "jax"))]
    assert os.path.relpath(paths[0], tmp_path / "torch") == os.path.relpath(
        paths[1], tmp_path / "jax")
    ours, ref = (np.asarray(Image.open(p)) for p in paths)
    assert ours.dtype == np.uint8 and ours.shape[-1] == 3
    assert np.array_equal(ours, ref)


# -- (f) the checkpointer ---------------------------------------------------------------


def _tree(value):
    return {"step": int(value), "model": {"w": torch.full((3, 2), float(value))},
            "optimizer": {"acc": [torch.arange(4.0) * value], "count": int(value)}}


def _assert_tree_equal(got, ref):
    assert got["step"] == ref["step"] and got["optimizer"]["count"] == ref["optimizer"]["count"]
    assert torch.equal(got["model"]["w"], ref["model"]["w"])
    assert torch.equal(got["optimizer"]["acc"][0], ref["optimizer"]["acc"][0])


def test_checkpointer_round_trip_keeps_the_last_two_and_restores_the_latest(tmp_path):
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    assert ckpt.latest_step() is None and ckpt.restore_latest() is None
    for step in (1, 2, 3):
        assert ckpt.save(step, _tree(step))
    assert not ckpt.save(3, _tree(99))  # a step at or below the last saved is skipped
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3]
    # Unfinished writes are ignored: a temporary, and a step directory without its file.
    os.makedirs(tmp_path / ".tmp_step_7")
    os.makedirs(tmp_path / "step_9")
    assert ckpt.latest_step() == 3
    _assert_tree_equal(ckpt.restore_latest(), _tree(3))
    # A new checkpointer on the same directory resumes after the latest step.
    again = checkpoint.TrainCheckpointer(str(tmp_path))
    assert not again.save(2, _tree(2)) and again.save(4, _tree(4))
    again.wait()
    assert again.all_steps() == [3, 4]


def test_checkpointer_snapshot_is_not_aliased(tmp_path, monkeypatch):
    """The write is held until the live tensors have changed: the file must hold
    the values at save()."""
    release, real_save = threading.Event(), torch.save

    def held_save(obj, path):
        assert release.wait(30)
        real_save(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", held_save)
    live = _tree(1)
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    ckpt.save(1, live)
    live["model"]["w"].add_(100.0)
    live["optimizer"]["acc"][0].mul_(-1.0)
    release.set()
    ckpt.wait()
    _assert_tree_equal(ckpt.restore_latest(), _tree(1))


def test_checkpointer_raises_the_writers_error_again(tmp_path):
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    unpicklable = {"step": 1, "fn": lambda: None}
    ckpt.save(1, unpicklable)
    with pytest.raises(Exception, match="pickle|lambda"):
        ckpt.wait()
    ckpt.wait()  # raised once
    ckpt.save(2, unpicklable)
    with pytest.raises(Exception, match="pickle|lambda"):
        ckpt.save(3, _tree(3))  # the next save raises it
    assert ckpt.latest_step() is None
    assert ckpt.save(3, _tree(3))
    ckpt.wait()
    assert ckpt.latest_step() == 3


def test_checkpointer_best_by_val_loss_rec(tmp_path):
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    assert ckpt.best_info() is None and ckpt.restore_best() is None
    assert ckpt.save_best(1, _tree(1), 0.5, monitor="val/loss_rec")
    assert not ckpt.save_best(2, _tree(2), 0.5, monitor="val/loss_rec")  # strictly better only
    assert ckpt.save_best(3, _tree(3), 0.25, monitor="val/loss_rec")
    assert not ckpt.save_best(4, _tree(4), 0.3, monitor="val/loss_rec")
    info = checkpoint.TrainCheckpointer(str(tmp_path)).best_info()
    assert info == {"step": 3, "metric": 0.25, "monitor": "val/loss_rec", "mode": "min"}
    _assert_tree_equal(ckpt.restore_best(), _tree(3))
    assert not os.path.exists(tmp_path / "best_metric.json.tmp")


def test_save_and_load_variables_reads_through_eoflux_load_checkpoint(tmp_path):
    source = EOFluxVAE(_cfg(tcfg), device="cpu", seed=1)
    path = str(tmp_path / "sub" / "model.pt")
    checkpoint.save_variables(path, source.core.state_dict())
    loaded = checkpoint.load_variables(path)
    target = EOFluxVAE(_cfg(tcfg), device="cpu", seed=2)
    target.load_checkpoint(path)
    for name, value in source.core.state_dict().items():
        assert torch.equal(loaded[name], value) and torch.equal(target.core.state_dict()[name],
                                                                value)


# -- (g, h) resume, after a save and after SIGTERM ----------------------------------------


def _trainer(ckpt_dir, variables, **kw):
    cfg = _cfg(tcfg)
    model = EOFluxVAE(cfg, variables, device="cpu")
    return stage2.Stage2Trainer(model=model, loss_obj=_loss(EOConsistencyLoss, msssim=False),
                                cfg=cfg, max_steps=4, accumulate_steps=2, log_every=0,
                                ckpt_dir=str(ckpt_dir), **kw)


def _assert_same_training_state(a, b):
    for name, value in a.core.state_dict().items():
        assert torch.equal(b.core.state_dict()[name], value), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sa["count"], sa["mini_step"]) == (sb["count"], sb["mini_step"])
    for key in ("mu", "nu", "acc"):
        assert len(sa[key]) == len(sb[key]) and all(
            torch.equal(x, y) for x, y in zip(sa[key], sb[key])), key


@pytest.fixture(scope="module")
def straight_run(tmp_path_factory):
    """Four micro-steps (two updates) without a stop, from fixed variables."""
    variables = EOFluxVAE(_cfg(tcfg), device="cpu", seed=3).core.state_dict()
    batches = _batches(4, seed=11)
    trainer = _trainer(tmp_path_factory.mktemp("straight"), variables)
    assert trainer.fit(iter(batches)).step == 4
    return variables, batches, trainer


@pytest.mark.parametrize("stop", [1, 2, 3])
def test_resume_after_a_save_is_bit_exact(tmp_path, straight_run, stop):
    """Stopped after `stop` micro-steps (1 and 3: the saved accumulator holds a
    gradient), resumed by a fresh trainer to 4: parameters, BN statistics,
    Adam's state and the accumulator equal the straight run's bit for bit."""
    variables, batches, straight = straight_run
    first = _trainer(tmp_path, variables)
    assert first.fit(iter(batches[:stop])).step == stop
    assert checkpoint.TrainCheckpointer(str(tmp_path)).latest_step() == stop
    if stop % 2:
        assert any(a.abs().sum() > 0 for a in first.optimizer.acc)
    second = _trainer(tmp_path, variables)
    assert second.fit(iter(batches[stop:])).step == 4
    _assert_same_training_state(second, straight)


def test_sigterm_in_the_batch_iterator_stops_saves_and_resumes(tmp_path, straight_run):
    variables, batches, straight = straight_run
    before = signal.getsignal(signal.SIGTERM)

    def signalled_at_third_batch():
        for i, batch in enumerate(batches):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    preemption.reset_for_tests()
    try:
        first = _trainer(tmp_path, variables, ckpt_every=100)
        assert first.fit(signalled_at_third_batch()).step == 3
    finally:
        preemption.reset_for_tests()
    assert signal.getsignal(signal.SIGTERM) is before
    assert checkpoint.TrainCheckpointer(str(tmp_path)).latest_step() == 3
    second = _trainer(tmp_path, variables)
    assert second.fit(iter(batches[3:])).step == 4
    _assert_same_training_state(second, straight)


def test_preemption_guard_chains_restores_and_rejects_several_processes(tmp_path):
    """The handler chains and is restored; a guard off the main thread sees the
    flag; under a group the ranks agree every ``sync_every`` steps. (The name is
    that of the test whose last part checked the refusal this replaced.)"""
    from eovax_torch.parallel.mesh import destroy_distributed, init_distributed

    seen = []
    previous = signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    try:
        preemption.reset_for_tests()
        with preemption.PreemptionGuard() as guard:
            assert not guard.should_stop(1)
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.should_stop(2) and preemption.PreemptionGuard.signalled()
            assert seen == [signal.SIGTERM]  # the earlier handler ran too
        assert signal.getsignal(signal.SIGTERM).__name__ == "<lambda>"
        # A guard off the main thread is inert but still sees the flag.
        result = []
        worker = threading.Thread(
            target=lambda: result.append(preemption.PreemptionGuard().__enter__().should_stop()))
        worker.start()
        worker.join(10)
        assert result == [True]
        preemption.reset_for_tests()
        # Under a process group (one gloo process) the ranks' flags are OR-ed at
        # the steps that sync_every divides, and every other step reads False.
        created = init_distributed("cpu", init_method=f"file://{tmp_path / 'store'}",
                                   world_size=1, rank=0)
        try:
            with preemption.PreemptionGuard(sync_every=10) as guard:
                assert not guard.should_stop(10)
                os.kill(os.getpid(), signal.SIGTERM)
                assert not guard.should_stop(11) and not guard.should_stop(19)
                assert guard.should_stop(20) and guard.should_stop(21)
        finally:
            destroy_distributed(created)
    finally:
        signal.signal(signal.SIGTERM, previous)
        preemption.reset_for_tests()


# -- validation and the trainer's guards ----------------------------------------------------


def test_validate_logs_means_writes_the_grid_and_best_and_changes_no_state(tmp_path):
    from eovax_torch.utils.image_logger import ImageLogger

    cfg = _cfg(tcfg)
    model = EOFluxVAE(cfg, device="cpu", seed=4)
    logger = CSVLogger(str(tmp_path))
    trainer = stage2.Stage2Trainer(model=model, loss_obj=_loss(EOConsistencyLoss, msssim=False),
                                   cfg=cfg, ckpt_dir=str(tmp_path / "ckpt"), logger=logger,
                                   image_logger=ImageLogger(str(tmp_path)), norm_scheme="custom")
    state = stage2.TrainState(step=5)
    before = {k: v.clone() for k, v in model.core.state_dict().items()}
    means = trainer.validate(state, iter(_batches(3, modalities=("S2L2A",))), max_batches=2)
    assert sorted(means) == ["val/loss_rec", "val/loss_total"]
    assert all(torch.equal(before[k], v) for k, v in model.core.state_dict().items())
    assert os.path.isfile(tmp_path / "image_log" / "val" / "recon_S2L2A_step00000005.png")
    assert _csv_rows(logger.path)[0]["step"] == "5"
    assert trainer.checkpointer.best_info()["step"] == 5
    # The next train step runs in train mode and updates the latent statistics.
    trainer.train_on_batch(state, _batches(1)[0])
    assert model.core.training and not torch.equal(model.core.bn.running_mean,
                                                   before["bn.running_mean"])


def test_adversarial_loss_without_a_discriminator_is_refused():
    """As the JAX trainer: a loss with ``generator_loss`` needs a discriminator."""
    from eovax_torch.losses.gan import EOPatchLoss

    cfg = _cfg(tcfg)
    with pytest.raises(ValueError, match="requires a discriminator"):
        stage2.Stage2Trainer(model=EOFluxVAE(cfg, device="cpu"), loss_obj=EOPatchLoss(), cfg=cfg)


def test_no_silent_cpu_fallback(tmp_path):
    """Without CUDA the model, the trainer and the CLI raise unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from eovax_torch.cli import train

    cfg = _cfg(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EOFluxVAE(cfg)
    cpu = EOFluxVAE(cfg, device="cpu")
    moved = types.SimpleNamespace(core=cpu.core, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        stage2.Stage2Trainer(model=moved, loss_obj=_loss(EOConsistencyLoss), cfg=cfg)
    config = _write_tiny_yaml(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--config", config, "--synthetic-data", "--max-steps", "1",
                    "--precision", "32-true"])


# -- (i) the train CLI -------------------------------------------------------------------------


def _write_tiny_yaml(tmp_path, name="tiny.yaml", **model_over):
    import yaml

    stem = {"num_layers": 1, "wv_planes": 32, "use_adain": True}
    part = {"z_channels": 8, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "use_dynamic_ops": True, "dynamic_conv_kwargs": stem}
    raw = {
        "experiment": {"experiment_name": "tiny", "exp_dir": str(tmp_path / "exps")},
        "wandb": {"mode": "disabled"},
        "model": {"base_lr": BASE_LR, "final_lr": 1e-5, "warmup_epochs": 0,
                  "decay_end_epoch": 1, "clip_grad": 1.0,
                  "loss_fn": {"_target_": "eo_vae.models.modules.consistency_loss."
                                          "EOConsistencyLoss", "rec_loss_type": "char"},
                  "encoder": {**part, "in_channels": 4}, "decoder": {**part, "out_ch": 4},
                  **model_over},
        "datamodule": {"modalities": ["S2L2A", "S1RTC", "S2RGB"], "batch_size": 2,
                       "eval_batch_size": 2, "norm_scheme": "custom", "target_size": 32},
        "trainer": {"max_epochs": 1, "limit_train_batches": 1, "limit_val_batches": 1,
                    "log_every_n_steps": 1},
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_train_cli_writes_the_experiment_and_resumes(tmp_path):
    from eovax_torch.cli import train

    config = _write_tiny_yaml(tmp_path)
    args = ["--config", config, "--synthetic-data", "--device", "cpu", "--precision", "32-true"]
    train.main(args + ["--max-steps", "2"])
    (exp,) = (tmp_path / "exps").iterdir()
    for name in ("config.yaml", "metrics.csv", "checkpoints", "eo-vae-final.pt",
                 "eo-vae-best.pt", "image_log"):
        assert (exp / name).exists(), name
    ckpt = checkpoint.TrainCheckpointer(str(exp / "checkpoints"))
    assert ckpt.all_steps() == [1, 2]
    model = EOFluxVAE(_cfg(tcfg), device="cpu", seed=9)
    model.load_checkpoint(str(exp / "eo-vae-final.pt"))
    for name, value in ckpt.restore_latest()["model"].items():
        assert torch.equal(model.core.state_dict()[name], value), name
    best = EOFluxVAE(_cfg(tcfg), device="cpu", seed=9)
    best.load_checkpoint(str(exp / "eo-vae-best.pt"))

    train.main(args + ["--max-steps", "3", "--resume-dir", str(exp)])
    assert ckpt.all_steps() == [2, 3]
    rows = _csv_rows(exp / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "1", "2", "2", "3", "3"]
    assert rows[4]["train/loss_rec"] and rows[5]["val/loss_rec"]
    model.load_checkpoint(str(exp / "eo-vae-final.pt"))
    for name, value in ckpt.restore_latest()["model"].items():
        assert torch.equal(model.core.state_dict()[name], value), name


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    """The int8 policy is refused (inference only, as in the JAX CLI);
    ``training_mode: flow-refine``, refused until the port had it, trains the
    refiner of ``FluxAutoencoderKL`` (on S2RGB batches: the refiner has
    ``decoder.out_ch`` = 3 channels) and writes ``refiner-final.pt``."""
    from pathlib import Path

    import yaml

    from eovax_torch.cli import train

    config = _write_tiny_yaml(tmp_path)
    with pytest.raises(SystemExit, match="int8"):
        train.main(["--config", config, "--synthetic-data", "--device", "cpu",
                    "--precision", "int8"])
    refine = _write_tiny_yaml(tmp_path, "refine.yaml", training_mode="flow-refine",
                              refiner={"hid_channels": [16, 16], "hid_blocks": [1, 1]})
    raw = yaml.safe_load(Path(refine).read_text())
    raw["model"]["decoder"]["out_ch"] = 3
    raw["datamodule"]["modalities"] = ["S2RGB"]
    raw["experiment"]["exp_dir"] = str(tmp_path / "refine_exps")
    Path(refine).write_text(yaml.safe_dump(raw))
    train.main(["--config", refine, "--synthetic-data", "--device", "cpu", "--precision",
                "32-true", "--max-steps", "1"])
    (exp,) = (tmp_path / "refine_exps").iterdir()
    assert (exp / "refiner-final.pt").is_file() and not (exp / "eo-vae-final.pt").exists()


# -- the loss factory --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["eo-vae.yaml", "finetune_consistency_bases.yaml",
                                  "finetune_consistency_factor.yaml",
                                  "finetune_dyn_conv_rgb.yaml", "finetune_gan.yaml"])
def test_loss_factory_matches_the_jax_factory_on_the_shipped_configs(name):
    from eovax.core.config import VAEConfig as JaxVAEConfig
    from eovax.losses.factory import build_loss_from_config as jax_build
    from eovax_torch.core.config import load_yaml
    from eovax_torch.losses.factory import build_loss_from_config

    raw = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs", name))
    loss_cfg = raw.get("model", {}).get("loss_fn")
    ours, disc, seed_stem = build_loss_from_config(loss_cfg, tcfg.VAEConfig.from_dict(raw))
    ref, jdisc, jseed = jax_build(loss_cfg, JaxVAEConfig.from_dict(raw))
    assert type(ours).__name__ == type(ref).__name__ and seed_stem == jseed
    skip = ("dofa_features", "disc_apply", "lpips_apply")
    fields = [f.name for f in dataclasses.fields(ours) if f.name not in skip]
    assert [getattr(ours, f) for f in fields] == [getattr(ref, f) for f in fields]
    if jdisc is None:
        assert disc is None
        return
    # The discriminator: its class and hyperparameters (the flax module's fields).
    assert type(disc).__name__ == type(jdisc).__name__ and not disc.training
    hyper = [f.name for f in dataclasses.fields(jdisc) if f.name not in ("policy", "parent",
                                                                          "name")]
    assert [getattr(disc, f) for f in hyper] == [getattr(jdisc, f) for f in hyper]


def test_loss_factory_dofa_term(tmp_path, capsys):
    from eovax_torch.losses.factory import build_loss_from_config

    vae = _cfg(tcfg)
    cfg = {"_target_": "x.EOConsistencyLoss", "feature_weight": 0.5,
           "dofa_net": {"ckpt_data": str(tmp_path / "absent.pt")}}
    loss, disc, _ = build_loss_from_config(cfg, vae)
    assert loss.feature_weight == 0.0 and loss.dofa_features is None and disc is None
    assert "not found — perceptual/feature term disabled" in capsys.readouterr().out
    # A present checkpoint builds the term: a frozen feature net over its weights.
    from eovax_torch.models import dofa

    net = dict(img_size=32, embed_dim=32, depth=3, num_heads=4, wv_planes=32, out_indices=[0, 1])
    vit, _ = dofa.dofav3_large_patch16_224(**net)
    torch.save({f"model.{k}": v for k, v in vit.state_dict().items()}, tmp_path / "dofa.pt")
    cfg["dofa_net"] = {"_target_": "eo_vae.models.dofa.dofav3_large_patch16_224",
                       "weights_path": str(tmp_path / "dofa.pt"), **net}
    loss, _, _ = build_loss_from_config(cfg, vae)
    assert loss.feature_weight == 0.5 and isinstance(loss.dofa_features, dofa.DOFAFeatures)
    feats = loss.dofa_features(torch.zeros(1, 3, 32, 32), torch.tensor([0.665, 0.56, 0.49]))
    assert [tuple(f.shape) for f in feats] == [(1, 4, 32)] * 2
    with pytest.raises(ValueError, match="Unknown loss"):
        build_loss_from_config({"_target_": "x.Other"}, vae)


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_step_fit_on_card_matches_cpu(cuda_device):
    """A 2-step fit of the tiny model in fp32 on the card (every conv3x3 and
    GroupNorm through the hand kernels, both ways) against the CPU: the logged
    losses, grad norms and BatchNorm statistics within 1e-3, the parameters
    by the PARAM_ATOL / PARAM_CLOSE / PARAM_FAR_SHARE rules (two updates)."""
    from eovax_torch.kernels import conv3x3, groupnorm
    from eovax_torch.nn.blocks import Conv3x3, GroupNorm

    cfg = _cfg(tcfg)
    variables = EOFluxVAE(cfg, device="cpu", seed=0).core.state_dict()
    batches = _batches(2, size=96, modalities=("S2RGB",))
    logs, states = [], []
    for device in ("cpu", cuda_device):
        model = EOFluxVAE(cfg, variables, device=device)
        rows = []
        logger = types.SimpleNamespace(log=lambda step, scalars, rows=rows: rows.append(scalars))
        trainer = stage2.Stage2Trainer(model=model, loss_obj=_loss(EOConsistencyLoss), cfg=cfg,
                                       max_steps=2, log_every=1, logger=logger)
        before = (conv3x3.conv3x3.launches, conv3x3.conv3x3_dx.launches,
                  groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches)
        assert trainer.fit(iter(batches)).step == 2
        if device != "cpu":
            torch.cuda.synchronize()
            n_conv = sum(isinstance(m, Conv3x3) for m in model.core.modules())
            n_gn = sum(isinstance(m, GroupNorm) for m in model.core.modules())
            after = (conv3x3.conv3x3.launches, conv3x3.conv3x3_dx.launches,
                     groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches)
            assert [a - b for a, b in zip(after, before)] == [2 * n_conv, 2 * n_conv,
                                                              2 * n_gn, 2 * n_gn]
        logs.append(rows)
        states.append({k: v.cpu() for k, v in model.core.state_dict().items()})
    for ref, got in zip(*logs):
        for key in ("train/loss_rec", "train/loss_msssim", "train/grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-3, err_msg=key)
    far = total = 0
    for name, ref in states[0].items():
        if name.startswith("bn."):
            continue
        diff = (states[1][name] - ref).abs()
        assert diff.max().item() <= PARAM_ATOL, name
        far += int((diff > PARAM_CLOSE).sum())
        total += diff.numel()
    assert far <= PARAM_FAR_SHARE * total, (far, total)
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(states[1][key], states[0][key], rtol=1e-3, atol=1e-6)
