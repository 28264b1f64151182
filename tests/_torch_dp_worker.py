"""Ranks of the port's data-parallel tests.

    python tests/_torch_dp_worker.py SPEC RANK

Each rank joins a gloo group of ``spec["world"]`` processes through the file
store ``spec["store"]``, runs ``spec["scenarios"]`` in order on its rows of
each global batch, and saves what they return as ``<spec["out"]>/rank<r>.pt``.
The tests run the same scenario functions in one process, without a group, on
the whole batch as the reference; :func:`start` and :func:`finish` (or
:func:`spawn`, both) run the ranks. This module imports no JAX, so the ranks
start in a few seconds.
"""

from __future__ import annotations

import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from eovax_torch import EOFluxVAE  # noqa: E402
from eovax_torch.core import config as tcfg  # noqa: E402
from eovax_torch.losses import EOConsistencyLoss, gan  # noqa: E402
from eovax_torch.models import sr_diffusion  # noqa: E402
from eovax_torch.models.unet import UNet  # noqa: E402
from eovax_torch.nn.latent import LatentBatchNorm  # noqa: E402
from eovax_torch.parallel.mesh import barrier  # noqa: E402
from eovax_torch.train import stage2  # noqa: E402
from eovax_torch.train.sr import DiffusionSuperRes  # noqa: E402
from eovax_torch.utils import checkpoint, preemption  # noqa: E402
from eovax_torch.utils.image_logger import ImageLogger  # noqa: E402
from eovax_torch.utils.logging import CSVLogger  # noqa: E402

WVS = np.asarray([0.665, 0.56, 0.49, 0.842], np.float32)
BASE_LR = 1e-4
STEPS = 3
UNET_KW = dict(in_channels=4, out_channels=4, cond_channels=4, hid_channels=(32, 16),
               hid_blocks=(1, 1))
SR_KW = dict(base_lr=3e-2, final_lr=1e-3, warmup_epochs=1, decay_end_epoch=4, grad_clip=0.05,
             log_every=0, seed=0, sampler_steps=2)
# Seconds a rank may take; every child is killed after it.
TIMEOUT_S = 180


def tiny_cfg(m=tcfg, **over):
    """The tiny VAE of the port's train tests (ch 32, ch_mult (1, 2), 4 bands)."""
    stem = m.StemConfig(num_layers=1, wv_planes=32, use_adain=True)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem,
              in_channels=4, out_ch=4)
    enc = {k: v for k, v in kw.items() if k != "out_ch"}
    dec = {k: v for k, v in kw.items() if k != "in_channels"}
    train = dict(base_lr=BASE_LR, final_lr=1e-5, warmup_epochs=0, decay_end_epoch=1,
                 clip_grad=1.0, sample_posterior=False, latent_noise_p=0.0)
    return m.VAEConfig(encoder=m.EncoderConfig(**enc), decoder=m.DecoderConfig(**dec),
                       **{**train, **over})


def rows(x, rank: int, world: int):
    """Rank ``rank``'s rows of the global batch ``x`` (an array, or a dict of
    them whose ndim ≥ 2 leaves are split)."""
    if isinstance(x, dict):
        return {k: rows(v, rank, world) if getattr(v, "ndim", 0) >= 2 else v
                for k, v in x.items()}
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


class SaveCounter:
    """Counts ``torch.save`` calls (the checkpoint writes) while it is entered."""

    def __enter__(self):
        self.calls, self._save = 0, torch.save

        def counting(*args, **kw):
            self.calls += 1
            return self._save(*args, **kw)

        torch.save = counting
        return self

    def __exit__(self, *exc):
        torch.save = self._save


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def latent_bn(spec, rank, world):
    """``normalize_batch`` on this rank's rows; the input gradient of the rank's
    share of Σ y·w + Σ new_mean·a + Σ new_var·c."""
    x = torch.from_numpy(rows(spec["bn_x"], rank, world)).requires_grad_()
    bn = LatentBatchNorm(x.shape[1])
    bn.running_mean.copy_(torch.from_numpy(spec["bn_mean"]))
    bn.running_var.copy_(torch.from_numpy(spec["bn_var"]))
    y, (mean, var) = bn.normalize_batch(x)
    a, c = (torch.from_numpy(spec[k]) for k in ("bn_a", "bn_c"))
    loss = (y * torch.from_numpy(rows(spec["bn_w"], rank, world))).sum()
    loss = loss + ((mean * a).sum() + (var * c).sum()) / world
    loss.backward()
    return dict(y=y.detach(), running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(), count=int(bn.num_batches_tracked),
                grad=x.grad)


@scenario
def unequal_rows(spec, rank, world):
    """``place_batch`` of 2 + rank rows: refused on every rank (the message)."""
    from eovax_torch.parallel.mesh import make_mesh, place_batch

    try:
        place_batch({"image": np.zeros((2 + rank, 4, 4, 3), np.float32)}, make_mesh("cpu"))
    except ValueError as e:
        return str(e)
    return "placed"


def _train_steps(spec, rank, world, **over):
    cfg = tiny_cfg(**over)
    core = EOFluxVAE(cfg, spec["variables"], device="cpu").core
    opt, schedule = stage2.make_optimizer(cfg, core.parameters(), total_steps=10)
    step = stage2.make_train_step(core, EOConsistencyLoss(rec_loss_type="char"), opt, cfg,
                                  schedule=schedule)
    state, g = stage2.TrainState(), torch.Generator().manual_seed(0)
    x, wvs = torch.from_numpy(rows(spec["image"], rank, world)), torch.from_numpy(WVS)
    logs = [{k: float(v) for k, v in step(state, x, wvs, g).items()} for _ in range(STEPS)]
    return dict(logs=logs, final=core.state_dict())


@scenario
def stage2_sampled(spec, rank, world):
    """``make_train_step``, STEPS steps, the posterior sampled and the latent noise on."""
    return _train_steps(spec, rank, world, sample_posterior=True, latent_noise_p=0.9,
                        noise_tau=0.5)


@scenario
def stage2_mode(spec, rank, world):
    """``make_train_step``, STEPS steps on the posterior's mode (the JAX tests' setting)."""
    return _train_steps(spec, rank, world)


@scenario
def adversarial(spec, rank, world):
    """Two ``make_adversarial_steps`` generator + discriminator steps with
    EOPatchLoss over the DynamicPatchGAN, the GAN term on from step 0."""
    cfg = tiny_cfg()
    core = EOFluxVAE(cfg, spec["variables"], device="cpu").core
    disc = gan.DynamicPatchGAN(ndf=16, n_layers=2, wv_planes=32)
    disc.load_state_dict(spec["disc"])
    disc.eval()
    loss = gan.EOPatchLoss(disc_start=0, ssim_weight=0.0)
    opt, schedule = stage2.make_optimizer(cfg, core.parameters(), total_steps=10)
    dopt = stage2.ClippedAdam(disc.parameters(), cfg.base_lr, clip_grad=None)
    gen_step, disc_step = stage2.make_adversarial_steps(core, loss, opt, disc, dopt, cfg,
                                                        schedule=schedule)
    state, logs = stage2.TrainState(), []
    x, wvs = torch.from_numpy(rows(spec["image"], rank, world)), torch.from_numpy(WVS)
    for _ in range(2):
        log, recon, target = gen_step(state, x, wvs)
        log.update(disc_step(state, target, wvs, recon))
        logs.append({k: float(v) for k, v in log.items()})
    return dict(logs=logs, final=core.state_dict(), disc=disc.state_dict())


def sr_trainer(spec):
    unet = UNet(**UNET_KW)
    unet.load_state_dict(spec["unet"])
    return DiffusionSuperRes(denoiser=sr_diffusion.SimpleDenoiser(), init_params=unet, **SR_KW)


@scenario
def sr(spec, rank, world):
    """STEPS SR ``train_step``s (t and the noise from the trainer's generator),
    then ``validate`` on one batch (its x1 from the generator too)."""
    trainer = sr_trainer(spec)
    state = trainer.init_state()
    hr, lr = (torch.from_numpy(np.ascontiguousarray(rows(spec[k], rank, world).transpose(
        0, 3, 1, 2))) for k in ("sr_hr", "sr_lr"))
    logs = [trainer.train_step(state, hr, lr) for _ in range(STEPS)]
    val = trainer.validate(state, iter([{"image_hr": rows(spec["sr_hr"], rank, world),
                                         "image_lr": rows(spec["sr_lr"], rank, world)}]), 1)
    return dict(losses=[float(log["train_loss"]) for log in logs],
                lrs=[log["lr"] for log in logs], final=state.model.state_dict(), val=val)


def _trainer(spec, **kw):
    cfg = tiny_cfg(sample_posterior=True)
    model = EOFluxVAE(cfg, spec["variables"], device="cpu")
    return stage2.Stage2Trainer(model=model, loss_obj=EOConsistencyLoss(rec_loss_type="char"),
                                cfg=cfg, seed=0, **kw)


def _state(trainer) -> dict:
    return {"model": trainer.core.state_dict(), "optimizer": trainer.optimizer.state_dict()}


@scenario
def fit(spec, rank, world):
    """A 4-step ``Stage2Trainer.fit`` validating after steps 2 and 4 into
    ``spec["dir"]`` (its CSV, image grids and checkpoints), then a fresh
    trainer's resume from its last checkpoint."""
    out = pathlib.Path(spec["dir"])
    batches = [rows(b, rank, world) for b in spec["fit_batches"]]
    vals = [rows(b, rank, world) for b in spec["val_batches"]]
    kw = dict(max_steps=4, ckpt_dir=str(out / "ckpt"), val_every=2, val_max_batches=1,
              log_every=1)
    loggers = (dict(logger=CSVLogger(str(out)), image_logger=ImageLogger(str(out)))
               if rank == 0 else {})  # rank 0's alone, as the CLI gives them
    first = _trainer(spec, **loggers, norm_scheme="custom", **kw)
    with SaveCounter() as saves:
        state = first.fit(iter(batches), lambda: iter(vals))
    second = _trainer(spec, **kw)
    resumed = second.restore_checkpoint()
    a, b = _state(first), _state(second)
    equal = (all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
             and all(torch.equal(x, y) for key in ("mu", "nu")
                     for x, y in zip(a["optimizer"][key], b["optimizer"][key], strict=True))
             and a["optimizer"]["count"] == b["optimizer"]["count"])
    return dict(step=state.step, resumed_step=resumed.step, equal=equal, saves=saves.calls,
                final=a["model"])


@scenario
def device_prep(spec, rank, world):
    """Two steps on ``device_prep`` batches whose raw image is int16 on rank 0
    and fp32 on the others (and int16 in one process)."""
    trainer = _trainer(spec, max_steps=2, log_every=0)
    batches = []
    for b in spec["prep_batches"]:
        b = rows(b, rank, world)
        if rank > 0:
            b = {**b, "image": b["image"].astype(np.float32)}
        batches.append(b)
    placed_dtypes = []
    prepare = stage2.device_prepare

    def spy(raw, *args):
        placed_dtypes.append(str(raw.dtype))
        return prepare(raw, *args)

    stage2.device_prepare = spy
    try:
        state = trainer.fit(iter(batches))
    finally:
        stage2.device_prepare = prepare
    return dict(step=state.step, final=trainer.core.state_dict(), dtypes=placed_dtypes)


@scenario
def sigterm(spec, rank, world):
    """A 14-step fit whose rank 1 alone receives SIGTERM while its fourth batch
    is drawn; every rank must stop at step 10 (the guard's sync_every) and the
    tail save write one checkpoint."""
    out = pathlib.Path(spec["dir"]) / "sigterm"
    batches = [rows(b, rank, world) for b in spec["sigterm_batches"]]

    def signalled():
        for i, batch in enumerate(batches):
            if rank == 1 and i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    preemption.reset_for_tests()
    try:
        trainer = _trainer(spec, max_steps=len(batches), ckpt_dir=str(out), log_every=0)
        with SaveCounter() as saves:
            state = trainer.fit(signalled())
    finally:
        preemption.reset_for_tests()
    barrier()  # rank 0's write is complete
    return dict(step=state.step, steps_saved=checkpoint.TrainCheckpointer(str(out)).all_steps(),
                saves=saves.calls)


def run(spec: dict, rank: int, world: int) -> dict:
    """Every scenario of ``spec`` on rank ``rank`` of ``world`` (world 1: one
    process on the whole batch, no group)."""
    return {name: SCENARIOS[name](spec, rank, world) for name in spec["scenarios"]}


def start(spec: dict | None, tmp: pathlib.Path, world: int = 2, argv: list[str] | None = None):
    """Start ``world`` ranks: this module on ``spec`` or, with ``argv``,
    ``python argv`` with WORLD_SIZE, RANK and LOCAL_RANK set. :func:`finish`
    waits for them."""
    spec_path = tmp / "spec.pt"
    if argv is None:
        spec = {**spec, "world": world, "store": str(tmp / "store"), "out": str(tmp / "out")}
        torch.save(spec, spec_path)
    procs = []
    for rank in range(world):
        cmd = ([sys.executable, __file__, str(spec_path), str(rank)] if argv is None
               else [sys.executable, *argv])
        penv = {**os.environ, "WORLD_SIZE": str(world), "RANK": str(rank),
                "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=penv, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, (tmp / "out") if argv is None else None


def finish(procs: list, out: pathlib.Path | None) -> list:
    """Wait for the ranks, each killed after TIMEOUT_S; raises with a rank's
    output if one failed. Returns each rank's result or, for a command of
    ``argv`` (``out`` None), each rank's output."""
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        if proc.returncode != 0:
            raise AssertionError(f"rank {rank} exited with {proc.returncode}:\n{text[-6000:]}")
    if out is None:
        return outputs
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def spawn(spec: dict | None, tmp: pathlib.Path, world: int = 2, **kw) -> list:
    """:func:`start`, then :func:`finish`."""
    return finish(*start(spec, tmp, world, **kw))


def main(spec_path: str, rank: int) -> None:
    from eovax_torch.parallel.mesh import destroy_distributed, init_distributed

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    world = spec["world"]
    created = init_distributed("cpu", init_method=f"file://{spec['store']}", world_size=world,
                               rank=rank)
    try:
        result = run(spec, rank, world)
    finally:
        destroy_distributed(created)
    os.makedirs(spec["out"], exist_ok=True)
    torch.save(result, os.path.join(spec["out"], f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
