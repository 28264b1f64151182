"""The port's trainer and train CLI on 2 gloo ranks on the CPU.

Two processes of ``tests/_torch_dp_worker.py`` (a file store under the test's
directory, one torch thread each, every rank killed after 180 s) run
``Stage2Trainer`` on their halves of each global batch of the tiny VAE (ch 32,
ch_mult (1, 2), 32²), against the same fits in this process on the whole
batches:

- a 4-step fit validating after steps 2 and 4: rank 0's CSV rows against the
  one-process fit's; rank 0 alone writes (one step checkpoint, the best
  checkpoints, the image grids); a fresh trainer on each rank resumes
  ``torch.equal``;
- ``device_prep`` batches whose raw image is int16 on rank 0 and fp32 on rank
  1 train without a hang (both placed as fp32) and match one process on int16;
- SIGTERM to rank 1 alone: both ranks stop at step 10, the guard's
  ``sync_every``, and the tail save writes one checkpoint;
- ``python -m eovax_torch.cli.train --dist-url file://...`` under 2 ranks on
  synthetic batches.
"""

import csv
import pathlib

import numpy as np
import pytest
import torch
import yaml

import _torch_dp_worker as dpw
from eovax_torch import EOFluxVAE
from eovax_torch.data.collate import deterministic_modality_collate
from eovax_torch.data.synthetic import synthetic_terramesh_batches
from eovax_torch.utils.checkpoint import TrainCheckpointer

WORLD = 2
# The logged losses, gradient norms and validation means of 4 steps: 2 ranks
# against one process, the batch's sums taken in halves.
RTOL = 1e-5
# Parameters after Adam updates (tests/test_torch_parallel.py's rule): every
# entry within 2·Σlr, all but a thousandth of them within a hundredth of it.
LR_SUM = 2 * dpw.BASE_LR
PARAM_FAR_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prep_batches() -> list[dict]:
    """Two eval-mode ``device_prep`` batches of 4 int16 S2L2A tiles at 32²."""
    g = np.random.default_rng(5)
    collate = deterministic_modality_collate("S2L2A", mode="eval", target_size=None,
                                             device_prep=True, norm_scheme="custom")
    return [collate({"S2L2A": g.integers(0, 4000, (4, 32, 32, 12)).astype(np.int16)})
            for _ in range(2)]


def _spec(out: pathlib.Path) -> dict:
    def batches(n, seed, **kw):
        return list(synthetic_terramesh_batches(batch_size=4, target_size=(32, 32), seed=seed,
                                                num_batches=n, **kw))

    return {
        "variables": EOFluxVAE(dpw.tiny_cfg(), device="cpu", seed=0).core.state_dict(),
        "dir": str(out),
        "fit_batches": batches(4, 0),
        "val_batches": batches(1, 1, modalities=("S2L2A",), mode="S2L2A"),
        "prep_batches": _prep_batches(),
        "sigterm_batches": batches(14, 2),
        "scenarios": ["fit", "device_prep", "sigterm"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 2 ranks' results, one process's, the ranks' directory, the one
    process's); the ranks run while this process computes its own."""
    tmp = tmp_path_factory.mktemp("dpfit")
    spec = _spec(tmp / "ranks")
    spawned = dpw.start(spec, tmp, WORLD)
    one = dpw.run({**spec, "dir": str(tmp / "one"), "scenarios": ["fit", "device_prep"]}, 0, 1)
    return dpw.finish(*spawned), one, tmp / "ranks", tmp / "one"


def _csv_rows(path: pathlib.Path) -> list[dict]:
    with open(path / "metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def _assert_adam_close(got: dict, ref: dict) -> None:
    far = total = 0
    for name, value in ref.items():
        if not value.is_floating_point() or name.endswith(("running_mean", "running_var")):
            continue
        diff = (got[name] - value).abs()
        assert diff.max().item() <= 2 * LR_SUM, (name, diff.max().item())
        far += int((diff > 1e-2 * LR_SUM).sum())
        total += diff.numel()
    assert far <= PARAM_FAR_SHARE * total, (far, total)


def test_fit_logs_the_rows_of_one_process(runs):
    _, _, ranks_dir, one_dir = runs
    got, ref = _csv_rows(ranks_dir), _csv_rows(one_dir)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == ["1", "2", "2", "3", "4", "4"]
    for row, ref_row in zip(got, ref):
        assert sorted(k for k, v in row.items() if v) == sorted(k for k, v in ref_row.items() if v)
        for k, v in ref_row.items():
            if v and k not in ("step", "wall_time", "train/steps_per_sec"):
                np.testing.assert_allclose(float(row[k]), float(v), rtol=RTOL, err_msg=k)


def test_fit_writes_on_rank_zero_once_and_resumes_on_every_rank(runs):
    """One step checkpoint (the tail save), the best checkpoints and the image
    grids from rank 0 alone, as many writes as one process makes; every rank
    resumes at step 4 with the model and Adam's state ``torch.equal``."""
    ranks, one, ranks_dir, one_dir = runs
    assert [r["fit"]["step"] for r in ranks] == [4, 4]
    assert TrainCheckpointer(str(ranks_dir / "ckpt")).all_steps() == [4]
    assert ranks[0]["fit"]["saves"] == one["fit"]["saves"] >= 2 and ranks[1]["fit"]["saves"] == 0
    pngs = sorted(p.name for p in (ranks_dir / "image_log" / "val").glob("*.png"))
    assert pngs == sorted(p.name for p in (one_dir / "image_log" / "val").glob("*.png"))
    assert len(pngs) == 2
    for r in ranks:
        assert r["fit"]["resumed_step"] == 4 and r["fit"]["equal"]
    for name, value in ranks[0]["fit"]["final"].items():
        assert torch.equal(value, ranks[1]["fit"]["final"][name]), name
    _assert_adam_close(ranks[0]["fit"]["final"], one["fit"]["final"])


def test_device_prep_int16_and_fp32_ranks_match_one_process(runs):
    """The raw image placed as fp32 on both ranks (int16 in one process)."""
    ranks, one, _, _ = runs
    for r in ranks:
        assert r["device_prep"]["step"] == 2
        assert r["device_prep"]["dtypes"] == ["torch.float32"] * 2
    assert one["device_prep"]["dtypes"] == ["torch.int16"] * 2
    for name, value in ranks[0]["device_prep"]["final"].items():
        assert torch.equal(value, ranks[1]["device_prep"]["final"][name]), name
    _assert_adam_close(ranks[0]["device_prep"]["final"], one["device_prep"]["final"])


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_step(runs):
    ranks, _, _, _ = runs
    for r in ranks:
        assert r["sigterm"]["step"] == 10 and r["sigterm"]["steps_saved"] == [10]
    assert [r["sigterm"]["saves"] for r in ranks] == [1, 0]


def test_train_cli_on_two_ranks(tmp_path):
    """``eovax_torch.cli.train`` under 2 gloo ranks (``--dist-url`` a file store):
    one experiment directory, written by rank 0, with a train and a validation
    row a step, a checkpoint a step and the final model."""
    stem = {"num_layers": 1, "wv_planes": 32, "use_adain": True}
    part = {"z_channels": 8, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "use_dynamic_ops": True, "dynamic_conv_kwargs": stem}
    raw = {
        "experiment": {"experiment_name": "tiny", "exp_dir": str(tmp_path / "exps")},
        "wandb": {"mode": "disabled"},
        "model": {"base_lr": dpw.BASE_LR, "final_lr": 1e-5, "warmup_epochs": 0,
                  "decay_end_epoch": 1, "clip_grad": 1.0,
                  "loss_fn": {"_target_": "eo_vae.models.modules.consistency_loss."
                                          "EOConsistencyLoss", "rec_loss_type": "char"},
                  "encoder": {**part, "in_channels": 4}, "decoder": {**part, "out_ch": 4}},
        "datamodule": {"modalities": ["S2L2A", "S1RTC", "S2RGB"], "batch_size": 2,
                       "eval_batch_size": 2, "norm_scheme": "custom", "target_size": 32},
        "trainer": {"max_epochs": 1, "limit_train_batches": 1, "limit_val_batches": 1,
                    "log_every_n_steps": 1},
    }
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(raw))
    dpw.spawn(None, tmp_path, WORLD, argv=[
        "-m", "eovax_torch.cli.train", "--config", str(config), "--synthetic-data",
        "--device", "cpu", "--precision", "32-true", "--max-steps", "2",
        "--dist-url", f"file://{tmp_path / 'store'}"])
    (exp,) = (tmp_path / "exps").iterdir()
    for name in ("config.yaml", "metrics.csv", "eo-vae-final.pt", "eo-vae-best.pt"):
        assert (exp / name).exists(), name
    assert TrainCheckpointer(str(exp / "checkpoints")).all_steps() == [1, 2]
    rows = _csv_rows(exp)
    assert [r["step"] for r in rows] == ["1", "1", "2", "2"]
    losses = [float(r[k]) for r in rows for k in ("train/loss_total", "val/loss_total") if r[k]]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert len(list((exp / "image_log" / "val").glob("*.png"))) == 2
