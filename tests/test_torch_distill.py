"""The port's stage-1 weight distillation against the JAX package's, in fp32 on the CPU.

The tiny config of ``tests/test_distill.py`` (ch 32, ch_mult (1, 2), z 8,
wavelength stems with one layer and 64 planes, 3 bands in and out) holds the
JAX model's variables, loaded into the port through
``state_dict_from_variables`` with ``strict=True``; the teacher's stems are
numpy draws. Held against ``eovax``: ``distillation_loss`` and its logs, 20
steps of ``run_distillation`` (logs and the stems), early stopping on a
plateau, ``load_teacher_stems`` and its missing-key error, and
``compare_weight_distill``'s numbers. Held by the port's own rules: the frozen
body keeps its bits, the distilled checkpoint's round trip, the three CLIs
with ``--device cpu``.

JAX is imported inside the tests that need it, so that the ``gpu`` case runs
on a machine without JAX:

    python -m pytest tests/test_torch_distill.py -m gpu --noconftest
"""

import json
import sys

import numpy as np
import pytest
import torch
import yaml

from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.train import distill
from eovax_torch.utils.convert import state_dict_from_variables

# Losses, logs and the stems after 20 AdamW steps: fp32 through the small
# transformer and its gradients in other summation orders
# (tests/test_torch_train.py's TOL).
TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 20
_STEM_KEYS = ("encoder.conv_in.", "decoder.conv_out.")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(m):
    stem = m.StemConfig(num_layers=1, wv_planes=64)
    kw = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              use_dynamic_ops=True, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(in_channels=3, **kw),
                       decoder=m.DecoderConfig(out_ch=3, **kw))


def _teacher() -> dict[str, np.ndarray]:
    g = np.random.default_rng(0)
    return {
        "encoder_weight": g.normal(0, 0.1, (32, 3, 3, 3)).astype(np.float32),
        "encoder_bias": g.normal(0, 0.05, (32,)).astype(np.float32),
        "decoder_weight": g.normal(0, 0.1, (3, 32, 3, 3)).astype(np.float32),
        "decoder_bias": g.normal(0, 0.05, (3,)).astype(np.float32),
    }


def _torch_teacher() -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in _teacher().items()}


@pytest.fixture(scope="module")
def jax_model():
    from eovax.core import config as jcfg
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE

    return JaxVAE(_cfg(jcfg), seed=0)


def _port_model(jax_model) -> EOFluxVAE:
    return EOFluxVAE(_cfg(tcfg), state_dict_from_variables(jax_model.variables), device="cpu")


def test_distillation_loss_and_logs_match_jax(jax_model):
    from eovax.train import distill as jdistill

    cfg = distill.DistillConfig()
    ref_loss, ref_logs = jdistill.distillation_loss(jax_model.core, jax_model.variables["params"],
                                                    _teacher(), jdistill.DistillConfig())
    with torch.no_grad():
        loss, logs = distill.distillation_loss(_port_model(jax_model).core, _torch_teacher(), cfg)
    assert list(logs) == list(ref_logs)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for key, ref in ref_logs.items():
        np.testing.assert_allclose(float(logs[key]), float(ref), rtol=1e-5, err_msg=key)


def _run_both(jax_model, **cfg_kw):
    """(JAX logs by step, JAX params, port logs by step, the port's model and its
    state before the run) for one DistillConfig."""
    from eovax.train import distill as jdistill

    jlogs, tlogs = [], []
    new_vars, jfinal = jdistill.run_distillation(
        jax_model.core, jax_model.variables, _teacher(), jdistill.DistillConfig(**cfg_kw),
        log_fn=lambda step, scalars: jlogs.append((step, scalars)))
    model = _port_model(jax_model)
    start = {k: v.clone() for k, v in model.core.state_dict().items()}
    final = distill.run_distillation(model.core, _torch_teacher(), distill.DistillConfig(**cfg_kw),
                                     log_fn=lambda step, scalars: tlogs.append((step, scalars)))
    return jlogs, jfinal, new_vars, tlogs, final, model, start


@pytest.fixture(scope="module")
def twenty_steps(jax_model):
    return _run_both(jax_model, max_steps=STEPS, lr=3e-3, val_every_n_steps=5,
                     log_every_n_steps=1, patience=100)


def test_twenty_steps_logs_match_jax(twenty_steps):
    jlogs, jfinal, _, tlogs, final, _, _ = twenty_steps
    assert [s for s, _ in tlogs] == [s for s, _ in jlogs] == list(range(1, STEPS + 1))
    for (_, j), (_, t) in zip(jlogs, tlogs):
        assert list(t) == list(j)
        for key in j:
            np.testing.assert_allclose(t[key], j[key], **TOL, err_msg=key)
    assert final == tlogs[-1][1] and list(final) == list(jfinal)
    assert final["total_loss"] < 0.5 * tlogs[0][1]["total_loss"]


def test_twenty_steps_stems_match_jax_and_the_body_keeps_its_bits(jax_model, twenty_steps):
    """The generators' parameters by tests/test_torch_train.py's Adam rule: where
    the true gradient is 0 (a dead ReLU unit's weights, the attention's key bias)
    each side moves by ±lr a step with the sign of its round-off, so every entry
    within 2·Σ lr, all but a thousandth within a hundredth of Σ lr. The stems
    they generate at the RGB wavelengths at TOL relative to each stem's largest
    entry (those moved parameters shift single entries by ~1e-5). The body keeps
    its bits."""
    from eovax_torch.train.schedule import cosine_decay_schedule

    _, _, new_vars, _, _, model, start = twenty_steps
    wvs = np.asarray(distill.DistillConfig().rgb_wavelengths, np.float32)
    jax_stems = {"encoder.conv_in": lambda c, w: c.encoder.conv_in.get_distillation_weight(w),
                 "decoder.conv_out": lambda c, w: c.decoder.conv_out.get_distillation_weight(w)}
    with torch.no_grad():
        for name, method in jax_stems.items():
            ref = jax_model.core.apply(new_vars, wvs, method=method)
            got = model.core.get_submodule(name).get_distillation_weight(torch.from_numpy(wvs))
            for a, r in zip(got, ref):
                r = torch.from_numpy(np.asarray(r))
                tol = TOL["rtol"] * r.abs().max().item() + TOL["atol"]
                assert (a - r).abs().max().item() <= tol, name
    ref = state_dict_from_variables(new_vars)
    lr_sum = sum(cosine_decay_schedule(3e-3, STEPS, alpha=0.01)(i) for i in range(STEPS))
    far = total = moved = 0
    for key, value in model.core.state_dict().items():
        if key.startswith(_STEM_KEYS):
            diff = (value - ref[key].reshape(value.shape)).abs()
            assert diff.max().item() <= 2 * lr_sum, key
            far += int((diff > 1e-2 * lr_sum).sum())
            total += diff.numel()
            moved += int(not torch.equal(value, start[key]))
        else:
            assert torch.equal(value, start[key]), key
    assert far <= 1e-3 * total, (far, total)
    assert moved > 0


def test_early_stopping_at_the_jax_step(jax_model):
    """min_delta 1 is a plateau for any loss here: the first check (step 2) sets
    the best, three more without a fall of 1 stop the run at step 8."""
    jlogs, _, _, tlogs, _, _, _ = _run_both(jax_model, max_steps=50, lr=1e-3,
                                            val_every_n_steps=2, log_every_n_steps=1,
                                            patience=3, min_delta=1.0)
    assert len(tlogs) == len(jlogs) == 8


def test_adamw_decay_and_the_cosine_decay_schedule():
    """The distillation optimizer: a step from a zero gradient moves a parameter
    by −lr·wd·p only, at the schedule's rate for the update count before the
    step; the schedule is optax's, flat past decay_steps."""
    from eovax.train.distill import optax
    from eovax_torch.train.distill import DistillConfig, make_distill_optimizer
    from eovax_torch.train.schedule import cosine_decay_schedule

    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt, scheduler = make_distill_optimizer([p], DistillConfig(lr=0.5, max_steps=10,
                                                               weight_decay=0.1))
    opt.step()
    scheduler.step()
    torch.testing.assert_close(p.detach(), torch.tensor([1.0 - 0.05, -2.0 + 0.1]))
    lr1 = float(optax.cosine_decay_schedule(0.5, 10, alpha=0.01)(1))
    before = p.detach().clone()
    opt.step()
    torch.testing.assert_close(p.detach(), before * (1.0 - lr1 * 0.1))
    ours, ref = cosine_decay_schedule(1e-3, 10, alpha=0.01), optax.cosine_decay_schedule(
        1e-3, 10, alpha=0.01)
    for step in (0, 1, 5, 9, 10, 20):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


def test_load_teacher_stems_and_the_missing_key_error(tmp_path):
    from eovax.train.distill import load_teacher_stems as jax_load

    teacher = _teacher()
    sd = {"encoder.conv_in.weight": teacher["encoder_weight"],
          "encoder.conv_in.bias": teacher["encoder_bias"],
          "decoder.conv_out.weight": teacher["decoder_weight"],
          "decoder.conv_out.bias": teacher["decoder_bias"],
          "encoder.down.0.block.0.conv1.weight": np.zeros((2, 2, 3, 3), np.float32)}
    flat, wrapped = tmp_path / "ae.pt", tmp_path / "ae.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, flat)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, wrapped)
    for path in (flat, wrapped):
        got, ref = distill.load_teacher_stems(str(path)), jax_load(str(path))
        assert sorted(got) == sorted(ref) == sorted(teacher)
        for key in ref:
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(got[key].numpy(), ref[key])
    partial = tmp_path / "partial.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items() if "decoder" not in k}, partial)
    with pytest.raises(KeyError) as got_err:
        distill.load_teacher_stems(str(partial))
    with pytest.raises(KeyError) as ref_err:
        jax_load(str(partial))
    assert str(got_err.value) == str(ref_err.value)


def test_safetensors_teacher_without_the_package_raises_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors package"):
        distill.load_teacher_stems("ae.safetensors")


def test_distilled_checkpoint_round_trip(tmp_path, twenty_steps):
    *_, model, _ = twenty_steps
    path = str(tmp_path / "out" / "distilled.pt")
    cfg = distill.DistillConfig(max_steps=STEPS)
    distill.save_distilled_checkpoint(path, model.core, cfg, final_loss=0.25)
    for load in ("load_distilled_checkpoint", "load_checkpoint"):
        fresh = EOFluxVAE(_cfg(tcfg), device="cpu", seed=9)
        if load == "load_distilled_checkpoint":
            meta = distill.load_distilled_checkpoint(path, fresh.core)
            assert meta["final_loss"] == 0.25 and meta["distill_config"]["max_steps"] == STEPS
        else:
            fresh.load_checkpoint(path)  # the reference's distilled .pt format
        for key, value in model.core.state_dict().items():
            if key.startswith(_STEM_KEYS):
                assert torch.equal(fresh.core.state_dict()[key], value), key


def test_compare_matches_jax(jax_model):
    from eovax.cli.compare_weight_distill import compare as jax_compare
    from eovax_torch.cli.compare_weight_distill import compare

    wvs = [0.665, 0.560, 0.490]
    ref = jax_compare(jax_model, _teacher(), wvs)
    got = compare(_port_model(jax_model), _teacher(), wvs)
    assert {k: list(v) for k, v in got.items()} == {k: list(v) for k, v in ref.items()}
    for part in ref:
        for key, value in ref[part].items():
            np.testing.assert_allclose(got[part][key], value, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{part} {key}")


def _model_yaml(tmp_path):
    part = {"z_channels": 8, "resolution": 32, "ch": 32, "ch_mult": [1, 2],
            "num_res_blocks": 1, "use_dynamic_ops": True,
            "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
    path = tmp_path / "model_config.yaml"
    path.write_text(yaml.safe_dump({"model": {"encoder": {**part, "in_channels": 3},
                                              "decoder": {**part, "out_ch": 3}}}))
    return str(path)


def test_the_three_clis_on_cpu(tmp_path, capsys):
    from eovax_torch.cli import compare_weight_distill, hypernet_init, weight_distill

    config = _model_yaml(tmp_path)
    teacher = tmp_path / "ae.pt"
    names = {"encoder_weight": "encoder.conv_in.weight", "encoder_bias": "encoder.conv_in.bias",
             "decoder_weight": "decoder.conv_out.weight", "decoder_bias": "decoder.conv_out.bias"}
    torch.save({names[k]: v for k, v in _torch_teacher().items()}, teacher)
    out = tmp_path / "distilled.pt"
    weight_distill.main(["--config", config, "--teacher", str(teacher), "--output", str(out),
                         "--max-steps", "3", "--lr", "1e-3", "--device", "cpu"])
    payload = torch.load(out, weights_only=True)
    assert payload["distill_config"]["max_steps"] == 3 and np.isfinite(payload["final_loss"])
    init = tmp_path / "hypernet_init.pt"
    hypernet_init.main(["--config", config, "--output", str(init), "--steps", "3",
                        "--device", "cpu"])
    assert torch.load(init, weights_only=True)["distill_config"]["lr"] == 1e-3
    capsys.readouterr()
    compare_weight_distill.main(["--config", config, "--distilled", str(out),
                                 "--teacher", str(teacher), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    model = EOFluxVAE(tcfg.load_model_config(config), device="cpu")
    distill.load_distilled_checkpoint(str(out), model.core)
    from eovax_torch.cli.compare_weight_distill import compare

    assert printed == json.loads(json.dumps(compare(model, _teacher(), [0.665, 0.560, 0.490])))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from eovax_torch.cli import weight_distill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weight_distill.main(["--config", _model_yaml(tmp_path), "--teacher", "ae.pt"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_distillation_on_card_matches_cpu():
    """10 steps on the card (fp32, TF32 off) against the CPU from the same
    weights: losses and the generated stems within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = distill.DistillConfig(max_steps=10, lr=3e-3, log_every_n_steps=1)
    runs = []
    for device in ("cpu", "cuda"):
        model = EOFluxVAE(_cfg(tcfg), device=device, seed=5)
        logs = []
        distill.run_distillation(model.core, _torch_teacher(), cfg,
                                 log_fn=lambda step, scalars: logs.append(scalars["total_loss"]))
        wvs = torch.tensor(cfg.rgb_wavelengths, device=device)
        with torch.no_grad():
            stems = [t.cpu() for t in model.core.encoder.conv_in.get_distillation_weight(wvs)]
        runs.append((logs, stems))
    (cpu_logs, cpu_stems), (card_logs, card_stems) = runs
    np.testing.assert_allclose(card_logs, cpu_logs, rtol=1e-4)
    for got, ref in zip(card_stems, cpu_stems):
        assert (got - ref).norm() <= 1e-4 * ref.norm()
