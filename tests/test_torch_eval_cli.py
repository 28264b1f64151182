"""The port's eval CLIs on the CPU, as ``tests/test_eval_cli.py`` holds the JAX
package's (its benchmark cases stay with the benchmark): the tokenizer metrics
against ``eovax.cli.evaluate_metrics_tokenizer`` on the same weights, the
latent PCA, the table generators against the JAX package's output on
test-written JSON, and ``visual_eval`` writing its PNGs.

The tiny VAE (ch 32, ch_mult (1, 2), S2RGB) and its numpy-drawn weights are
``tests/test_torch_serving.py``'s. The CLIs' ``main`` runs with
``--device cpu``; without it they run on the card.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import test_torch_serving as ts

models = ts.models  # the module-scoped fixture, shared by name


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(models, tmp_path_factory):
    """The tiny model's config and a checkpoint of its weights."""
    root = tmp_path_factory.mktemp("eval")
    (root / "model_config.yaml").write_text(yaml.safe_dump(ts._YAML))
    torch.save({"state_dict": models[1].core.state_dict()}, root / "eo-vae.ckpt")
    return root


def _batches(n: int, size: int = 32):
    from eovax_torch.data.synthetic import synthetic_terramesh_batches

    return list(synthetic_terramesh_batches(batch_size=2, target_size=(size, size),
                                            modalities=("S2RGB",), mode="S2RGB", seed=0,
                                            num_batches=n))


def test_synthetic_batches_are_the_jax_packages():
    """The CLIs' ``--synthetic-data`` batches equal the JAX package's."""
    from eovax.data.synthetic import synthetic_terramesh_batches

    ref = list(synthetic_terramesh_batches(batch_size=2, target_size=(32, 32),
                                           modalities=("S2RGB",), mode="S2RGB", seed=0,
                                           num_batches=2))
    for got, want in zip(_batches(2), ref, strict=True):
        assert got.keys() == want.keys() and got["modality"] == want["modality"]
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["wvs"], want["wvs"])


def test_evaluate_tokenizer_matches_jax(models):
    """Per-modality MSE, MAE and PSNR of the same weights on the same batches,
    fp32 on both sides: within 1e-5 relative."""
    from eovax.cli.evaluate_metrics_tokenizer import evaluate_tokenizer as jax_evaluate
    from eovax_torch.cli.evaluate_metrics_tokenizer import evaluate_tokenizer

    jm, port, _ = models
    batches = _batches(2)
    got = evaluate_tokenizer(port, iter(batches), num_batches=2)
    ref = jax_evaluate(jm, iter(batches), num_batches=2)
    assert got.keys() == ref.keys() == {"S2RGB"}
    assert got["S2RGB"].keys() == ref["S2RGB"].keys() == {"mse", "mae", "psnr"}
    for k, v in ref["S2RGB"].items():
        assert np.isfinite(got["S2RGB"][k]) and got["S2RGB"][k] == pytest.approx(v, rel=1e-5), k
    # num_batches stops the stream: one batch is the first batch's numbers.
    one = evaluate_tokenizer(port, iter(batches), num_batches=1)
    assert one == evaluate_tokenizer(port, iter(batches[:1]), num_batches=5)


def test_latent_pca_rgb_is_the_jax_packages():
    from eovax.cli.visual_eval import latent_pca_rgb as jax_pca
    from eovax_torch.cli.visual_eval import latent_pca_rgb

    g = np.random.default_rng(0)
    latent = g.standard_normal((2, 8, 16, 16)).astype(np.float32)
    rgb = latent_pca_rgb(latent)
    assert rgb.shape == (2, 16, 16, 3)
    assert rgb.min() >= 0 and rgb.max() <= 1
    np.testing.assert_array_equal(rgb, jax_pca(latent))


def _write_results(root):
    for name, total in (("pixel", 100.0), ("eo-vae", 25.0), ("tiny", None)):
        timing = ({"encode": 5, "sr_forward": total - 10, "decode": 5, "total": total}
                  if total else {})
        (root / f"{name}.json").write_text(json.dumps({
            "name": name, "timing_ms": timing,
            "throughput_imgs_per_sec": 1000.0 / total if total else None,
            "memory_gb": {"peak_memory": 2.0} if total else None,
            "parameters": {"total": 100_000_000},
        }))
    (root / "sr.json").write_text(json.dumps(
        {"name": "eo-vae", "rmse": 0.05, "psnr": 26.1, "ssim": 0.8, "sam": 0.1}))
    combined = root / "combined"
    combined.mkdir()
    for mod, mse in (("S2L2A", 0.01), ("S1RTC", 0.02)):
        (combined / f"metrics_{mod}.json").write_text(json.dumps(
            {"eo-vae": {"mse": mse, "mae": 0.1}, "terramind": {"mse": 2 * mse, "mae": 0.2}}))


@pytest.mark.parametrize("argv", [
    ["*.json", "--baseline", "pixel"],
    ["*.json", "--format", "latex", "--baseline", "pixel"],
    ["sr.json", "--kind", "sr"],
    ["sr.json", "--kind", "sr", "--format", "latex"],
    ["combined", "--kind", "combined"],
], ids=["benchmark", "benchmark-latex", "sr", "sr-latex", "combined"])
def test_table_generators_print_the_jax_packages_tables(tmp_path, capsys, argv):
    """On the same test-written result files both packages print the same
    tables (and write the same ``combined_results.json``)."""
    from eovax.cli.generate_tables import main as jax_tables
    from eovax_torch.cli.generate_tables import main as tables

    _write_results(tmp_path)
    argv = [str(tmp_path / argv[0]), *argv[1:]]
    tables(argv)
    got = capsys.readouterr().out
    written = (tmp_path / "combined" / "combined_results.json")
    got_json = written.read_text() if written.exists() else None
    jax_tables(argv)
    assert got == capsys.readouterr().out
    assert got_json == (written.read_text() if written.exists() else None)
    if "--baseline" in argv:
        assert "speedup" in got and "4.0" in got  # 100 / 25
    if "sr" in argv:
        assert "26.1" in got
    with pytest.raises(SystemExit, match="No result files matched"):
        tables([str(tmp_path / "none*.json")])


def test_evaluate_metrics_cli_on_the_cpu(files, tmp_path, capsys):
    """``main --device cpu --synthetic-data``: the table and the JSON for each
    modality asked for, at the CLI's 256² synthetic batches."""
    from eovax_torch.cli.evaluate_metrics_tokenizer import main

    out = tmp_path / "metrics.json"
    main(["--config", str(files / "model_config.yaml"), "--ckpt", str(files / "eo-vae.ckpt"),
          "--modalities", "S2RGB", "--num-batches", "1", "--batch-size", "1",
          "--synthetic-data", "--output", str(out), "--device", "cpu"])
    table = capsys.readouterr().out
    result = json.loads(out.read_text())
    assert set(result) == {"S2RGB"} and all(np.isfinite(v) for v in result["S2RGB"].values())
    assert table.splitlines()[0].split() == ["modality", "MSE", "MAE", "PSNR"]
    assert table.splitlines()[1].startswith("S2RGB")


def test_visual_eval_writes_its_pngs(files, tmp_path, capsys):
    """``main --device cpu --synthetic-data``: a reconstruction grid through the
    port's ``ImageLogger`` and a latent-PCA strip for each modality."""
    from PIL import Image

    from eovax_torch.cli.visual_eval import main

    out = tmp_path / "viz"
    main(["--config", str(files / "model_config.yaml"), "--ckpt", str(files / "eo-vae.ckpt"),
          "--out-dir", str(out), "--modalities", "S2RGB", "--batch-size", "2",
          "--synthetic-data", "--device", "cpu"])
    printed = capsys.readouterr().out
    grid = printed.split("reconstruction grid: ")[1].split("\n")[0]
    assert grid.startswith(str(out / "image_log" / "visual_eval"))
    with Image.open(grid) as im:
        assert im.mode == "RGB" and im.size[0] > 0
    with Image.open(out / "latent_pca_S2RGB.png") as im:
        assert im.size == (2 * 128, 128)  # two 128² latents (one downsample) side by side
