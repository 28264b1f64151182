"""The port's pipeline benchmark CLI (``eovax_torch.cli.benchmark``) against the
JAX package's ``eovax.cli.benchmark`` on the CPU.

The default mode at the tiny config of the JAX CLI's own test (ch 32, ch_mult
(1, 2), 32²): its JSON keys, read from the JAX ``main``'s literals, and its
``architecture`` and ``parameters``, against the JAX models' shapes from
``jax.eval_shape`` of their init (no JAX timing runs). ``--all`` with its
module constants shrunk to a 128-channel model at 16² (at fewer channels int8
quantizes nothing): its key set against the JAX ``_bench_all``'s literal keys,
finite positive numbers. ``--int8-quality``: its synthetic fields against the
JAX expression, its rows against the JAX ``_int8_quality_table`` on the same
converted weights and a test-written ``.npz``, and one ``JSON_RESULT:`` line.
Everything runs at one torch thread with ``--device cpu``.
"""

import ast
import inspect
import json
import math

import numpy as np
import pytest
import torch
import yaml

from eovax_torch.cli import benchmark

TINY = {"model": {
    part: {"z_channels": 8, "resolution": 32, channels: 4, "ch": 32, "ch_mult": [1, 2],
           "num_res_blocks": 1, "use_dynamic_ops": True,
           "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
    for part, channels in (("encoder", "in_channels"), ("decoder", "out_ch"))}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "model_config.yaml"
    path.write_text(yaml.safe_dump(TINY))
    return path


def _markers(out: str) -> list[dict]:
    return [json.loads(line[len("JSON_RESULT:"):]) for line in out.splitlines()
            if line.startswith("JSON_RESULT:")]


# ---------------------------------------------------------------------------
# The JAX CLI's JSON keys, read from its source
# ---------------------------------------------------------------------------


def _function(name: str) -> ast.FunctionDef:
    from eovax.cli import benchmark as jax_benchmark

    tree = ast.parse(inspect.getsource(jax_benchmark))
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node) -> dict:
    """The key tree of a dict literal: {key: subtree or None}."""
    return {k.value: _dict_keys(v) if isinstance(v, ast.Dict) else None
            for k, v in zip(node.keys, node.values)}


def _key_names(slice_, tags: list[str]) -> list[str]:
    """A subscript key: a constant, or an f-string over a loop's tag."""
    if isinstance(slice_, ast.Constant):
        return [slice_.value]
    prefix = "".join(p.value for p in slice_.values if isinstance(p, ast.Constant))
    return [prefix + t for t in tags]


def _loop_tags(loop: ast.For) -> list[str]:
    """The first element of each tuple a ``for tag, ... in ((...), ...)`` loop runs over."""
    return [e.elts[0].value for e in loop.iter.elts]


def _jax_all_keys() -> dict:
    """``_bench_all``'s ledger keys, each with its row's keys (where the row is a
    literal or a name built by literals and subscripted assignments)."""
    fn = _function("_bench_all")
    names: dict[str, dict] = {}  # local dicts built by name
    ledger: dict = {}

    def visit(body, tags):
        for node in body:
            if isinstance(node, ast.For):
                visit(node.body, _loop_tags(node) if isinstance(node.iter, ast.Tuple) else tags)
                continue
            if isinstance(node, (ast.Try, ast.With)):
                visit(node.body, tags)
                continue
            if isinstance(node, ast.AnnAssign) and isinstance(node.value, ast.Dict):
                names[node.target.id] = _dict_keys(node.value)
                continue
            if not isinstance(node, ast.Assign):
                continue
            target = node.targets[0]
            if not (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)):
                continue
            value = node.value
            row = (_dict_keys(value) if isinstance(value, ast.Dict)
                   else names.get(value.id) if isinstance(value, ast.Name) else None)
            for key in _key_names(target.slice, tags):
                if target.value.id == "ledger":
                    ledger[key] = row
                elif target.value.id in names:
                    names[target.value.id][key] = None

    visit(fn.body, [])
    return {**names.pop("ledger"), **ledger}


def _jax_main_keys() -> dict:
    fn = _function("main")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "result")
    return _dict_keys(node.value)


def _key_tree(d: dict, depth: int) -> dict:
    return {k: _key_tree(v, depth - 1) if isinstance(v, dict) and depth > 1 else None
            for k, v in d.items()}


def _numbers(d) -> list[float]:
    if isinstance(d, dict):
        return [x for v in d.values() for x in _numbers(v)]
    return [d] if isinstance(d, (int, float)) and not isinstance(d, bool) else []


# ---------------------------------------------------------------------------
# The default mode
# ---------------------------------------------------------------------------


def _jax_shapes_and_counts(config_path) -> tuple[list, dict]:
    """The JAX CLI's ``architecture["output_shape"]`` and ``parameters`` for
    this config at batch 1, LR 32², from ``jax.eval_shape`` of the models' init
    and of the decode."""
    import jax
    import jax.numpy as jnp

    from eovax.core.config import load_model_config
    from eovax.data.sen2naip import SEN2NAIP_WVS
    from eovax.models.backbone import EOVAECore
    from eovax.models.unet import UNet

    cfg = load_model_config(str(config_path))
    core = EOVAECore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    x = jnp.zeros((1, 32, 32, 4))
    wvs = jnp.asarray(SEN2NAIP_WVS)
    variables = jax.eval_shape(lambda: core.init(
        jax.random.PRNGKey(0), x, wvs, sample_posterior=False, method=EOVAECore.forward))
    z = jax.eval_shape(lambda v: core.apply(v, x, wvs, method=EOVAECore.encode_spatial_normalized),
                       variables)
    out = jax.eval_shape(lambda v, zz: core.apply(
        v, zz, wvs, method=EOVAECore.decode_spatial_normalized), variables, z)
    zc = cfg.encoder.z_channels
    unet = UNet(in_channels=zc, out_channels=zc, cond_channels=zc, hid_channels=(256, 128, 64),
                hid_blocks=(3, 3, 3))
    x0 = jnp.zeros((1, 32 // 8, 32 // 8, zc))
    sr = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,)), x0))

    def count(tree):
        return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(tree))

    params = {"sr_model": count(sr["params"]), "encoder": count(variables["params"]["encoder"]),
              "decoder": count(variables["params"]["decoder"])}
    params["total"] = sum(params.values())
    b, h, w, c = out.shape
    return [b, c, h, w], params


def test_default_mode_json_matches_jax(tiny_yaml, tmp_path, capsys):
    """The JAX CLI's test settings (``--iters 2 --sr-steps 2``): the JSON keys of
    the JAX ``main``, its ``architecture`` and ``parameters``, positive finite
    times, no peak memory on the CPU, one ``JSON_RESULT:`` line equal to the file."""
    out_json = tmp_path / "bench.json"
    benchmark.main(["--config", str(tiny_yaml), "--resolution", "32", "--iters", "2",
                    "--sr-steps", "2", "--batch", "1", "--output", str(out_json),
                    "--device", "cpu"])
    result = json.loads(out_json.read_text())
    assert _markers(capsys.readouterr().out) == [result]
    assert _key_tree(result, 2) == _jax_main_keys()
    output_shape, params = _jax_shapes_and_counts(tiny_yaml)
    assert result["architecture"] == {"input_shape": [1, 4, 32, 32], "output_shape": output_shape,
                                      "latent_channels": 8, "compression_ratio": "64:1"}
    assert result["parameters"] == params
    assert result["model_type"] == "eo-vae" and result["memory_gb"] == {"peak_memory": None}
    timing = result["timing_ms"]
    assert all(math.isfinite(v) and v > 0 for v in timing.values())
    assert result["throughput_imgs_per_sec"] > 0


def test_default_mode_takes_the_card_unless_told_otherwise(tiny_yaml):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--config", str(tiny_yaml), "--resolution", "32", "--iters", "1",
                        "--sr-steps", "1"])


# ---------------------------------------------------------------------------
# --all
# ---------------------------------------------------------------------------


def test_all_gives_the_jax_ledger_keys(monkeypatch, tiny_yaml, tmp_path, capsys):
    """Every section at a 128-channel model (ch_mult (1, 2), one res block, z 8,
    one-layer stems) at B = 1, 16², slopes of 1 and 2 calls; the train loss
    without MS-SSIM (its five scales need more than 64 pixels: the loss has its
    own tests); the SR sub-runs on the tiny config at LR 16², 1 step; one bulk
    batch a run."""
    for name, value in dict(
            ALL_BATCH=1, ALL_RESOLUTION=16, ALL_LO=1, ALL_HI=2, TRAIN_LO=1, TRAIN_HI=2,
            ALL_STEM={"num_layers": 1, "wv_planes": 64},
            ALL_WIDTHS={"ch": 128, "ch_mult": (1, 2), "num_res_blocks": 1, "z_channels": 8},
            TRAIN_LOSS={**benchmark.TRAIN_LOSS, "msssim_weight": 0.0},
            SR_RUNS=tuple((tag, sampler, 1) for tag, sampler, _ in benchmark.SR_RUNS),
            SR_ARGV=["--batch", "1", "--resolution", "16", "--iters", "1",
                     "--config", str(tiny_yaml)],
            BULK_RESOLUTION=16,
            BULK_RUNS=tuple((tag, compress, 1) for tag, compress, _ in benchmark.BULK_RUNS),
    ).items():
        monkeypatch.setattr(benchmark, name, value)
    out_json = tmp_path / "all.json"
    benchmark.main(["--all", "--output", str(out_json), "--device", "cpu"])
    ledger = json.loads(out_json.read_text())
    assert _markers(capsys.readouterr().out) == [ledger]
    assert _key_tree(ledger, 2) == _jax_all_keys()
    assert set(ledger["sr_pipeline_512_ddim50"]["timing_ms"]) == set(
        _jax_main_keys()["timing_ms"])
    assert ledger["mode"] == "all" and isinstance(ledger["methodology"], str)
    numbers = _numbers({k: v for k, v in ledger.items() if isinstance(v, dict)})
    assert numbers and all(math.isfinite(v) and v > 0 for v in numbers)


# ---------------------------------------------------------------------------
# --int8-quality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("modality,channels", [("S2RGB", 3), ("S1RTC", 2), ("S2L2A", 12),
                                               ("S2L1C", 13)])
def test_synthetic_fields_match_jax(modality, channels):
    """crc32-seeded noise at res/8, upsampled as ``jax.image.resize(..., "linear")``."""
    import zlib

    import jax
    import jax.numpy as jnp

    g = np.random.default_rng(zlib.crc32(modality.encode()))
    lo = g.standard_normal((2, 96 // 8, 96 // 8, channels))
    ref = jnp.transpose(jax.image.resize(jnp.asarray(lo, jnp.float32), (2, 96, 96, channels),
                                         "linear"), (0, 3, 1, 2))
    out = benchmark.synthetic_field(modality, 2, 96, channels)
    assert out.shape == (2, channels, 96, 96) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-6)


# Rows of the two packages on the same weights and image. Their bf16 models
# already differ where they round to bf16 (the port's GroupNorm kernel rounds
# once after norm, AdaIN and swish), and an int8 conv turns a bf16 ulp into an
# int8 step for about one value in two (tests/test_torch_serving_int8.py holds
# the reconstructions to rms 0.15 of the output's spread). Measured here, PSNR
# near 11.9 dB: bf16 1.2e-3 dB apart, int8 7.2e-3, their delta 6.0e-3 (on the
# two-level 128-channel VAE of tests/test_torch_qconv.py: 6e-4, 1.26e-2,
# 1.31e-2); held to 5e-2 dB. On random weights the reconstructions do not
# follow the image, every scale's contrast term is negative and MS-SSIM is 0
# after its ReLU in both packages (measured equal); held to 5e-3.
TOL_PSNR_DB = 5e-2
TOL_MSSSIM = 5e-3


# The quality test's VAE: 128 channels (int8 quantizes its 14 body convs), one
# level (no downsampling: the fewest layers for JAX to compile at 80²).
QUALITY_MODEL = {"model": {
    part: {"z_channels": 8, "resolution": 32, channels: 3, "ch": 128, "ch_mult": [1],
           "num_res_blocks": 1, "use_dynamic_ops": True,
           "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
    for part, channels in (("encoder", "in_channels"), ("decoder", "out_ch"))}}


def test_int8_quality_matches_jax(tmp_path, capsys):
    """``QUALITY_MODEL`` (every JAX variable from a numpy seed, converted for the
    port), S2RGB from a test-written ``.npz`` at 80² (MS-SSIM's five scales need
    more than 64 pixels): the port's rows against the JAX
    ``_int8_quality_table``'s, one ``JSON_RESULT:`` line, the JSON keys. The
    synthetic fields are held to JAX's above."""
    import argparse

    import jax
    import jax.numpy as jnp
    import test_torch_serving as ts

    from eovax.cli.benchmark import _int8_quality_table
    from eovax.core.config import load_model_config
    from eovax.models.backbone import EOVAECore as JaxCore
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
    from eovax_torch.utils.convert import state_dict_from_variables

    (tmp_path / "model_config.yaml").write_text(yaml.safe_dump(QUALITY_MODEL))
    cfg = load_model_config(str(tmp_path / "model_config.yaml"))
    core = JaxCore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    variables = ts._fill(jax.eval_shape(lambda: core.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.asarray(ts.WVS),
        sample_posterior=False, method=JaxCore.forward)), seed=4)
    torch.save({"state_dict": state_dict_from_variables(variables)}, tmp_path / "eo-vae.ckpt")
    image = np.random.default_rng(5).standard_normal((1, 3, 80, 80)).astype(np.float32)
    np.savez(tmp_path / "q.npz", S2RGB=image)
    common = ["--quality-npz", str(tmp_path / "q.npz"), "--modalities", "S2RGB",
              "--resolution", "80", "--ckpt", str(tmp_path / "eo-vae.ckpt")]

    benchmark.main(["--int8-quality", "--config", str(tmp_path / "model_config.yaml"),
                    "--output", str(tmp_path / "port.json"), "--device", "cpu", *common])
    port = json.loads((tmp_path / "port.json").read_text())
    assert _markers(capsys.readouterr().out) == [port]

    args = argparse.Namespace(quality_npz=str(tmp_path / "q.npz"), modalities=["S2RGB"],
                              resolution=80, batch=1, ckpt="eo-vae.ckpt",
                              output=str(tmp_path / "jax.json"))
    _int8_quality_table(JaxVAE(cfg, variables), args)
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert _key_tree(port, 3) == _key_tree(ref, 3)
    assert {k: port[k] for k in ("mode", "weights", "batch", "resolution")} == {
        k: ref[k] for k in ("mode", "weights", "batch", "resolution")}
    for modality, row in ref["modalities"].items():
        got = port["modalities"][modality]
        for key, want in row.items():
            tol = TOL_PSNR_DB if key.startswith("psnr") else TOL_MSSSIM
            assert abs(got[key] - want) <= tol, (modality, key, got[key], want)
