"""The port's int8 (W8A8) serving on the CPU: ``EOFluxVAE`` under ``INT8_POLICY``
against the JAX package's, the export CLI's ``--precision int8`` artifacts
(dynamic and calibrated activation ranges) against the live int8 model and
their manifest against the JAX package's, the int8 SR pipeline, the CLI's
refusals, and the batch-dependent dynamic range.

The model is the JAX package's int8 serving test model (ch 128, ch_mult (1, 2),
one res block, z 8, S2RGB at 32²: all 20 body convs have ≥ 128 channels), its
JAX variables drawn from a numpy seed (``tests/test_torch_qconv.py``). JAX is
imported inside the tests that need it; the ``gpu`` case runs on the card
without it:

    python -m pytest tests/test_torch_serving_int8.py -m gpu --noconftest
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch
import yaml

from eovax_torch.core import config as tcfg
from eovax_torch.core.precision import FULL_PRECISION, INT8_POLICY
from eovax_torch.kernels import qconv
from eovax_torch.models.eo_flux_vae import EOFluxVAE
from eovax_torch.serving import ServedModel, calibrate_activations, export_sr_pipeline
from eovax_torch.utils.convert import state_dict_from_variables
from test_torch_qconv import _vae_variables, vae_cfg

WVS = [0.665, 0.56, 0.49]  # S2RGB
N_CONVS = 20  # the model's ResnetBlock conv1/conv2

_YAML = {"model": {
    part: {"z_channels": 8, "resolution": 32, channels: 3, "ch": 128, "ch_mult": [1, 2],
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
def variables():
    return _vae_variables(seed=3)[1]


@pytest.fixture(scope="module")
def state(variables):
    return state_dict_from_variables(variables)


@pytest.fixture(scope="module")
def port(state):
    """The live int8 model: fp32 weights, quantized on the fly."""
    return EOFluxVAE(vae_cfg(tcfg), state, policy=INT8_POLICY, device="cpu")


def _x(b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, 3, 32, 32)).astype(np.float32)


def _rms(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.std(ref))


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# The live int8 model against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["on-the-fly", "pre-quantized"])
def test_reconstruct_int8_matches_jax(variables, state, weights):
    """Under INT8_POLICY, with fp32 weights quantized on the fly, or with the JAX
    package's export-time quantization of them (its int8 tree converted) on
    both sides. The two packages' bf16 models already differ where they round
    to bf16 (the port's GroupNorm kernel rounds once after norm, AdaIN and
    swish; 3 % of max |output| here); an int8 conv turns a bf16 ulp into an int8
    step for about one value in two, and a flipped step moves a GroupNorm's
    statistics and so every later activation. The int8 models are held to rms
    0.15 of the output's spread and 0.2 of max |output| (measured 0.083 and
    0.094 on the fly, 0.082 and 0.101 pre-quantized). Even at fp32 compute a
    few flips from other summation orders grow through the 20 convs to a few %
    of the output, while one block agrees to fp32 sums
    (``tests/test_torch_qconv.py``)."""
    from eovax.core import config as jcfg
    from eovax.core.precision import INT8_POLICY as JI8
    from eovax.kernels.qconv import quantize_params_int8
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE

    if weights == "pre-quantized":
        qp, n = quantize_params_int8(variables["params"])
        variables = {**variables, "params": qp}
        state = state_dict_from_variables(variables)
        assert n == N_CONVS and state["encoder.mid.block_1.conv1.weight"].dtype == torch.int8
    x = _x(2, seed=1)
    ref = np.asarray(JaxVAE(vae_cfg(jcfg), variables, policy=JI8).reconstruct(x, np.asarray(WVS)),
                     np.float32)
    out = EOFluxVAE(vae_cfg(tcfg), state, policy=INT8_POLICY, device="cpu").reconstruct(x, WVS)
    out = out.float().numpy()
    assert out.shape == ref.shape == (2, 3, 32, 32)
    assert _rms(out, ref) < 0.15 and _rel(out, ref) < 0.2, (_rms(out, ref), _rel(out, ref))


# ---------------------------------------------------------------------------
# The export CLI's int8 artifacts
# ---------------------------------------------------------------------------


CALIB_PERCENTILE = 99.5


@pytest.fixture(scope="module")
def files(state, tmp_path_factory):
    """The model's config, checkpoint and calibration images."""
    root = tmp_path_factory.mktemp("int8")
    (root / "model_config.yaml").write_text(yaml.safe_dump(_YAML))
    torch.save({"state_dict": state}, root / "eo-vae.ckpt")
    np.savez(root / "calib.npz", images=_x(10, seed=5))  # two batches: 8 and 2
    return root


def _export(files, out: str, *extra) -> None:
    from eovax_torch.cli.export import main as export_main

    export_main(["--config", str(files / "model_config.yaml"), "--ckpt",
                 str(files / "eo-vae.ckpt"), "--output", str(files / out), "--modalities",
                 "S2RGB", "--resolution", "32", "--precision", "int8", "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def artifacts(files):
    """{"dynamic", "calibrated"}: the CLI's int8 artifacts, loaded on the CPU."""
    _export(files, "dynamic")
    _export(files, "calibrated", "--calibrate-npz", str(files / "calib.npz"),
            "--calibrate-percentile", str(CALIB_PERCENTILE))
    return {k: ServedModel.load(str(files / k), device="cpu") for k in ("dynamic", "calibrated")}


@pytest.mark.parametrize("kind", ["dynamic", "calibrated"])
def test_export_cli_int8_manifest_matches_jax(variables, artifacts, kind):
    """The manifest's ``quantization`` block equals the JAX package's for the
    same model; ``params.pt`` holds the 20 body convs' int8 weights, their fp32
    ``kernel_scale`` (and, calibrated, ``act_scale``), every other conv float."""
    from eovax.kernels.qconv import quantize_params_int8
    from eovax.serving.export import _quant_manifest

    served = artifacts[kind]
    _, n = quantize_params_int8(variables["params"])
    assert served._manifest["quantization"] == _quant_manifest(n, kind == "calibrated")
    assert served._manifest["policy"] == "int8"
    st = served._state
    int8 = {k for k, v in st.items() if v.dtype == torch.int8}
    assert len(int8) == N_CONVS and all(k.rsplit(".", 2)[-2] in ("conv1", "conv2") for k in int8)
    for suffix, want in (("kernel_scale", N_CONVS), ("act_scale", N_CONVS if kind == "calibrated"
                                                     else 0)):
        found = [v for k, v in st.items() if k.endswith(suffix)]
        assert len(found) == want and all(v.dtype == torch.float32 for v in found)
    ops = Counter(str(n.target) for n in served._fn("reconstruct", "S2RGB").graph.nodes
                  if str(n.target).startswith("eovax."))
    assert ops["eovax.conv3x3_int8.default"] == N_CONVS and ops["eovax.conv3x3.default"] == 0


def test_export_cli_int8_artifact_equals_the_live_model(port, state, files, artifacts):
    """The dynamic artifact is the live on-the-fly model bit for bit; the
    calibrated one is the live model built from the quantized state with the
    ranges that ``calibrate_activations`` gives on the same images."""
    for b in (1, 3):
        x = _x(b, seed=10 + b)
        assert torch.equal(artifacts["dynamic"].reconstruct(x, modality="S2RGB"),
                           port.reconstruct(x, WVS))
    images = np.load(files / "calib.npz")["images"]
    scales = calibrate_activations(port, [images[:8], images[8:]], modality="S2RGB",
                                   percentile=CALIB_PERCENTILE)
    st = artifacts["calibrated"]._state
    for conv, amax in scales.items():
        assert torch.equal(st[f"{conv}.act_scale"], torch.tensor(amax, dtype=torch.float32))
    live = EOFluxVAE(vae_cfg(tcfg), qconv.quantize_state_int8(state, scales)[0],
                     policy=INT8_POLICY, device="cpu")
    x = _x(2, seed=14)
    assert torch.equal(artifacts["calibrated"].reconstruct(x, modality="S2RGB"),
                       live.reconstruct(x, WVS))


def test_dynamic_range_spans_the_batch(artifacts):
    """A kept difference, in both packages: the dynamic per-tensor range is taken
    over the whole batch, so a row's output depends on the rows it is batched
    with (a daemon's micro-batch and its pad rows). Row 0 of a B = 3 call
    differs from its B = 1 call, bounded by the int8 error itself (rms 0.2 of
    the output's spread, 0.3 of max |output|; measured 0.080 and 0.077).
    Static ranges (a calibrated artifact) make the two equal."""
    x = _x(3, seed=20)
    x[1:] *= 3.0  # companions with a wider range
    dyn = artifacts["dynamic"]
    one, three = dyn.reconstruct(x[:1], modality="S2RGB"), dyn.reconstruct(x, modality="S2RGB")
    assert not torch.equal(one, three[:1])
    a, ref = three[:1].float().numpy(), one.float().numpy()
    assert _rms(a, ref) < 0.2 and _rel(a, ref) < 0.3, (_rms(a, ref), _rel(a, ref))
    cal = artifacts["calibrated"]
    assert torch.equal(cal.reconstruct(x[:1], modality="S2RGB"),
                       cal.reconstruct(x, modality="S2RGB")[:1])


def test_export_cli_refuses_calibration_without_int8_and_for_sr(files, capsys):
    from eovax_torch.cli.export import main as export_main

    base = ["--config", str(files / "model_config.yaml"), "--output", str(files / "x"),
            "--device", "cpu", "--calibrate-npz", str(files / "calib.npz")]
    for extra, message in ((["--precision", "16-mixed"], "--calibrate-npz requires --precision "
                            "int8"),
                           (["--precision", "int8", "--sr-config", "sr.yaml"],
                            "not supported for the SR pipeline")):
        with pytest.raises(SystemExit):
            export_main(base + extra)
        assert message in capsys.readouterr().err
    assert not (files / "x").exists()


# ---------------------------------------------------------------------------
# The int8 SR pipeline
# ---------------------------------------------------------------------------


UNET = {"in_channels": 8, "out_channels": 8, "cond_channels": 8, "hid_channels": [128],
        "hid_blocks": [1]}


def test_sr_export_int8_quantizes_both_networks(files, capsys):
    """``--sr-config --precision int8``: the VAE's body convs and the UNet's
    TimeResBlock convs carry int8 weights, as many as the JAX package quantizes
    of the same trees, and the pipeline serves finite output."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.qconv import quantize_params_int8
    from eovax.models.unet import UNet as JaxUNet
    from eovax.serving.export import _quant_manifest

    from eovax_torch.cli.export import main as export_main

    (files / "sr.yaml").write_text(yaml.safe_dump({"lightning_module": {"denoiser": {
        "backbone": UNET, "schedule": {"_target_": "azula.noise.RectifiedSchedule"}}}}))
    export_main(["--config", str(files / "model_config.yaml"), "--ckpt",
                 str(files / "eo-vae.ckpt"), "--output", str(files / "sr"), "--resolution", "32",
                 "--precision", "int8", "--device", "cpu", "--sr-config", str(files / "sr.yaml"),
                 "--sr-steps", "2"])
    ju = JaxUNet(**{k: tuple(v) if isinstance(v, list) else v for k, v in UNET.items()})
    shapes = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 8)),
                                            jnp.zeros((1,)), jnp.zeros((1, 16, 16, 8))))
    n_unet = quantize_params_int8(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes["params"]))[1]
    served = ServedModel.load(str(files / "sr"), device="cpu")
    assert served._manifest["quantization"] == _quant_manifest(N_CONVS + n_unet)
    assert f"int8: {N_CONVS + n_unet} convs pre-quantized" in capsys.readouterr().out
    for tree, want in ((served._state["vae"], N_CONVS), (served._state["sr"], n_unet)):
        assert sum(v.dtype == torch.int8 for v in tree.values()) == want
        assert sum(k.endswith("kernel_scale") for k in tree) == want
    y = served.super_resolve(np.random.default_rng(6).standard_normal((1, 4, 32, 32))
                             .astype(np.float32), seed=3)  # Sen2NAIP's 4 bands
    assert y.shape == (1, 4, 32, 32) and torch.isfinite(y).all()
    assert json.loads((files / "sr" / "manifest.json").read_text())["policy"] == "int8"


def test_sr_export_int8_requires_an_int8_denoiser(port, tmp_path):
    """Quantized UNet weights need the int8 dispatch: the exporter demands the
    denoiser's policy, int8, before it touches either network."""
    from eovax_torch.cli.train_super_res import build_denoiser_from_config

    cfg = {"denoiser": {"backbone": UNET}}
    denoiser, unet = build_denoiser_from_config(cfg, device="cpu")
    for policy in (None, FULL_PRECISION):
        with pytest.raises(ValueError, match="denoiser_policy"):
            export_sr_pipeline(port, denoiser, unet, str(tmp_path / "a"), resolution=32,
                               steps=2, denoiser_policy=policy)
    assert not (tmp_path / "a").exists()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_int8_artifact_on_card_equals_the_live_model(cuda_device, tmp_path):
    """The tiny int8 model exported on the card: the artifact equals the live
    model there bit for bit, each call 20 int8 kernel launches and no bf16
    conv3x3 launch, and it stays within the int8 error of the CPU's output."""
    from eovax_torch.kernels import conv3x3
    from eovax_torch.serving import export_model

    model = EOFluxVAE(vae_cfg(tcfg), policy=INT8_POLICY, device=cuda_device, seed=0)
    export_model(model, str(tmp_path), modalities=("S2RGB",), resolution=32,
                 functions=("reconstruct",))
    served = ServedModel.load(str(tmp_path))
    x = _x(3, seed=30)
    before = (qconv.conv3x3_int8.launches, conv3x3.conv3x3.launches)
    out = served.reconstruct(x, modality="S2RGB")
    torch.cuda.synchronize()
    assert (qconv.conv3x3_int8.launches - before[0], conv3x3.conv3x3.launches - before[1]) == (
        N_CONVS, 0)
    assert torch.equal(out, model.reconstruct(x, WVS))
    cpu = EOFluxVAE(vae_cfg(tcfg), {k: v.cpu() for k, v in model.core.state_dict().items()},
                    policy=INT8_POLICY, device="cpu").reconstruct(x, WVS)
    assert _rms(out.float().cpu().numpy(), cpu.float().numpy()) < 0.15
