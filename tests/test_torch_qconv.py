"""The port's int8 (W8A8) conv (``eovax_torch.kernels.qconv``) against the JAX
package's ``eovax.kernels.qconv``, and its kernel on the card.

The same numpy inputs go through both packages, NCHW/OIHW ↔ NHWC/HWIO at the
boundary: the quantization, both conv entry points (dynamic, static and
saturating activation ranges, fp32 and bf16 compute), the dispatch rule, the
export-time weight quantization, the calibration's percentile and reduction,
and a 128-channel ResnetBlock. The JAX package's int8 conv is XLA on the CPU,
so nothing here runs a kernel; the tests marked ``gpu`` hold the CUDA kernel
against its plain version on the card and skip without one. JAX is imported
inside the tests that need it, so the card's machine runs those without it:

    python -m pytest tests/test_torch_qconv.py -m gpu --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from eovax_torch.core.precision import (
    DEFAULT_POLICY,
    FULL_PRECISION,
    INT8_CALIB_POLICY,
    INT8_POLICY,
    policy_from_name,
)
from eovax_torch.kernels import build, qconv
from eovax_torch.nn.blocks import Conv3x3, ResnetBlock
from eovax_torch.utils.convert import module_path, state_dict_from_variables

# The int8 functions repeat the JAX package's operations in its order, each
# rounded once as there, and the int32 sums are exact on both sides: the
# outputs are held to one ulp of the compute dtype (measured: equal).
ULPS = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(b, ci, co, h, w, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, ci, h, w)).astype(np.float32)
    k = (g.standard_normal((co, ci, 3, 3)) * 0.05).astype(np.float32)
    bias = g.standard_normal(co).astype(np.float32)
    return x, k, bias


def _nhwc(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(np.transpose(x, (0, 2, 3, 1))).astype(dtype)


def _hwio(k):
    import jax.numpy as jnp

    return jnp.asarray(np.transpose(k, (2, 3, 1, 0)))


def _nchw(y) -> np.ndarray:
    return np.transpose(np.asarray(y, np.float32), (0, 3, 1, 2))


def _jdtype(dtype):
    import jax.numpy as jnp

    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _assert_ulps(got: torch.Tensor, ref: np.ndarray, dtype: torch.dtype, ulps: int = ULPS):
    """|got − ref| within ``ulps`` units in the last place of ``ref`` in ``dtype``."""
    g, r = got.float().numpy().astype(np.float64), ref.astype(np.float64)
    mant = 8 if dtype == torch.bfloat16 else 24
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - (mant - 1))
    assert got.dtype == dtype
    assert np.all(np.abs(g - r) <= ulps * ulp), float(np.max(np.abs(g - r) / ulp))


# ---------------------------------------------------------------------------
# The conv functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [False, True], ids=["per-tensor", "per-out-channel"])
def test_quantize_symmetric_matches_jax(per_channel):
    from eovax.kernels.qconv import quantize_symmetric

    x, k, _ = _data(2, 128, 64, 5, 7, seed=1)
    if per_channel:
        q_ref, s_ref = quantize_symmetric(_hwio(k), axis=(0, 1, 2))
        q, s = qconv.quantize_symmetric(torch.from_numpy(k), dim=(1, 2, 3))
        q_ref, s_ref = np.transpose(np.asarray(q_ref), (3, 2, 0, 1)), np.asarray(s_ref).reshape(-1)
    else:
        q_ref, s_ref = quantize_symmetric(_nhwc(x * 3.0, np.float32))
        q, s = qconv.quantize_symmetric(torch.from_numpy(x * 3.0))
        q_ref, s_ref = _nchw(q_ref).astype(np.int8), np.asarray(s_ref).reshape(-1)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.reshape(-1).numpy(), s_ref)


# Ci = 144: inside should_use_int8, outside the kernel's envelope (Ci a multiple
# of 32), where the card computes the plain version these hold to the JAX package.
SHAPES = [(1, 128, 128, 8, 8), (2, 128, 128, 9, 13), (1, 144, 128, 6, 7)]
SHAPE_IDS = ["1x128x8x8", "2x128x9x13", "1x144x6x7"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_int8_conv3x3_matches_jax(shape, dtype):
    from eovax.kernels.qconv import int8_conv3x3, quantize_symmetric

    x, k, bias = _data(*shape, seed=2)
    xd = torch.from_numpy(x).to(dtype)
    jd = _jdtype(dtype)
    ref = int8_conv3x3(_nhwc(x, jd), _hwio(k), np.asarray(bias), compute_dtype=jd)
    out = qconv.int8_conv3x3(xd, torch.from_numpy(k), torch.from_numpy(bias), compute_dtype=dtype)
    # The quantized activations are equal, and so are the outputs (to an ulp).
    xq_ref, _ = quantize_symmetric(_nhwc(x, jd))
    np.testing.assert_array_equal(qconv.quantize_symmetric(xd)[0].numpy(),
                                  _nchw(xq_ref).astype(np.int8))
    _assert_ulps(out, _nchw(ref), dtype)


@pytest.mark.parametrize("scale", ["dynamic", "static", "saturating"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_int8_conv3x3_prequant_matches_jax(shape, dtype, scale):
    """Export-time weights with the dynamic range, a static range at the true
    abs-max, and one at a quarter of it (a quarter of the activations saturate)."""
    from eovax.kernels.qconv import int8_conv3x3_prequant, quantize_symmetric

    x, k, bias = _data(*shape, seed=3)
    jd = _jdtype(dtype)
    wq, sw = quantize_symmetric(_hwio(k), axis=(0, 1, 2))
    twq, tsw = qconv.quantize_symmetric(torch.from_numpy(k), dim=(1, 2, 3))
    amax = float(np.abs(x).max())
    act = {"dynamic": None, "static": amax, "saturating": amax / 4}[scale]
    ref = int8_conv3x3_prequant(_nhwc(x, jd), wq, sw.reshape(-1), np.asarray(bias),
                                act_scale=act, compute_dtype=jd)
    out = qconv.int8_conv3x3_prequant(
        torch.from_numpy(x).to(dtype), twq, tsw.reshape(-1), torch.from_numpy(bias),
        act_scale=None if act is None else torch.tensor(act), compute_dtype=dtype)
    _assert_ulps(out, _nchw(ref), dtype)


def test_prequant_matches_on_the_fly():
    x, k, bias = (torch.from_numpy(a) for a in _data(2, 128, 128, 8, 8, seed=4))
    wq, sw = qconv.quantize_symmetric(k, dim=(1, 2, 3))
    for dtype in DTYPES:
        assert torch.equal(qconv.int8_conv3x3(x, k, bias, compute_dtype=dtype),
                           qconv.int8_conv3x3_prequant(x, wq, sw.reshape(-1), bias,
                                                       compute_dtype=dtype))


def test_kernel_function_is_the_plain_version_on_the_cpu():
    """On CPU tensors the kernel's wrapper computes its plain version and counts no
    launch; the plain version's int32 sum is exact (float64 conv of integers)."""
    x, k, bias = (torch.from_numpy(a) for a in _data(1, 64, 32, 6, 7, seed=5))
    wq, sw = qconv.quantize_symmetric(k, dim=(1, 2, 3))
    amax = x.abs().amax()
    before = qconv.conv3x3_int8.launches
    out = qconv.conv3x3_int8(x, wq, sw.reshape(-1), bias, amax)
    assert qconv.conv3x3_int8.launches == before
    assert torch.equal(out, qconv.conv3x3_int8_plain(x, wq, sw.reshape(-1), bias, amax))
    xq = torch.clamp(torch.round(x / qconv.quant_step(amax)), -127, 127).long()
    acc = torch.zeros(1, 32, 6, 7, dtype=torch.long)
    xp = torch.nn.functional.pad(xq, (1, 1, 1, 1))
    for dy in range(3):
        for dx in range(3):
            acc += torch.einsum("oi,bihw->bohw", wq[:, :, dy, dx].long(),
                                xp[:, :, dy:dy + 6, dx:dx + 7])
    step = qconv.quant_step(amax) * sw.reshape(-1)
    ref = acc.float() * step[None, :, None, None] + bias[None, :, None, None]
    assert torch.equal(out, ref)


def test_dispatch_rule_matches_jax():
    import jax.numpy as jnp

    from eovax.kernels.qconv import should_use_int8

    cases = [((2, 32, 32, 256), (3, 3, 256, 256), (1, 1)), ((2, 32, 32, 64), (3, 3, 64, 256), (1, 1)),
             ((2, 32, 32, 256), (3, 3, 256, 64), (1, 1)), ((2, 32, 32, 256), (3, 3, 256, 256), (2, 2)),
             ((2, 32, 32, 256), (1, 1, 256, 256), (1, 1)), ((1, 8, 8, 128), (3, 3, 128, 128), (1, 1)),
             ((1, 8, 8, 144), (3, 3, 144, 128), (1, 1)),
             ((1, 8, 8, 160), (3, 3, 160, 128), (1, 1))]
    for xs, ks, st in cases:
        for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
            nchw, oihw = (xs[0], xs[3], xs[1], xs[2]), (ks[3], ks[2], ks[0], ks[1])
            assert qconv.should_use_int8(nchw, oihw, st, td) == should_use_int8(xs, ks, st, jd)
    # Ci = 144 and 160 take the int8 path in both packages; the card's kernel takes
    # 160 (5 K chunks of 32) and computes 144 outside it.
    for ci, inside in ((144, False), (160, True)):
        assert qconv.should_use_int8((1, ci, 8, 8), (128, ci, 3, 3), (1, 1), torch.bfloat16)
        assert qconv.in_kernel_envelope((1, ci, 8, 8), 128) == inside


def test_policies():
    assert policy_from_name("int8") is INT8_POLICY and policy_from_name("w8a8") is INT8_POLICY
    assert INT8_POLICY.conv_algorithm == "int8" and INT8_POLICY.compute_dtype == torch.bfloat16
    assert INT8_CALIB_POLICY.conv_algorithm == "int8-calib"
    assert DEFAULT_POLICY.conv_algorithm == FULL_PRECISION.conv_algorithm == "direct"
    assert INT8_POLICY.calib_percentile == 99.9


@pytest.mark.parametrize("entry", ["on-the-fly", "prequant"])
def test_gradient_through_int8_raises(entry):
    """Inference-only, as the JAX package's custom_vjp: the backward raises
    instead of returning the zero gradient of round()."""
    x, k, bias = (torch.from_numpy(a) for a in _data(1, 128, 128, 4, 4, seed=6))
    x.requires_grad_()
    if entry == "on-the-fly":
        out = qconv.int8_conv3x3(x, k, bias)
    else:
        wq, sw = qconv.quantize_symmetric(k, dim=(1, 2, 3))
        out = qconv.int8_conv3x3_prequant(x, wq, sw.reshape(-1), bias)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.float().sum().backward()


def test_kernel_envelope_and_operands_raise():
    """The kernel's envelope, a rule on shapes (:func:`qconv.in_kernel_envelope`):
    Ci a multiple of 32, the grid of (4, 64) pixel tiles (at most 65535 of them)
    and batch rows, a non-empty conv; outside it a CUDA call computes the plain
    version. The operand checks, on meta tensors (any device), still raise:
    int8 weights, fp32 scales and bias, one fp32 range; a non-CUDA device."""
    meta = dict(device="meta")
    assert not qconv.in_kernel_envelope((1, 48, 8, 8), 64)
    assert not qconv.in_kernel_envelope((1, 144, 8, 8), 64)  # should_use_int8 takes it
    assert qconv.in_kernel_envelope((1, 32, 8, 8), 64)
    assert qconv.in_kernel_envelope((1, 160, 8, 8), 64)
    assert qconv._PIXEL_TILE == (4, 64)
    # 65536 tiles of the (4, 32) tile, 32768 of the (4, 64) one: inside the grid.
    assert qconv.in_kernel_envelope((1, 32, 4, 32 * 65536), 64)
    assert qconv.in_kernel_envelope((1, 32, 4 * 65535, 64), 64)
    for h, w in ((4, 64 * 65535 + 1), (4 * 65536, 64), (8, 64 * 32768)):  # 65536 tiles
        assert not qconv.in_kernel_envelope((1, 32, h, w), 64)
    assert qconv.in_kernel_envelope((65535, 32, 4, 4), 64)
    for shape, co in (((65536, 32, 4, 4), 64), ((0, 32, 4, 4), 64), ((1, 32, 4, 4), 0)):
        assert not qconv.in_kernel_envelope(shape, co)
    ws, b, amax = (torch.empty(64, **meta), torch.empty(64, **meta), torch.empty((), **meta))
    x = torch.empty(1, 48, 8, 8, dtype=torch.bfloat16, **meta)
    qconv.check_operands(x, torch.empty(64, 48, 3, 3, dtype=torch.int8, **meta), ws, b, amax)
    x = torch.empty(1, 64, 8, 8, dtype=torch.bfloat16, **meta)
    wq = torch.empty(64, 64, 3, 3, dtype=torch.int8, **meta)
    qconv.check_operands(x, wq, ws, b, amax)
    for bad, match in (((x.half(), wq, ws, b, amax), "bfloat16 or float32"),
                       ((x, wq.float(), ws, b, amax), "int8"),
                       ((x, wq, ws.half(), b, amax), "w_scale"),
                       ((x, wq, ws, b.half(), amax), "bias"),
                       ((x, wq, ws, b, torch.empty(2, **meta)), "amax")):
        with pytest.raises(ValueError, match=match):
            qconv.check_operands(*bad)
    with pytest.raises(ValueError, match="unsupported device"):
        qconv.conv3x3_int8(x, wq, ws, b, amax)


def _plain_launch(x, wt, w_scale, bias, amax, co):
    """The kernel's launch, replaced by the plain version on the weights it reads
    (``int8_weight_layout`` turned back to OIHW)."""
    wq = wt.permute(3, 2, 4, 0, 1).reshape(co, x.shape[1], 3, 3)
    qconv.conv3x3_int8.launches += 1
    return qconv.conv3x3_int8_plain(x, wq, w_scale, bias, amax).contiguous()


@pytest.mark.parametrize("shape,limit,launches", [((2, 144, 9, 13), 65535, 1),
                                                  ((3, 48, 13, 140), 3, 7)],
                         ids=["ci-144", "ci-48-in-pieces"])
def test_widening_computes_the_int8_conv(monkeypatch, shape, limit, launches):
    """Outside the kernel's envelope the wrapper pads the channels to 32 and cuts
    the conv into launches its grid holds, the range the whole tensor's; with
    each launch replaced by the plain version of what it reads, the result is
    the whole conv's bit for bit."""
    from eovax_torch.kernels import grid

    monkeypatch.setattr(grid, "GRID_LIMIT", limit)
    monkeypatch.setattr(qconv, "_launch", _plain_launch)
    g = np.random.default_rng(14)
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy((0.05 * g.standard_normal((64, shape[1], 3, 3))).astype(np.float32))
    bias = torch.from_numpy(g.standard_normal(64).astype(np.float32))
    wq, sw = qconv.quantize_symmetric(k, dim=(1, 2, 3))
    amax = x.float().abs().amax()
    assert not qconv.in_kernel_envelope(x.shape, 64)
    before = qconv.conv3x3_int8.launches
    out = qconv._run(x, wq, sw.reshape(-1), bias, amax)
    assert qconv.conv3x3_int8.launches == before + launches
    assert torch.equal(out, qconv.conv3x3_int8_plain(x, wq, sw.reshape(-1), bias, amax))


@pytest.mark.parametrize("ci", [32, 64, 512])
def test_int8_weight_layout_puts_each_weight_where_the_kernel_reads_it(ci):
    """Element (co, ci, ky, kx) of an OIHW ``wq`` lands at byte
    ((ky·3 + kx)·(Ci/16) + ci/16)·Co·16 + co·16 + ci % 16 of the kernel's
    weights: the address its 16-byte copies read for a (tap, 16-channel group,
    output channel). Co = 200 is a partial block of 128."""
    co = 200
    wq = torch.from_numpy(np.random.default_rng(ci).integers(-127, 128, (co, ci, 3, 3),
                                                             dtype=np.int8))
    wt = qconv.int8_weight_layout(wq)
    assert wt.dtype == torch.int8 and wt.is_contiguous() and wt.shape == (3, 3, ci // 16, co, 16)
    o, i, ky, kx = np.meshgrid(np.arange(co), np.arange(ci), np.arange(3), np.arange(3),
                               indexing="ij")
    at = ((ky * 3 + kx) * (ci // 16) + i // 16) * co * 16 + o * 16 + i % 16
    flat = wt.reshape(-1).numpy()
    np.testing.assert_array_equal(flat[at], wq.numpy())
    assert np.unique(at).size == flat.size  # every byte is some weight's


def test_kernel_library_is_keyed_by_source_hash():
    lib = build.library_path(qconv.SOURCE)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("conv3x3_int8_")
    assert (build.CSRC / qconv.SOURCE).exists()


# ---------------------------------------------------------------------------
# Weights quantized once, and calibration
# ---------------------------------------------------------------------------


def _vae_variables(seed: int = 0):
    """The JAX package's variables of a 128-channel VAE (ch_mult (1, 2), one res
    block, S2RGB, 32²), every leaf from a numpy seed."""
    import jax
    import jax.numpy as jnp
    import test_torch_serving as ts

    from eovax.core import config as jcfg
    from eovax.models.backbone import EOVAECore as JaxCore

    cfg = vae_cfg(jcfg)
    core = JaxCore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    shapes = jax.eval_shape(lambda: core.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.asarray(ts.WVS),
        sample_posterior=False, method=JaxCore.forward))
    return cfg, ts._fill(shapes, seed)


def vae_cfg(m):
    """The configuration of the JAX package's int8 serving tests (ch 128)."""
    stem = m.StemConfig(num_layers=1, wv_planes=64)
    kw = dict(resolution=32, ch=128, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              use_dynamic_ops=True, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(in_channels=3, **kw),
                       decoder=m.DecoderConfig(out_ch=3, **kw))


@pytest.fixture(scope="module")
def variables():
    return _vae_variables()[1]


def test_quantize_state_matches_jax(variables):
    """The port's quantization of the converted fp32 state is ``torch.equal`` to
    the converted JAX-quantized tree, with and without static ranges."""
    from eovax.kernels.qconv import quantize_params_int8

    g = np.random.default_rng(7)
    jax_scales = {}
    for path in _conv_paths(variables["params"]):
        jax_scales[path] = float(g.uniform(0.5, 4.0))
    for scales in (None, jax_scales):
        qp, n = quantize_params_int8(variables["params"], act_scales=scales)
        ref = state_dict_from_variables({**variables, "params": qp})
        ours, n_ours = qconv.quantize_state_int8(
            state_dict_from_variables(variables),
            None if scales is None else {module_path(k): v for k, v in scales.items()})
        assert n_ours == n == 20
        assert ours.keys() == ref.keys()
        for key in ref:
            assert ours[key].dtype == ref[key].dtype and torch.equal(ours[key], ref[key]), key
        assert sum(k.endswith("act_scale") for k in ours) == (0 if scales is None else 20)


def _conv_paths(params, path=()):
    for k, v in params.items():
        if isinstance(v, dict):
            if k in ("conv1", "conv2") and np.asarray(v["kernel"]).shape[2] >= 128:
                yield path + (k,)
            else:
                yield from _conv_paths(v, path + (k,))


def test_quantize_state_is_idempotent_and_takes_only_body_convs(variables):
    state = state_dict_from_variables(variables)
    once, n = qconv.quantize_state_int8(state, {"decoder.mid.block_1.conv1": 2.5})
    twice, n2 = qconv.quantize_state_int8(once)
    assert n == 20 and n2 == 0
    assert twice.keys() == once.keys() and all(torch.equal(twice[k], once[k]) for k in once)
    int8 = sorted(k for k, v in once.items() if v.dtype == torch.int8)
    assert len(int8) == 20 and all(k.rsplit(".", 2)[-2] in ("conv1", "conv2") for k in int8)
    # The stride-2 Downsample conv has a weight of the same shape and stays float,
    # as do the stems, the upsample and the 1×1 convs.
    assert once["encoder.down.0.downsample.conv.weight"].dtype == torch.float32
    assert once["decoder.mid.block_1.conv1.act_scale"].item() == 2.5
    assert all(once[k.replace(".weight", ".kernel_scale")].dtype == torch.float32 for k in int8)


def test_converted_jax_int8_tree_loads_into_the_int8_model(variables):
    """A JAX-quantized tree through the converter builds the prequantized port
    model, whose weights and output equal the port's own quantization's."""
    from eovax.kernels.qconv import quantize_params_int8

    from eovax_torch.core import config as tcfg
    from eovax_torch.models.eo_flux_vae import EOFluxVAE

    qp, _ = quantize_params_int8(variables["params"])
    converted = state_dict_from_variables({**variables, "params": qp})
    ours, _ = qconv.quantize_state_int8(state_dict_from_variables(variables))
    a = EOFluxVAE(vae_cfg(tcfg), converted, policy=INT8_POLICY, device="cpu")
    b = EOFluxVAE(vae_cfg(tcfg), ours, policy=INT8_POLICY, device="cpu")
    live = EOFluxVAE(vae_cfg(tcfg), state_dict_from_variables(variables), policy=INT8_POLICY,
                     device="cpu")
    conv = a.core.decoder.up[0].block[0].conv1
    assert conv.weight.dtype == torch.int8 and not conv.weight.requires_grad
    assert conv.kernel_scale.dtype == torch.float32
    x = np.random.default_rng(8).standard_normal((2, 3, 32, 32)).astype(np.float32)
    wvs = [0.665, 0.56, 0.49]
    y = a.reconstruct(x, wvs)
    assert torch.equal(y, b.reconstruct(x, wvs)) and torch.equal(y, live.reconstruct(x, wvs))


@pytest.mark.parametrize("n", [1000, 4097, 128 * 16 * 16])
@pytest.mark.parametrize("q", [99.9, 50.0, 100.0, 0.0, 37.3])
def test_abs_percentile_matches_jax(n, q):
    """Against ``jnp.percentile`` with q a constant of the traced function, as
    the JAX package's calibration sow calls it (an eager call passes q as a
    traced argument, and XLA then rounds the position otherwise)."""
    import jax
    import jax.numpy as jnp

    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    ref = float(jax.jit(lambda v: jnp.percentile(jnp.abs(v), q))(jnp.asarray(a)))
    got = qconv.abs_percentile(torch.from_numpy(a), q).item()
    assert got == pytest.approx(ref, rel=1e-6, abs=0)


def test_abs_percentile_over_2_24_elements_matches_numpy():
    """torch.quantile refuses more than 2²⁴ elements; the port's percentile
    takes them. The JAX package computes the position q/100·(n−1) in fp32,
    which above 2²⁴ rounds to an even index: the result lies between the order
    statistics two places either side of numpy's float64 position."""
    n = 2**24 + 2**12
    a = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    got = qconv.abs_percentile(torch.from_numpy(a), 99.9).item()
    pos = 0.999 * (n - 1)
    s = np.sort(np.abs(a))
    assert s[int(np.floor(pos)) - 2] <= got <= s[int(np.ceil(pos)) + 2]
    assert got == pytest.approx(float(np.percentile(np.abs(a), 99.9)), rel=1e-4)


def test_calibration_record_and_reduction_match_jax():
    """The ``int8-calib`` record of two eligible convs over two batches, and its
    reduction to static ranges, against the JAX package's sow and
    ``act_scales_from_calibration`` on the same bf16 inputs, to 1e-6."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import INT8_CALIB_POLICY as JCALIB
    from eovax.kernels.qconv import act_scales_from_calibration
    from eovax.nn.blocks import policy_conv3x3

    class Two(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = policy_conv3x3(self, x, 128, "conv1", JCALIB)
            return policy_conv3x3(self, h, 128, "conv2", JCALIB)

    g = np.random.default_rng(10)
    batches = [g.standard_normal((b, 128, 6, 6)).astype(np.float32) * 2 for b in (1, 2)]
    module = Two()
    params = module.init(jax.random.PRNGKey(0), _nhwc(batches[0], jnp.bfloat16))
    trees = [jax.device_get(module.apply(params, _nhwc(x, jnp.bfloat16), mutable=["calib"])[1]
                            ["calib"]) for x in batches]
    ref = {module_path(k): v for k, v in act_scales_from_calibration(trees).items()}

    sd = state_dict_from_variables(params)
    convs = {}
    for name in ("conv1", "conv2"):
        convs[name] = Conv3x3(128, 128, INT8_CALIB_POLICY)
        convs[name].load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()
                                     if k.startswith(name + ".")})
    records = []
    with torch.inference_mode():
        for x in batches:
            convs["conv2"](convs["conv1"](torch.from_numpy(x)))
            records.append({k: [v.item() for v in m.calib_amax] for k, m in convs.items()})
            for m in convs.values():
                m.calib_amax.clear()
    ours = qconv.act_scales_from_calibration(records)
    assert ours.keys() == ref.keys() == {"conv1", "conv2"}
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-6)


def test_calibrate_activations_matches_jax(variables):
    """``calibrate_activations`` on the model against the JAX package's, keys
    mapped through the converter. Both run the bf16 calibration policy, and the
    port rounds to bf16 at other places (its GroupNorm kernel rounds once after
    norm, AdaIN and swish): the recorded percentiles, 99.9 % of |x| near 3 where
    a bf16 ulp is 0.4-0.8 %, are held to 3e-2 (measured ≤ 1.1e-2)."""
    from eovax.core import config as jcfg
    from eovax.core.precision import DEFAULT_POLICY as JBF
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
    from eovax.serving.export import calibrate_activations as jax_calibrate

    from eovax_torch.core import config as tcfg
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.serving import calibrate_activations

    x = np.random.default_rng(11).standard_normal((2, 3, 32, 32)).astype(np.float32)
    batches = [x[:1], x[1:]]
    ref = jax_calibrate(JaxVAE(vae_cfg(jcfg), variables, policy=JBF), batches, modality="S2RGB")
    port = EOFluxVAE(vae_cfg(tcfg), state_dict_from_variables(variables), policy=DEFAULT_POLICY,
                     device="cpu")
    ours = calibrate_activations(port, batches, modality="S2RGB")
    ref = {module_path(k): v for k, v in ref.items()}
    assert ours.keys() == ref.keys() and len(ours) == 20
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=3e-2), k


# ---------------------------------------------------------------------------
# A ResnetBlock under the int8 policy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """(input, JAX block variables, port state) of a 128-channel ResnetBlock."""
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import DEFAULT_POLICY as JBF
    from eovax.nn.blocks import ResnetBlock as JaxBlock

    g = np.random.default_rng(12)
    x = g.standard_normal((1, 128, 8, 8)).astype(np.float32)
    v = JaxBlock(in_channels=128, out_channels=128, policy=JBF).init(
        jax.random.PRNGKey(0), _nhwc(x, jnp.float32))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * g.standard_normal(a.shape).astype(np.float32), v)
    return x, v, state_dict_from_variables(v)


def _jax_block(policy, v, x):
    import jax.numpy as jnp

    from eovax.nn.blocks import ResnetBlock as JaxBlock

    return _nchw(JaxBlock(in_channels=128, out_channels=128, policy=policy).apply(
        v, _nhwc(x, jnp.float32)))


def _port_block(policy, sd, x):
    b = ResnetBlock(128, 128, policy=policy)
    b.load_state_dict(sd)
    with torch.inference_mode():
        return b(torch.from_numpy(x)).float().numpy()


def _rms(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2)) / (np.std(ref) + 1e-8))


def test_resnet_block_int8_matches_jax(block):
    """Under INT8_POLICY (bf16): the port rounds the norm's output to bf16 at other
    places, and a bf16 ulp moves about one value in two across an int8 step, so
    the two packages' int8 blocks are held to 2.5e-2 of max |output| (measured
    1.2e-2; their bf16 blocks differ by 6.7e-3). The port's int8 block is within
    the JAX package's own bound of its bf16 block (rms < 0.05,
    tests/test_qconv.py). With an fp32-compute int8 policy and pre-quantized
    weights nothing rounds to bf16 and the blocks agree to fp32 sums (1e-5)."""
    from eovax.core.precision import FULL_PRECISION as JF
    from eovax.core.precision import INT8_POLICY as JI8
    from eovax.kernels.qconv import quantize_params_int8

    x, v, sd = block
    ref, out = _jax_block(JI8, v, x), _port_block(INT8_POLICY, sd, x)
    assert np.abs(out - ref).max() <= 2.5e-2 * np.abs(ref).max()
    assert _rms(out, _port_block(DEFAULT_POLICY, sd, x)) < 0.05

    qp, n = quantize_params_int8({"mid_block_1": v["params"]})  # a block's scope
    qv = {**v, "params": qp["mid_block_1"]}
    ref = _jax_block(dataclasses.replace(JF, conv_algorithm="int8"), qv, x)
    out = _port_block(dataclasses.replace(FULL_PRECISION, conv_algorithm="int8"),
                      state_dict_from_variables(qv), x)
    assert n == 2
    assert qv["params"]["conv1"]["kernel"].dtype == np.int8
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_int8_weight_under_another_policy_raises(block):
    _, _, sd = block
    q, _ = qconv.quantize_state_int8({f"mid.block_1.{k}": v for k, v in sd.items()})
    b = ResnetBlock(128, 128, policy=DEFAULT_POLICY)
    b.load_state_dict({k.split(".", 2)[2]: v for k, v in q.items()})
    with pytest.raises(ValueError, match="int8 conv algorithm"):
        b(torch.zeros(1, 128, 4, 4))


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("scale", ["dynamic", "static", "saturating"])
@pytest.mark.parametrize(
    "b,ci,co,h,w,dtype",
    [(2, 128, 128, 64, 64, torch.bfloat16), (1, 512, 256, 32, 32, torch.bfloat16),
     (2, 128, 128, 37, 53, torch.bfloat16), (3, 32, 200, 5, 100, torch.bfloat16),
     (1, 64, 96, 9, 40, torch.bfloat16), (2, 128, 64, 37, 53, torch.float32),
     (1, 32, 130, 4, 32, torch.float32), (1, 160, 128, 8, 8, torch.bfloat16),
     # The (4, 64) tile's edges: W a tile, a tile and a column, two tiles and two
     # columns, a quarter tile; H not a multiple of 4; 1, 2 or 3 K chunks (fewer
     # than the ring's 4 stages); Co = 200, a partial N block.
     (1, 32, 200, 5, 64, torch.bfloat16), (2, 64, 128, 8, 65, torch.bfloat16),
     (1, 96, 200, 5, 130, torch.bfloat16), (2, 128, 64, 16, 16, torch.bfloat16),
     (1, 32, 200, 5, 65, torch.float32), (1, 64, 128, 4, 130, torch.float32),
     (2, 128, 128, 16, 16, torch.float32)],
)
def test_kernel_equals_plain_on_card(cuda_device, b, ci, co, h, w, dtype, scale):
    """The kernel against its plain version on the card, bit for bit: the int32
    sums are exact and every other step rounds once, as the plain version does."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(b, ci, h, w, generator=g, device=cuda_device).to(dtype)
    k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=cuda_device)
    bias = torch.randn(co, generator=g, device=cuda_device)
    wq, sw = qconv.quantize_symmetric(k, dim=(1, 2, 3))
    amax = x.float().abs().amax() * {"dynamic": 1.0, "static": 1.5, "saturating": 0.25}[scale]
    before = qconv.conv3x3_int8.launches
    out = qconv.conv3x3_int8(x, wq, sw.reshape(-1), bias, amax)
    torch.cuda.synchronize()
    assert qconv.conv3x3_int8.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, co, h, w)
    assert torch.equal(out, qconv.conv3x3_int8_plain(x, wq, sw.reshape(-1), bias, amax))


@pytest.mark.gpu
@pytest.mark.parametrize("amax", [1.0, 3.7, 1e-3, 300.0])
def test_kernel_quantizes_every_bf16_value_as_plain(cuda_device, amax):
    """The kernel's quotient (a corrected reciprocal product) against the plain
    version's IEEE division on every finite bf16 value: the identity over 32
    channels at the centre tap, unit scales, so each output is one quantized input."""
    vals = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    vals = vals[torch.isfinite(vals)]
    x = torch.zeros(-(-vals.numel() // 2048) * 2048, dtype=torch.bfloat16, device=cuda_device)
    x[: vals.numel()] = vals.to(cuda_device)
    x = x.reshape(1, 32, -1, 64)
    wq = torch.zeros(32, 32, 3, 3, dtype=torch.int8, device=cuda_device)
    wq[torch.arange(32), torch.arange(32), 1, 1] = 1
    sw, a = torch.ones(32, device=cuda_device), torch.tensor(amax, device=cuda_device)
    assert torch.equal(qconv.conv3x3_int8(x, wq, sw, None, a),
                       qconv.conv3x3_int8_plain(x, wq, sw, None, a))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("tap", range(9))
def test_kernel_one_hot_tap_on_card(cuda_device, tap, dtype):
    """One tap alone, a permutation of 64 channels (4 groups of 16 over 2 K
    chunks), unit scales: each output is one quantized input, shifted by the
    tap and moved to its permuted channel. A wrong wgmma descriptor stride
    (LBO, SBO), tap offset or weight layout shows as a transposed or shifted
    tap. Two tiles each way: H = 6, W = 70."""
    ky, kx = divmod(tap, 3)
    c, h, w = 64, 6, 70
    g = torch.Generator(device=cuda_device).manual_seed(tap)
    x = torch.randn(1, c, h, w, generator=g, device=cuda_device).to(dtype)
    perm = (torch.arange(c, device=cuda_device) * 37 + 5) % c
    wq = torch.zeros(c, c, 3, 3, dtype=torch.int8, device=cuda_device)
    wq[perm, torch.arange(c, device=cuda_device), ky, kx] = 1
    sw = torch.ones(c, device=cuda_device)
    amax = x.float().abs().amax()
    out = qconv.conv3x3_int8(x, wq, sw, None, amax)
    torch.cuda.synchronize()
    sx = qconv.quant_step(amax)
    xq = torch.nn.functional.pad(torch.clamp(torch.round(x.float() / sx), -127, 127), (1, 1, 1, 1))
    want = torch.empty_like(out)
    want[:, perm] = (xq[:, :, ky:ky + h, kx:kx + w] * (sx * sw[0])).to(dtype)
    assert torch.equal(out, want)
    assert torch.equal(out, qconv.conv3x3_int8_plain(x, wq, sw, None, amax))


@pytest.mark.gpu
@pytest.mark.parametrize("ci", [48, 144])
def test_kernel_outside_its_envelope_widens_for_it_on_card(cuda_device, ci):
    """Ci not a multiple of 32 (144 is a width ``should_use_int8`` takes): both
    entry points pad the channels and launch the kernel once, equal to the plain
    version bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(ci)
    x = torch.randn(1, ci, 8, 8, generator=g, device=cuda_device).to(torch.bfloat16)
    k = torch.randn(64, ci, 3, 3, generator=g, device=cuda_device) * 0.05
    bias = torch.randn(64, generator=g, device=cuda_device)
    wq, sw = qconv.quantize_symmetric(k, dim=(1, 2, 3))
    launches = qconv.conv3x3_int8.launches
    outs = [qconv.int8_conv3x3_prequant(x, wq, sw.reshape(-1), bias),
            qconv.int8_conv3x3(x, k, bias)]
    torch.cuda.synchronize()
    assert qconv.conv3x3_int8.launches == launches + 2
    amax = x.float().abs().amax()
    want = qconv.conv3x3_int8_plain(x, wq, sw.reshape(-1), bias.float(), amax)
    for out in outs:
        assert torch.equal(out, want)
