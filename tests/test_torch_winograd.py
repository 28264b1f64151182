"""The port's Winograd F(2×2, 3×3) conv (``eovax_torch.kernels.winograd``)
against the JAX package's ``eovax.kernels.winograd``: the same numpy inputs,
NCHW/OIHW here and NHWC/HWIO there. fp32 at ``tests/test_winograd.py``'s
shapes, bf16 against the direct conv, the kernel transform, the dispatch rule
case by case, gradients, a 128-channel ResnetBlock, and a 128-channel VAE
under the ``"winograd"`` policy against the JAX package's
``WINOGRAD_POLICY``. The JAX package's Winograd conv is XLA, not Pallas; so is
the port's a torch composition, with no kernel of its own. JAX is imported
inside the tests that need it; the ``gpu`` cases run on the card without it:

    python -m pytest tests/test_torch_winograd.py -m gpu --noconftest
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eovax_torch.core.precision import (
    DEFAULT_POLICY,
    FULL_PRECISION,
    WINOGRAD_POLICY,
    policy_from_name,
)
from eovax_torch.kernels.winograd import should_use_winograd, transform_kernel, winograd_conv3x3
from eovax_torch.nn.blocks import ResnetBlock
import test_torch_qconv as tq
from test_torch_qconv import _data, _hwio, _nchw, _nhwc

WVS = [0.665, 0.56, 0.49]  # S2RGB


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rms(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / (np.std(ref) + 1e-8))


def _direct(x, k, bias=None) -> np.ndarray:
    return F.conv2d(torch.from_numpy(x), torch.from_numpy(k),
                    None if bias is None else torch.from_numpy(bias), padding=1).numpy()


@pytest.mark.parametrize("shape", [(2, 8, 8, 5, 7), (1, 4, 6, 3, 3), (2, 16, 10, 8, 16),
                                   (1, 32, 32, 1, 4)])
def test_fp32_matches_jax_and_the_direct_conv(shape):
    """fp32 compute at ``tests/test_winograd.py``'s (B, H, W, Ci, Co): within
    2e-5 of the JAX package's Winograd conv and of the direct conv."""
    import jax.numpy as jnp

    from eovax.kernels.winograd import winograd_conv3x3 as jax_winograd

    b, h, w, ci, co = shape
    g = np.random.default_rng(0)
    x = g.standard_normal((b, ci, h, w)).astype(np.float32)
    k = (g.standard_normal((co, ci, 3, 3)) * 0.1).astype(np.float32)
    bias = g.standard_normal(co).astype(np.float32)
    got = winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias),
                           compute_dtype=torch.float32).numpy()
    ref = _nchw(jax_winograd(_nhwc(x, jnp.float32), _hwio(k), jnp.asarray(bias),
                             compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, _direct(x, k, bias), atol=2e-5, rtol=2e-5)


def test_bf16_error_comparable_to_direct():
    """bf16 compute at [2, 128, 16, 16]: rms < 0.02 of the fp32 direct conv's
    spread, as the JAX package holds its own (port measured 0.0081, the
    direct bf16 conv 0.0029); and within the same of the JAX package's bf16
    Winograd conv (they round at the same places)."""
    import jax.numpy as jnp

    from eovax.kernels.winograd import winograd_conv3x3 as jax_winograd

    g = np.random.default_rng(1)
    x = g.standard_normal((2, 128, 16, 16)).astype(np.float32)
    k = (g.standard_normal((128, 128, 3, 3)) * 0.05).astype(np.float32)
    ref = _direct(x, k)
    got = winograd_conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(k), None,
                           compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert _rms(got, ref) < 0.02, _rms(got, ref)
    jax = _nchw(jax_winograd(_nhwc(x, jnp.bfloat16), _hwio(k), None,
                             compute_dtype=jnp.bfloat16))
    assert _rms(got, jax) < 0.02, _rms(got, jax)
    direct_bf16 = F.conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
                           padding=1).float().numpy()
    assert _rms(direct_bf16, ref) < _rms(got, ref)


def test_kernel_transform_matches_jax():
    """G w Gᵀ: [O, I, 3, 3] → [16, I, O], the JAX package's [16, I, O] of the
    HWIO kernel (fp32, 1e-6)."""
    from eovax.kernels.winograd import transform_kernel as jax_transform

    _, k, _ = _data(1, 4, 6, 4, 4, seed=2)
    got = transform_kernel(torch.from_numpy(k))
    assert got.shape == (16, 4, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_transform(_hwio(k))), atol=1e-6)


@pytest.mark.parametrize("x_shape,k_shape,strides,dtype,want", [
    ((2, 256, 32, 32), (256, 256, 3, 3), (1, 1), torch.bfloat16, True),
    ((2, 256, 32, 32), (256, 256, 3, 3), (1, 1), torch.float32, False),
    ((2, 256, 31, 32), (256, 256, 3, 3), (1, 1), torch.bfloat16, False),
    ((2, 256, 32, 33), (256, 256, 3, 3), (1, 1), torch.bfloat16, False),
    ((2, 64, 32, 32), (256, 64, 3, 3), (1, 1), torch.bfloat16, False),
    ((2, 256, 32, 32), (64, 256, 3, 3), (1, 1), torch.bfloat16, False),
    ((2, 128, 8, 8), (128, 128, 3, 3), (1, 1), torch.bfloat16, True),
    ((2, 256, 32, 32), (256, 256, 1, 1), (1, 1), torch.bfloat16, False),
    ((2, 256, 32, 32), (256, 256, 3, 3), (2, 2), torch.bfloat16, False),
], ids=["ok", "fp32", "odd-h", "odd-w", "ci-64", "co-64", "128", "1x1", "stride-2"])
def test_dispatch_rule_matches_jax(x_shape, k_shape, strides, dtype, want):
    """The port's rule (NCHW, OIHW) decides as the JAX package's (NHWC, HWIO),
    case by case."""
    import jax.numpy as jnp

    from eovax.kernels.winograd import should_use_winograd as jax_rule

    b, c, h, w = x_shape
    o, i, kh, kw = k_shape
    assert jax_rule((b, h, w, c), (kh, kw, i, o), strides,
                    jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) == want
    assert should_use_winograd(x_shape, k_shape, strides, dtype) == want


def test_policy_and_odd_input():
    assert policy_from_name("winograd") is policy_from_name("bf16-winograd") is WINOGRAD_POLICY
    assert WINOGRAD_POLICY.conv_algorithm == "winograd"
    assert WINOGRAD_POLICY.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even H, W"):
        winograd_conv3x3(torch.zeros(1, 4, 5, 6), torch.zeros(4, 4, 3, 3), None)


# ---------------------------------------------------------------------------
# A ResnetBlock, gradients
# ---------------------------------------------------------------------------


block = tq.block  # the module-scoped fixture, shared by name


def _port_block(policy, sd):
    b = ResnetBlock(128, 128, policy=policy)
    b.load_state_dict(sd)
    return b


def test_resnet_block_matches_jax_and_direct(block):
    """A 128-channel ResnetBlock at 8²: the port's under ``WINOGRAD_POLICY``
    within rms 0.02 of its direct bf16 block (the JAX package's own bound,
    ``tests/test_winograd.py``) and of the JAX package's Winograd block (bf16
    both: measured 0.0046 and 0.0036)."""
    from eovax.core.precision import WINOGRAD_POLICY as JW
    from test_torch_qconv import _jax_block

    x, v, sd = block
    with torch.inference_mode():
        wino = _port_block(WINOGRAD_POLICY, sd)(torch.from_numpy(x)).float().numpy()
        direct = _port_block(DEFAULT_POLICY, sd)(torch.from_numpy(x)).float().numpy()
    assert _rms(wino, direct) < 0.02, _rms(wino, direct)
    ref = _jax_block(JW, v, x)
    assert _rms(wino, ref) < 0.02, _rms(wino, ref)


def test_winograd_grads_flow_and_match_the_direct_conv():
    """Gradients through plain autograd: finite and nonzero through a
    ResnetBlock under the policy, and in fp32 compute the conv's input, weight
    and bias gradients equal the direct conv's within 1e-4 of max."""
    block = ResnetBlock(128, 128, policy=WINOGRAD_POLICY)
    x = torch.randn(1, 128, 8, 8, generator=torch.Generator().manual_seed(3))
    (block(x).float() ** 2).sum().backward()
    grads = [p.grad for p in block.parameters()]
    assert all(gr is not None and torch.isfinite(gr).all() for gr in grads)
    assert block.conv1.weight.grad.abs().max() > 0

    xs, ks, bs = (torch.from_numpy(a).requires_grad_() for a in _data(2, 8, 16, 6, 10, seed=4))
    outs = []
    for fn in (lambda: winograd_conv3x3(xs, ks, bs, compute_dtype=torch.float32),
               lambda: F.conv2d(xs, ks, bs, padding=1)):
        y = fn()
        outs.append(torch.autograd.grad((y * y.detach().cos()).sum(), (xs, ks, bs)))
    for got, ref in zip(*outs):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


# ---------------------------------------------------------------------------
# The VAE under the Winograd policy
# ---------------------------------------------------------------------------


def test_vae_under_winograd_matches_jax():
    """The 128-channel VAE (ch_mult (1, 2), one res block, S2RGB 32²: its 20
    ResnetBlock convs qualify) under ``"winograd"`` against the JAX package's
    under ``WINOGRAD_POLICY``, same numpy-drawn weights. Both compute in bf16
    and round at other places (the port's GroupNorm kernel rounds once after
    norm, AdaIN and swish), and a rounding in one conv grows through the later
    ones: the pair is held at rms 0.06 of the output's spread (measured 0.043;
    the two packages' direct bf16 models 0.027, their fp32 models agree to
    fp32). Each Winograd model is as far from the fp32 model as the other: the
    port's within rms 0.05 (measured 0.031; the JAX package's 0.034)."""
    from eovax.core import config as jcfg
    from eovax.core.precision import WINOGRAD_POLICY as JW
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
    from eovax_torch.core import config as tcfg
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.utils.convert import state_dict_from_variables
    from test_torch_qconv import _vae_variables, vae_cfg

    _, variables = _vae_variables(seed=5)
    state = state_dict_from_variables(variables)
    x = np.random.default_rng(6).standard_normal((2, 3, 32, 32)).astype(np.float32)
    ref = np.asarray(JaxVAE(vae_cfg(jcfg), variables, policy=JW).reconstruct(
        x, np.asarray(WVS)), np.float32)
    got, fp32 = (EOFluxVAE(vae_cfg(tcfg), state, policy=p, device="cpu").reconstruct(
        x, WVS).float().numpy() for p in (WINOGRAD_POLICY, FULL_PRECISION))
    assert got.shape == ref.shape == (2, 3, 32, 32) and np.isfinite(got).all()
    assert _rms(got, ref) < 0.06, _rms(got, ref)
    assert _rms(got, fp32) < 0.05, _rms(got, fp32)


def test_winograd_artifact_leaves_the_conv_kernel(tmp_path):
    """Exported under the policy, the 128-channel model's graph calls the conv
    kernel's op only where the rule does not hold (none of the 20 ResnetBlock
    convs), keeps its GroupNorm and attention ops, takes any batch, and equals
    the live model bit for bit."""
    from eovax_torch.core import config as tcfg
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.serving import ServedModel, export_model
    from test_torch_qconv import vae_cfg

    model = EOFluxVAE(vae_cfg(tcfg), policy=WINOGRAD_POLICY, device="cpu", seed=1)
    manifest = export_model(model, str(tmp_path), modalities=("S2RGB",), resolution=32,
                            functions=("reconstruct",))
    assert manifest["policy"] == "bf16-winograd"
    served = ServedModel.load(str(tmp_path), device="cpu")
    ops = Counter(str(n.target) for n in served._fn("reconstruct", "S2RGB").graph.nodes)
    assert ops["eovax.conv3x3.default"] == 0 and ops["aten.bmm.default"] == 20
    assert ops["eovax.group_norm.default"] == 24 and ops["eovax.flash_attention.default"] == 2
    for b in (1, 3):
        x = np.random.default_rng(b).standard_normal((b, 3, 32, 32)).astype(np.float32)
        assert torch.equal(served.reconstruct(x, modality="S2RGB"), model.reconstruct(x, WVS))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_winograd_on_the_card_against_its_cpu_path(cuda_device):
    """bf16 Winograd on the card against the same function on the CPU (rms
    0.01: the two bmm's sum in other orders and round to bf16), and the
    policy's tiny VAE on the card: no conv3x3 launch for its 20 ResnetBlock
    convs, its 24 GroupNorm and 2 attention launches, rms 0.05 of the CPU's."""
    from eovax_torch.core import config as tcfg
    from eovax_torch.kernels import attention, conv3x3, groupnorm
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from test_torch_qconv import vae_cfg

    FULL_PRECISION.activate()
    x, k, bias = (torch.from_numpy(a) for a in _data(2, 256, 128, 32, 32, seed=7))
    cpu = winograd_conv3x3(x.bfloat16(), k, bias).float()
    card = winograd_conv3x3(x.to(cuda_device).bfloat16(), k.to(cuda_device),
                            bias.to(cuda_device)).float().cpu()
    assert _rms(card.numpy(), cpu.numpy()) < 0.01

    model = EOFluxVAE(vae_cfg(tcfg), policy=WINOGRAD_POLICY, device="cpu", seed=1)
    on_card = EOFluxVAE(vae_cfg(tcfg), model.core.state_dict(), policy=WINOGRAD_POLICY,
                        device=cuda_device)
    xs = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(8))
    kernels = (conv3x3.conv3x3, groupnorm.group_norm, attention.flash_attention)
    for kern in kernels:
        kern.launches = 0
    y = on_card.reconstruct(xs, WVS)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kernels] == [0, 24, 2]
    assert _rms(y.float().cpu().numpy(), model.reconstruct(xs, WVS).float().numpy()) < 0.05
