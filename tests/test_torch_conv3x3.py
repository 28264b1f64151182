"""The port's 3×3 conv against the JAX package's, and its kernel on the card.

``conv3x3_plain`` is what the port computes on the CPU; here it is held
against ``eovax.kernels.conv3x3`` (its Pallas kernel in interpret mode in
fp32, and its dispatch in bf16) on the same numpy inputs, NHWC/HWIO ↔
NCHW/OIHW at the boundary, and the port's backward against the gradients of
the JAX package's ``custom_vjp``. The tests marked ``gpu`` hold the CUDA
kernel, forward and data gradient, against the plain versions on the card and
skip without one. They import no JAX, so the card's machine runs them
without it:

    python -m pytest tests/test_torch_conv3x3.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from eovax_torch.kernels import build, conv3x3

# fp32 on both sides, nine tap sums in other orders: the JAX kernel test's tolerance.
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
# bf16 operands and output: the sum over K = 9·Ci in another order plus one
# output rounding, relative to max |reference|.
TOL_BF16 = 2e-2


def _data(b, ci, co, h, w, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, ci, h, w)).astype(np.float32)
    k = (g.standard_normal((co, ci, 3, 3)) * 0.05).astype(np.float32)
    bias = g.standard_normal(co).astype(np.float32)
    return x, k, bias


def _to_jax(x, k, bias, dtype):
    import jax.numpy as jnp

    return (jnp.asarray(np.transpose(x, (0, 2, 3, 1)), dtype),
            jnp.asarray(np.transpose(k, (2, 3, 1, 0)), dtype), jnp.asarray(bias, dtype))


def _nchw(y):
    return np.transpose(np.asarray(y, np.float32), (0, 3, 1, 2))


@pytest.mark.parametrize(
    "b,ci,co,h,w,tile_h",
    [(1, 32, 32, 16, 16, 8), (2, 32, 48, 12, 20, 4), (1, 16, 64, 15, 9, 5), (2, 64, 32, 8, 8, 8)],
    ids=["square", "ci-ne-co", "odd-hw", "ci-gt-co"],
)
def test_plain_matches_jax_pallas_kernel_fp32(b, ci, co, h, w, tile_h):
    import jax.numpy as jnp

    from eovax.kernels.conv3x3 import _conv3x3_pallas

    x, k, bias = _data(b, ci, co, h, w)
    ref = _nchw(_conv3x3_pallas(*_to_jax(x, k, bias, jnp.float32), tile_h))
    out = conv3x3.conv3x3_plain(*map(torch.from_numpy, (x, k, bias))).numpy()
    np.testing.assert_allclose(out, ref, **TOL_F32)


@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(1, 128, 128, 16, 16), (2, 128, 256, 8, 16), (1, 32, 64, 9, 13)],
    ids=["pallas-envelope", "ci-ne-co", "odd-hw"],
)
def test_plain_matches_jax_dispatch_bf16(b, ci, co, h, w):
    """bf16 through the JAX dispatch: its Pallas kernel (interpret) inside
    its envelope, its XLA conv outside."""
    import jax.numpy as jnp

    from eovax.kernels.conv3x3 import conv3x3 as jax_conv3x3

    x, k, bias = _data(b, ci, co, h, w, seed=1)
    ref = _nchw(jax_conv3x3(*_to_jax(x, k, bias, jnp.bfloat16)))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = conv3x3.conv3x3_plain(xt, torch.from_numpy(k), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= TOL_BF16 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_plain_path_without_launch(dtype):
    x, k, bias = (torch.from_numpy(a) for a in _data(2, 32, 48, 7, 11, seed=2))
    x = x.to(dtype)
    before = conv3x3.conv3x3.launches
    out = conv3x3.conv3x3(x, k, bias)
    assert conv3x3.conv3x3.launches == before
    assert out.dtype == dtype and out.shape == (2, 48, 7, 11)
    torch.testing.assert_close(out, conv3x3.conv3x3_plain(x, k, bias), rtol=0, atol=0)


def _jax_vjp(x, k, bias, g, dtype):
    """(dx, dw, db) of the JAX package's ``conv3x3`` (its ``custom_vjp``), NCHW/OIHW."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.conv3x3 import conv3x3 as jax_conv3x3

    _, vjp = jax.vjp(jax_conv3x3, *_to_jax(x, k, bias, dtype))
    dx, dw, db = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1)), dtype))
    return _nchw(dx), np.transpose(np.asarray(dw, np.float32), (3, 2, 0, 1)), np.asarray(db,
                                                                                       np.float32)


def _torch_vjp(x, k, bias, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt, bt = torch.from_numpy(k).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    out = conv3x3.conv3x3(xt, kt, bt)
    assert type(out.grad_fn).__name__ == "_Conv3x3Backward"
    return [t.float().numpy() for t in torch.autograd.grad(out, (xt, kt, bt),
                                                           torch.from_numpy(g).to(dtype))]


@pytest.mark.parametrize("b,ci,co,h,w", [(2, 32, 48, 12, 20), (1, 16, 64, 15, 9)],
                         ids=["ci-ne-co", "odd-hw"])
def test_backward_matches_jax_custom_vjp_fp32(b, ci, co, h, w):
    """dx through the flipped, transposed weights, dw, db against ``_bwd``."""
    import jax.numpy as jnp

    x, k, bias = _data(b, ci, co, h, w, seed=3)
    g = np.random.default_rng(4).standard_normal((b, co, h, w)).astype(np.float32)
    for got, ref in zip(_torch_vjp(x, k, bias, g, torch.float32),
                        _jax_vjp(x, k, bias, g, jnp.float32)):
        np.testing.assert_allclose(got, ref, **TOL_F32)


def test_backward_matches_jax_pallas_dx_bf16():
    """bf16 inside the Pallas envelope: the JAX forward and its dx both run the
    Pallas kernel (interpret). dx and dw relative to max |reference| as the
    forward; db, Σg of bf16 values in fp32 against XLA's bf16 sum."""
    import jax.numpy as jnp

    x, k, bias = _data(1, 128, 128, 16, 16, seed=5)
    g = np.random.default_rng(6).standard_normal((1, 128, 16, 16)).astype(np.float32)
    for got, ref in zip(_torch_vjp(x, k, bias, g, torch.bfloat16),
                        _jax_vjp(x, k, bias, g, jnp.bfloat16)):
        assert np.abs(got - ref).max() <= TOL_BF16 * np.abs(ref).max()


def test_dx_is_the_conv_with_flipped_transposed_weights():
    x, k, _ = _data(2, 24, 40, 9, 11, seed=7)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 40, 9, 11))
                         .astype(np.float32))
    ref = torch.nn.grad.conv2d_input((2, 24, 9, 11), torch.from_numpy(k), g, padding=1)
    torch.testing.assert_close(conv3x3.conv3x3_dx(g, torch.from_numpy(k)), ref, **TOL_F32)
    torch.testing.assert_close(conv3x3.conv3x3_dx_plain(g, torch.from_numpy(k)), ref, **TOL_F32)


def test_cpu_backward_takes_the_function_without_launch():
    x, k, bias = (torch.from_numpy(a) for a in _data(1, 16, 32, 6, 7, seed=9))
    before = (conv3x3.conv3x3.launches, conv3x3.conv3x3_dx.launches)
    out = conv3x3.conv3x3(x.requires_grad_(), k, bias)
    out.sum().backward()
    assert (conv3x3.conv3x3.launches, conv3x3.conv3x3_dx.launches) == before
    dx, dw, db = conv3x3.conv3x3_backward_plain(torch.ones_like(out), x.detach(), k, bias)
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    with torch.inference_mode():
        assert conv3x3.conv3x3(x, k, bias).grad_fn is None


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(1, 16, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3.conv3x3(x, torch.empty(16, 16, 3, 3, device="meta"),
                        torch.empty(16, device="meta"))


def test_kernel_library_is_keyed_by_source_hash():
    lib = build.library_path(conv3x3.SOURCE)
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("conv3x3_") and lib.suffix == ".so"
    assert (build.CSRC / conv3x3.SOURCE).exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,ci,co,h,w,dtype,tol",
    [
        (2, 128, 128, 128, 128, torch.bfloat16, TOL_BF16),
        (1, 512, 256, 64, 64, torch.bfloat16, TOL_BF16),
        (2, 256, 512, 32, 32, torch.bfloat16, TOL_BF16),
        (2, 64, 96, 37, 53, torch.bfloat16, TOL_BF16),
        (2, 32, 64, 40, 40, torch.bfloat16, TOL_BF16),
        # the wgmma tile's edges: fewer 16-channel chunks than the 4-stage ring,
        # Co past one or two 128-channel blocks, W not a multiple of 64 or of 8,
        # one row, an odd batch
        (1, 16, 96, 9, 64, torch.bfloat16, TOL_BF16),
        (3, 48, 200, 1, 100, torch.bfloat16, TOL_BF16),
        (1, 48, 96, 7, 53, torch.bfloat16, TOL_BF16),
        (3, 16, 200, 5, 100, torch.bfloat16, TOL_BF16),
        (2, 64, 96, 37, 53, torch.float32, 1e-4),
        (1, 12, 40, 9, 70, torch.float32, 1e-4),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, b, ci, co, h, w, dtype, tol):
    """bf16: the sum over K = 9·Ci in another order plus one output rounding;
    fp32: another summation order. Both relative to max |reference|."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(b, ci, h, w, generator=g, device=cuda_device).to(dtype)
    k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=cuda_device)
    bias = torch.randn(co, generator=g, device=cuda_device)
    before = conv3x3.conv3x3.launches
    out = conv3x3.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert conv3x3.conv3x3.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, co, h, w)
    ref = conv3x3.conv3x3_plain(x, k, bias).float()
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,ci,co,h,w", [(1, 32, 128, 2, 64), (2, 48, 96, 3, 70)],
                         ids=["two-chunks", "three-chunks-odd-tile"])
@pytest.mark.parametrize("tap", range(9))
def test_kernel_one_hot_tap_shifts_exactly(cuda_device, tap, b, ci, co, h, w):
    """The identity over channels at one tap, zero elsewhere and zero bias:
    the output is the input shifted by (dy − 1, dx − 1) with zeros at the
    border, exactly in bf16 (one product of 1 and x per output)."""
    dy, dx = divmod(tap, 3)
    g = torch.Generator(device=cuda_device).manual_seed(tap)
    x = torch.randn(b, ci, h, w, generator=g, device=cuda_device).to(torch.bfloat16)
    k = torch.zeros(co, ci, 3, 3, device=cuda_device)
    n = min(ci, co)
    k[torch.arange(n), torch.arange(n), dy, dx] = 1.0
    out = conv3x3.conv3x3(x, k, torch.zeros(co, device=cuda_device))
    torch.cuda.synchronize()
    ref = torch.zeros(b, co, h, w, dtype=torch.bfloat16, device=cuda_device)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    ref[:, :n] = xp[:, :n, dy:dy + h, dx:dx + w]
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    k = torch.zeros(16, 24, 3, 3, device=cuda_device)
    bias = torch.zeros(16, device=cuda_device)
    x = torch.zeros(1, 24, 8, 8, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv3x3.conv3x3(x, k, bias)
    x = torch.zeros(1, 24, 8, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        conv3x3.conv3x3(x, k, bias)
    x = torch.zeros(1, 24, 8, 16, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3(x, k, bias)
    x = torch.zeros(1, 24, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="w \\[Co, Ci, 3, 3\\]"):
        conv3x3.conv3x3(x, k[:, :16], bias)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,ci,co,h,w,dtype,tol",
    [
        (2, 48, 96, 37, 53, torch.bfloat16, TOL_BF16),
        (2, 128, 128, 64, 64, torch.bfloat16, TOL_BF16),
        (2, 512, 256, 32, 32, torch.bfloat16, TOL_BF16),
        (3, 16, 32, 5, 100, torch.bfloat16, TOL_BF16),
        (2, 48, 96, 37, 53, torch.float32, 1e-4),
        (1, 12, 40, 9, 70, torch.float32, 1e-4),
    ],
)
def test_dx_kernel_matches_plain_on_card(cuda_device, b, ci, co, h, w, dtype, tol):
    """The data gradient: the kernel on g [B, Co, H, W] (its input channels are
    the forward's Co) with the flipped, transposed weights and no bias."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    grad = torch.randn(b, co, h, w, generator=g, device=cuda_device).to(dtype)
    k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=cuda_device)
    before = conv3x3.conv3x3_dx.launches
    dx = conv3x3.conv3x3_dx(grad, k)
    torch.cuda.synchronize()
    assert conv3x3.conv3x3_dx.launches == before + 1
    assert dx.dtype == dtype and dx.shape == (b, ci, h, w)
    ref = conv3x3.conv3x3_dx_plain(grad, k).float()
    assert (dx.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,ci,co,h,w", [(1, 32, 128, 6, 64), (2, 48, 96, 7, 70)])
@pytest.mark.parametrize("tap", range(9))
def test_dx_kernel_one_hot_gives_the_flipped_tap_exactly(cuda_device, tap, b, ci, co, h, w):
    """One nonzero weight w[o, i, dy, dx] = 1 and one nonzero output-gradient
    pixel g[b, o, y, x] = v: dx is v at [b, i, y + dy − 1, x + dx − 1] and zero
    elsewhere, exactly in bf16."""
    dy, dx_ = divmod(tap, 3)
    o, i, y, x = co - 1 - tap, (5 * tap) % ci, h // 2, (7 * tap) % w
    k = torch.zeros(co, ci, 3, 3, device=cuda_device)
    k[o, i, dy, dx_] = 1.0
    grad = torch.zeros(b, co, h, w, device=cuda_device, dtype=torch.bfloat16)
    grad[b - 1, o, y, x] = -1.75
    out = conv3x3.conv3x3_dx(grad, k)
    torch.cuda.synchronize()
    ref = torch.zeros(b, ci, h, w, device=cuda_device, dtype=torch.bfloat16)
    if 0 <= y + dy - 1 < h and 0 <= x + dx_ - 1 < w:
        ref[b - 1, i, y + dy - 1, x + dx_ - 1] = -1.75
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, TOL_BF16), (torch.float32, 1e-4)])
def test_backward_on_card_launches_dx_kernel_and_matches_plain(cuda_device, dtype, tol):
    """Autograd through conv3x3 on the card: the output has a grad_fn, the
    backward launches the kernel for dx, and dx, dw, db match the plain backward
    (dw, db are the same library and tensor ops on both sides)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(2, 64, 33, 47, generator=g, device=cuda_device).to(dtype).requires_grad_()
    k = (0.05 * torch.randn(96, 64, 3, 3, generator=g, device=cuda_device)).requires_grad_()
    bias = torch.randn(96, generator=g, device=cuda_device).requires_grad_()
    out = conv3x3.conv3x3(x, k, bias)
    assert out.grad_fn is not None
    grad = torch.randn(out.shape, generator=g, device=cuda_device).to(dtype)
    before = conv3x3.conv3x3_dx.launches
    out.backward(grad)
    torch.cuda.synchronize()
    assert conv3x3.conv3x3_dx.launches == before + 1
    refs = conv3x3.conv3x3_backward_plain(grad, x.detach(), k.detach(), bias.detach())
    for got, ref in zip((x.grad, k.grad, bias.grad), refs):
        assert got.dtype == ref.dtype
        ref = ref.float()
        assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
def test_inference_mode_on_card_launches_once_and_keeps_no_graph(cuda_device):
    x = torch.randn(1, 32, 8, 8, device=cuda_device).to(torch.bfloat16)
    k = torch.randn(32, 32, 3, 3, device=cuda_device, requires_grad=True)
    bias = torch.zeros(32, device=cuda_device, requires_grad=True)
    before = conv3x3.conv3x3.launches
    with torch.inference_mode():
        out = conv3x3.conv3x3(x, k, bias)
    assert conv3x3.conv3x3.launches == before + 1 and out.grad_fn is None
