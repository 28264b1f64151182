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


# (NCHW x shape, Co, dtype, inside the kernel's envelope): the bf16 K chunk of 16
# channels, the grid's 65535 pixel tiles ((4, 64) bf16, (8, 32) fp32) and batch
# rows, empty convs, a dtype the kernel lacks.
ENVELOPE_CASES = [
    ((1, 24, 8, 8), 16, torch.bfloat16, False), ((1, 24, 8, 8), 16, torch.float32, True),
    ((1, 16, 8, 8), 16, torch.bfloat16, True), ((2, 48, 37, 53), 96, torch.bfloat16, True),
    ((1, 16, 4096, 4096), 16, torch.bfloat16, False),
    ((1, 16, 4092, 4096), 16, torch.bfloat16, True),
    ((1, 16, 4096, 4096), 16, torch.float32, False), ((1, 16, 4088, 4096), 16, torch.float32, True),
    ((65536, 16, 4, 4), 16, torch.bfloat16, False), ((65535, 16, 4, 4), 16, torch.bfloat16, True),
    ((0, 16, 4, 4), 16, torch.bfloat16, False), ((1, 16, 4, 4), 0, torch.bfloat16, False),
    ((1, 16, 4, 4), 16, torch.float16, False),
]


@pytest.mark.parametrize("shape,co,dtype,inside", ENVELOPE_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-{c[1]}-{str(c[2])[6:]}"
                              for c in ENVELOPE_CASES])
def test_kernel_envelope_case_by_case(shape, co, dtype, inside):
    assert conv3x3.in_kernel_envelope(shape, co, dtype) == inside


def test_kernel_envelope_holds_every_shape_the_jax_kernel_takes():
    """``supports_pallas_conv3x3`` is narrower (128·k channels, W a multiple of
    16, a tile height that fits VMEM): each shape it sends to its Pallas kernel
    the port's kernel takes too, and each it leaves to XLA the port's rule
    decides on its own."""
    import jax.numpy as jnp

    from eovax.kernels.conv3x3 import supports_pallas_conv3x3

    taken = 0
    for b in (1, 16):
        for h, w in ((8, 16), (37, 48), (64, 64), (256, 256), (512, 512), (1024, 1024)):
            for ci in (16, 24, 64, 128, 256, 384, 512):
                for co in (64, 128, 256, 512):
                    if supports_pallas_conv3x3((b, h, w, ci), (3, 3, ci, co), (1, 1),
                                               jnp.bfloat16):
                        taken += 1
                        assert conv3x3.in_kernel_envelope((b, ci, h, w), co, torch.bfloat16)
    assert taken > 0


def _plain_launch(x, wt, bias, co, what):
    """The kernel's launch, replaced by the plain conv of the weights it reads
    (``_weights``' layout turned back to OIHW): the wrapper's widening on the CPU."""
    ci = x.shape[1]
    if x.dtype == torch.bfloat16:
        w = wt.permute(3, 2, 4, 0, 1).reshape(co, ci, 3, 3)
    else:
        w = wt.permute(2, 3, 0, 1)
    return conv3x3.conv3x3_plain(x, w, bias).contiguous()


# (x shape, Co, dtype, grid limit, launches): Ci = 24 padded to 32 in bf16; planes
# and batches past a grid shrunk to a few blocks, cut into row bands, column
# bands and batch blocks; Ci = 0 (the bias alone).
WIDEN_CASES = [((2, 24, 9, 11), 40, torch.bfloat16, 65535, 1),
               ((1, 16, 37, 53), 8, torch.bfloat16, 6, 2),
               ((1, 8, 13, 200), 8, torch.float32, 6, 6),
               ((5, 16, 4, 64), 8, torch.bfloat16, 2, 3),
               ((7, 24, 11, 330), 16, torch.bfloat16, 5, 24),
               ((1, 0, 5, 7), 4, torch.float32, 65535, 1)]


@pytest.mark.parametrize("shape,co,dtype,limit,launches", WIDEN_CASES,
                         ids=["ci-24", "row-bands", "column-bands", "batch-blocks",
                              "all-three", "ci-0"])
@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dx"])
def test_widening_computes_the_conv(monkeypatch, shape, co, dtype, limit, launches, grad):
    """Outside the kernel's envelope the wrapper pads the channels and cuts the
    conv into launches that its grid holds; with each launch replaced by the
    plain conv of what it reads, the result is the whole conv's (the data
    gradient through the same rule on the flipped weights), one count a launch."""
    from eovax_torch.kernels import grid

    monkeypatch.setattr(grid, "GRID_LIMIT", limit)
    monkeypatch.setattr(conv3x3, "_launch", _plain_launch)
    x, k, bias = map(torch.from_numpy, _data(*shape[:2], co, *shape[2:], seed=12))
    x = x.to(dtype)
    assert not conv3x3.in_kernel_envelope(x.shape, co, dtype)
    fn = conv3x3.conv3x3_dx if grad else conv3x3.conv3x3
    before = fn.launches
    if grad:
        gy = torch.from_numpy(np.random.default_rng(13).standard_normal(
            (shape[0], co, *shape[2:])).astype(np.float32)).to(dtype)
        out, ref = conv3x3._run(gy, conv3x3.flipped(k), None, fn), conv3x3.conv3x3_dx_plain(gy, k)
    else:
        out, ref = conv3x3._run(x, k, bias, fn), conv3x3.conv3x3_plain(x, k, bias)
    # The data gradient of a conv from 0 channels is empty: nothing to launch.
    assert fn.launches == before + (0 if grad and shape[1] == 0 else launches)
    assert out.dtype == dtype and out.shape == ref.shape and out.is_contiguous()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out, ref, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_library_path_matches_jax_outside_the_envelope(monkeypatch, dtype):
    """Ci = 24, outside both packages' kernels: the path the card takes there
    (channels padded for the kernel, each launch replaced by the plain conv of
    what it reads) against the JAX package's XLA conv, forward and dx (through
    the same rule on the flipped weights)."""
    import jax.numpy as jnp

    from eovax.kernels.conv3x3 import conv3x3 as jax_conv3x3

    monkeypatch.setattr(conv3x3, "_launch", _plain_launch)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, k, bias = _data(2, 24, 40, 9, 11, seed=9)
    g = np.random.default_rng(10).standard_normal((2, 40, 9, 11)).astype(np.float32)
    ref = _nchw(jax_conv3x3(*_to_jax(x, k, bias, jd)))
    xt, kt, bt = torch.from_numpy(x).to(dtype), torch.from_numpy(k), torch.from_numpy(bias)
    out = conv3x3._run(xt, kt, bt, conv3x3.conv3x3)
    dx = conv3x3._run(torch.from_numpy(g).to(dtype), conv3x3.flipped(kt), None,
                      conv3x3.conv3x3_dx)
    dx_ref = _jax_vjp(x, k, bias, g, jd)[0]
    assert out.dtype == dx.dtype == dtype
    for got, want in ((out, ref), (dx, dx_ref)):
        got = got.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, **TOL_F32)
        else:
            assert np.abs(got - want).max() <= TOL_BF16 * np.abs(want).max()


def test_pieces_tile_the_output_once_within_the_grid():
    """Each piece's input, with its halo, takes at most GRID_LIMIT tiles and
    batch rows; the pieces' outputs cover every output pixel once."""
    from eovax_torch.kernels import grid

    for b, h, w, tile in ((70000, 4, 4, (4, 64)), (1, 4096, 4096, (4, 64)),
                          (2, 8200, 300, (8, 32)), (1, 9, 64 * 65536, (4, 64))):
        cover = {}
        for bs, r0, r1, c0, c1 in grid.pieces(b, h, w, tile):
            hin = min(r1 + 1, h) - max(r0 - 1, 0)
            win = min(c1 + 1, w) - max(c0 - 1, 0)
            assert grid.fits(bs.stop - bs.start, hin, win, tile)
            cover[bs.start] = cover.get(bs.start, 0) + (r1 - r0) * (c1 - c0)
        assert cover == {b0: h * w for b0 in range(0, b, grid.GRID_LIMIT)}
    assert len(grid.pieces(1, 4096, 4096, (4, 64))) == 2


def _hand_kernel_module():
    """A module whose conv3x3 (Ci = 24 in bf16) and attention (D = 96) are
    outside their kernels' envelopes, beside a GroupNorm inside its own."""
    from eovax_torch.kernels.attention import flash_attention
    from eovax_torch.kernels.groupnorm import group_norm

    class Outside(torch.nn.Module):
        def forward(self, x, w, b, q, gx, gw, gb):
            return (conv3x3.conv3x3(x, w, b), flash_attention(q, q, q),
                    group_norm(gx, gw, gb, 32, swish=True))

    g = np.random.default_rng(11)
    args = [g.standard_normal(shape).astype(np.float32) for shape in
            ((2, 24, 8, 8), (16, 24, 3, 3), (16,), (2, 64, 96), (2, 64, 8, 8), (64,), (64,))]
    args = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    return Outside(), args


def _exported(module, args):
    from torch.export import Dim

    b = Dim("b", min=1)
    dims = tuple({0: b} if i in (0, 3, 4) else None for i in range(len(args)))
    return torch.export.export(module, tuple(args), dynamic_shapes=dims)


def test_export_keeps_one_custom_op_a_call_outside_the_envelope():
    """The widening is decided inside each custom op's CUDA implementation, where
    the batch is a number: the exported graph keeps one ``eovax::`` node a call
    whatever the shapes, and runs the plain versions on the CPU."""
    from collections import Counter

    module, args = _hand_kernel_module()
    program = _exported(module, args)
    ops = Counter(str(n.target) for n in program.graph.nodes if str(n.target).startswith("eovax."))
    assert ops == {"eovax.conv3x3.default": 1, "eovax.flash_attention.default": 1,
                   "eovax.group_norm.default": 1}
    for got, want in zip(program.module()(*args), module(*args)):
        assert torch.equal(got, want)


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
    """Operand errors raise; a shape outside the kernel's envelope is widened
    for it (``test_outside_the_envelope_widens_for_the_kernel_on_card``)."""
    k = torch.zeros(16, 24, 3, 3, device=cuda_device)
    bias = torch.zeros(16, device=cuda_device)
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
@pytest.mark.parametrize("shape,co,grad,launches", [((1, 24, 8, 8), 16, False, 1),
                                                    ((1, 16, 4096, 4096), 16, False, 2),
                                                    ((2, 16, 12, 20), 24, True, 1)],
                         ids=["ci-24", "plane-past-the-grid", "dx-ci-24"])
def test_outside_the_envelope_widens_for_the_kernel_on_card(cuda_device, shape, co, grad,
                                                             launches):
    """bf16 with Ci = 24 (padded to 32), a 4096² plane (65536 (4, 64) tiles: two
    row bands), and the data gradient of a conv to 24 channels (its dx has
    Ci = 24): the hand kernel computes each, one count a launch, within the
    bf16 tolerance of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)
    k = 0.05 * torch.randn(co, shape[1], 3, 3, generator=g, device=cuda_device)
    bias = torch.randn(co, generator=g, device=cuda_device)
    fn = conv3x3.conv3x3_dx if grad else conv3x3.conv3x3
    before = fn.launches
    if grad:
        gy = torch.randn(shape[0], co, *shape[2:], generator=g, device=cuda_device)
        out, ref = conv3x3.conv3x3_dx(gy.to(torch.bfloat16), k), conv3x3.conv3x3_dx_plain(
            gy.to(torch.bfloat16), k)
    else:
        out, ref = conv3x3.conv3x3(x, k, bias), conv3x3.conv3x3_plain(x, k, bias)
    torch.cuda.synchronize()
    assert fn.launches == before + launches
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape and out.is_contiguous()
    ref = ref.float()
    assert (out.float() - ref).abs().max().item() <= TOL_BF16 * ref.abs().max().item()


@pytest.mark.gpu
def test_export_outside_the_envelope_runs_the_kernels_on_card(cuda_device):
    """A graph exported on the CPU, run on the card: each ``eovax::`` op widens
    its shape there and launches its kernel once, as the eager call does."""
    from eovax_torch.kernels.attention import flash_attention
    from eovax_torch.kernels.groupnorm import group_norm

    module, args = _hand_kernel_module()
    program = _exported(module, args)
    args = [a.to(cuda_device) for a in args]
    fns = (conv3x3.conv3x3, flash_attention, group_norm)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        outs = program.module()(*args)
        torch.cuda.synchronize()
        assert [f.launches for f in fns] == [n + 1 for n in before]
        for got, want in zip(outs, module(*args)):
            assert torch.equal(got, want)


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
