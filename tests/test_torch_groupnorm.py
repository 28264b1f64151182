"""The port's GroupNorm against the JAX package's, and its kernels on the card.

``gn_channel_sums_plain`` and ``group_norm_plain`` are what the port computes
on the CPU; here they are held against ``eovax.kernels.groupnorm`` (its
Pallas statistics kernel in interpret mode, and its plain path) on the same
numpy inputs, transposed NHWC ↔ NCHW at the boundary, and the fused
AdaIN + swish variants against the JAX ResnetBlock's own sequence; the
backward against ``jax.vjp`` of the JAX package's ``group_norm`` (its
``custom_vjp``, ``_gn_bwd``) composed with AdaIN and swish in jnp. The
kernels' cluster plans are checked on the CPU, and their arithmetic (partial
sums per CTA, the rank-order combine) replayed in plain PyTorch against the
JAX package. The tests marked ``gpu`` hold the CUDA kernels, forward and
backward, against the plain versions on the card and skip without one. They import no JAX, so the card's
machine runs them without it:

    python -m pytest tests/test_torch_groupnorm.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from eovax_torch.kernels import build, groupnorm

# fp32 on both sides, sums in other orders.
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs, fp32 sums of up to 256 elements: the JAX kernel test's tolerance.
TOL_SUMS_BF16 = dict(rtol=1e-3, atol=1e-2)


def _x(shape, seed=0, loc=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + loc).astype(np.float32)


def _params(c, seed=1):
    g = np.random.default_rng(seed)
    return [(1.0 + 0.1 * g.standard_normal(c)).astype(np.float32),
            (0.1 * g.standard_normal(c)).astype(np.float32)]


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def _nchw(y):
    return np.transpose(np.asarray(y, np.float32), (0, 3, 1, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (2, 32, 8, 8), (1, 128, 32, 4)])
def test_channel_sums_plain_matches_jax_kernel(shape, dtype):
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import gn_channel_sums as jax_channel_sums

    x = torch.from_numpy(_x(shape)).to(dtype)  # values exact in both dtypes from here on
    xj = jnp.asarray(_nhwc(x.float().numpy())).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                      else jnp.float32)
    ref_s, ref_s2 = jax_channel_sums(xj, interpret=True)
    s, s2 = groupnorm.gn_channel_sums_plain(x)
    tol = TOL_SUMS_BF16 if dtype == torch.bfloat16 else TOL_F32
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), **tol)
    np.testing.assert_allclose(s2.numpy(), np.asarray(ref_s2), **tol)


@pytest.mark.parametrize(
    "shape,groups,loc",
    [((2, 64, 8, 8), 32, 0.0), ((2, 32, 8, 8), 32, 0.0), ((1, 64, 5, 7), 8, 0.0),
     ((2, 64, 8, 8), 32, 20.0)],
    ids=["two-per-group", "one-per-group", "odd-hw", "large-mean"],
)
def test_group_norm_plain_matches_jax(shape, groups, loc):
    """Against the JAX plain path and against its Pallas statistics (interpret)
    composed with its ``_apply``."""
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import _apply, _stats
    from eovax.kernels.groupnorm import group_norm as jax_group_norm

    x = _x(shape, loc=loc)
    w, b = _params(shape[1])
    xj, wj, bj = jnp.asarray(_nhwc(x)), jnp.asarray(w), jnp.asarray(b)
    ref_plain = _nchw(jax_group_norm(xj, wj, bj, groups, 1e-6, False))
    ref_kernel = _nchw(_apply(xj, *_stats(xj, groups, use_pallas=True, interpret=True), wj, bj,
                              groups, 1e-6))
    out = groupnorm.group_norm_plain(*map(torch.from_numpy, (x, w, b)), groups, 1e-6).numpy()
    np.testing.assert_allclose(out, ref_plain, **TOL_F32)
    # E[x²] − mean² of the TPU kernel cancels when |mean| ≫ std.
    tol = TOL_F32 if loc == 0.0 else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out, ref_kernel, **tol)


@pytest.mark.parametrize("ada", [None, "shared", "batched"])
def test_fused_adain_swish_matches_jax_resnet_sequence(ada):
    """norm → (AdaIN) → swish as eovax/nn/blocks.py ResnetBlock writes it, in fp32."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from eovax.nn.blocks import swish

    x = _x((2, 64, 8, 8), seed=2)
    w, b = _params(64, seed=3)
    g = np.random.default_rng(4)
    ada_shape = {"shared": (64,), "batched": (2, 64)}.get(ada)
    scale = shift = None
    h = fnn.GroupNorm(num_groups=32, epsilon=1e-6, dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(_nhwc(x)))
    if ada_shape:
        scale = (1.0 + 0.2 * g.standard_normal(ada_shape)).astype(np.float32)
        shift = (0.2 * g.standard_normal(ada_shape)).astype(np.float32)
        expand = (lambda v: v[None, None, None, :]) if ada == "shared" else (
            lambda v: v[:, None, None, :])
        h = h * expand(jnp.asarray(scale)) + expand(jnp.asarray(shift))
    ref = _nchw(swish(h))
    t = (lambda v: None if v is None else torch.from_numpy(v))
    out = groupnorm.group_norm_plain(t(x), t(w), t(b), 32, 1e-6, ada_scale=t(scale),
                                     ada_shift=t(shift), swish=True).numpy()
    np.testing.assert_allclose(out, ref, **TOL_F32)


# The closed-form backward against autodiff through _gn_bwd: fp32 sums over a
# group (and over B·H·W for the parameters) in other orders.
TOL_BWD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("swish", [False, True], ids=["no-swish", "swish"])
@pytest.mark.parametrize("ada", [None, "shared", "batched"])
def test_backward_matches_jax_gn_bwd_with_adain_and_swish(ada, swish):
    """dx, dweight, dbias, d(ada_scale), d(ada_shift) of norm → (AdaIN) →
    (swish), in the ResnetBlock's order, against jax.vjp in fp32."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import group_norm as jax_group_norm
    from eovax.nn.blocks import swish as jax_swish

    b, c, groups = 2, 64, 32
    x = _x((b, c, 7, 9), seed=10, loc=0.5)
    w, bias = _params(c, seed=11)
    rng = np.random.default_rng(12)
    ada_shape = {"shared": (c,), "batched": (b, c)}.get(ada)
    extra = []
    if ada_shape:
        extra = [(1.0 + 0.2 * rng.standard_normal(ada_shape)).astype(np.float32),
                 (0.2 * rng.standard_normal(ada_shape)).astype(np.float32)]
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jax_fn(xx, ww, bb, *st):
        y = jax_group_norm(xx, ww, bb, groups, 1e-6, False)
        if st:
            expand = (lambda v: v[None, None, None, :]) if st[0].ndim == 1 else (
                lambda v: v[:, None, None, :])
            y = y * expand(st[0]) + expand(st[1])
        return jax_swish(y) if swish else y

    _, vjp = jax.vjp(jax_fn, jnp.asarray(_nhwc(x)), jnp.asarray(w), jnp.asarray(bias),
                     *map(jnp.asarray, extra))
    refs = vjp(jnp.asarray(_nhwc(g)))
    refs = [_nchw(refs[0])] + [np.asarray(r) for r in refs[1:]]

    inputs = [torch.from_numpy(a).requires_grad_() for a in [x, w, bias] + extra]
    kw = dict(ada_scale=inputs[3], ada_shift=inputs[4]) if extra else {}
    out = groupnorm.group_norm(*inputs[:3], groups, 1e-6, swish=swish, **kw)
    assert type(out.grad_fn).__name__ == "_GroupNormBackward"
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, **TOL_BWD)


def test_backward_saves_the_forward_statistics_and_launches_nothing_on_cpu():
    x = torch.from_numpy(_x((2, 64, 5, 6), seed=13)).requires_grad_()
    w, b = (torch.from_numpy(a).requires_grad_() for a in _params(64))
    before = (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches)
    out = groupnorm.group_norm(x, w, b, swish=True)
    out.backward(torch.ones_like(out))
    assert (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches) == before
    mean, rstd = groupnorm.group_stats_plain(x.detach(), 32, 1e-6)
    ref = groupnorm.group_norm_backward_plain(torch.ones_like(out), x.detach(), mean, rstd,
                                              w.detach(), b.detach(), swish=True)
    for got, want in zip((x.grad, w.grad, b.grad), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.inference_mode():
        assert groupnorm.group_norm(x, w, b).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_plain_path_without_launch(dtype):
    x = torch.from_numpy(_x((2, 64, 6, 6), seed=5)).to(dtype)
    w, b = map(torch.from_numpy, _params(64))
    before = (groupnorm.group_norm.launches, groupnorm.gn_channel_sums.launches)
    out = groupnorm.group_norm(x, w, b, swish=True)
    sums = groupnorm.gn_channel_sums(x)
    assert (groupnorm.group_norm.launches, groupnorm.gn_channel_sums.launches) == before
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(out, groupnorm.group_norm_plain(x, w, b, swish=True), rtol=0,
                               atol=0)
    for got, ref in zip(sums, groupnorm.gn_channel_sums_plain(x)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(1, 32, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        groupnorm.group_norm(x, x[0, :, 0, 0], x[0, :, 0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        groupnorm.gn_channel_sums(x)


# (B, C, groups, H·W, itemsize, forward, inside): every group has a plan of both
# kernels (a group that no cluster of up to 16 CTAs cuts on channel boundaries,
# an odd cpg above 64, 2·odd above 128 or cpg above 1024, takes the pixel-split
# plan; a group of at most 4 KiB the forward's warp plan), so one launch takes
# every shape whose grid holds at most 2³¹ − 1 CTAs: at cpg 1 and n = 1, one
# CTA a group, 2³¹/32 rows of 32 groups are one CTA too many.
GN_ENVELOPE_CASES = [
    ((16, 128, 32, 65536, 2, True), True), ((16, 512, 32, 1024, 2, False), True),
    ((8, 64, 32, 256, 2, True), True), ((1, 32 * 64, 32, 4096, 2, False), True),
    ((1, 32 * 65, 32, 64, 2, True), True), ((1, 32 * 65, 32, 64, 2, False), True),
    ((1, 32 * 65, 32, 16, 2, True), True),  # the warp plan: 1040 elements, one warp
    ((1, 32 * 65, 32, 16, 2, False), True), ((1, 32 * 130, 32, 64, 4, True), True),
    ((1, 32 * 132, 32, 64, 4, True), True), ((1, 32 * 2048, 32, 64, 2, True), True),
    ((0, 64, 32, 64, 2, True), False),
    ((2 ** 26 - 1, 32, 32, 1, 2, True), True), ((2 ** 26, 32, 32, 1, 2, True), False),
]


@pytest.mark.parametrize("case,inside", GN_ENVELOPE_CASES,
                         ids=["x".join(map(str, c[0][:4])) + ("-fwd" if c[0][5] else "-bwd")
                              + f"-{c[0][4]}" for c in GN_ENVELOPE_CASES])
def test_kernel_envelope_case_by_case(case, inside):
    b, c, groups, n, itemsize, forward = case
    assert groupnorm.in_kernel_envelope(b, c, groups, n, itemsize, forward=forward) == inside


def test_kernel_envelope_holds_every_shipped_width():
    """The VAE (128-512 channels, 32 groups) and the SR UNets (min(32, C) groups)
    at every plane they run: inside both kernels."""
    for c in (32, 64, 128, 256, 512):
        for n in (16, 64, 256, 1024, 4096, 16384, 65536, 262144):
            for itemsize in (2, 4):
                for forward in (True, False):
                    assert groupnorm.in_kernel_envelope(16, c, 32, n, itemsize, forward=forward)


@pytest.mark.parametrize("swish,ada", [(False, None), (True, "batched")])
def test_library_path_matches_jax_outside_the_envelope(swish, ada):
    """65 channels a group (C = 2080, 32 groups), which the card's kernels take
    on the pixel-split plan: the CPU's forward and backward against the JAX
    package's ``group_norm`` and ``jax.vjp`` of it with AdaIN and swish."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import group_norm as jax_group_norm
    from eovax.nn.blocks import swish as jax_swish

    b, c, groups = 2, 32 * 65, 32
    assert groupnorm.in_kernel_envelope(b, c, groups, 8 * 8, 4)
    x = _x((b, c, 8, 8), seed=20, loc=0.5)
    w, bias = _params(c, seed=21)
    rng = np.random.default_rng(22)
    extra = [] if ada is None else [(1.0 + 0.2 * rng.standard_normal((b, c))).astype(np.float32),
                                    (0.2 * rng.standard_normal((b, c))).astype(np.float32)]
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jax_fn(xx, ww, bb, *st):
        y = jax_group_norm(xx, ww, bb, groups, 1e-6, False)
        if st:
            y = y * st[0][:, None, None, :] + st[1][:, None, None, :]
        return jax_swish(y) if swish else y

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(_nhwc(x)), jnp.asarray(w), jnp.asarray(bias),
                       *map(jnp.asarray, extra))
    refs = vjp(jnp.asarray(_nhwc(g)))
    t = [torch.from_numpy(a) for a in [x, w, bias] + extra]
    kw = dict(ada_scale=t[3], ada_shift=t[4]) if extra else {}
    out = groupnorm.group_norm(*t[:3], groups, 1e-6, swish=swish, **kw)
    np.testing.assert_allclose(out.numpy(), _nchw(ref), **TOL_F32)
    mean, rstd = groupnorm.group_stats_plain(t[0], groups, 1e-6)
    grads = groupnorm.group_norm_backward_plain(torch.from_numpy(g), t[0], mean, rstd, *t[1:3],
                                                swish=swish, **kw)
    for got, want in zip(grads, [_nchw(refs[0])] + [np.asarray(r) for r in refs[1:]]):
        np.testing.assert_allclose(got.numpy(), want, **TOL_BWD)


# (shape, groups) whose groups no cluster cuts on channel boundaries: 65 channels
# a group (odd above 64; n 128², 8², 5·7 ragged and 1), 130 (twice an odd number
# above 128) and GroupNorm(1, 2048) (above 1024).
SPLIT_SHAPES = [((4, 2080, 128, 128), 32), ((2, 2080, 8, 8), 32), ((2, 2080, 5, 7), 32),
                ((2, 2080, 1, 1), 32), ((2, 4160, 24, 24), 32), ((4, 2048, 64, 64), 1),
                ((2, 2048, 4, 4), 1), ((2, 2048, 1, 1), 1)]


def _check_split_plan(plan, c, groups, n, itemsize, operands):
    """The pixel-split plan: ``cluster`` slices of ``slice`` elements cut anywhere
    in the group's run, the last the rest and not empty; whole 16-byte vectors
    where n is a whole number of them; every element of the group owned by one
    CTA, in its resident or its streamed part, once."""
    span, vec = c // groups * n, 16 // itemsize
    assert plan.split and plan.cluster in (1, 2, 4, 8, 16)
    assert (plan.cluster - 1) * plan.slice < span <= plan.cluster * plan.slice
    assert 0 < plan.resident <= plan.slice
    assert plan.smem_bytes == operands * itemsize * plan.resident <= MAX_SMEM
    if n % vec == 0:
        assert plan.slice % vec == 0 and plan.resident % vec == 0
    cover = np.zeros(span, np.int32)
    for q in range(plan.cluster):
        lo = q * plan.slice
        length = min(plan.slice, span - lo)
        assert length > 0
        res = min(plan.resident, length)
        cover[lo:lo + res] += 1
        cover[lo + res:lo + length] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,groups", SPLIT_SHAPES,
                         ids=["x".join(map(str, s)) + f"-G{g}" for s, g in SPLIT_SHAPES])
def test_split_plan_partitions_each_group(shape, groups, itemsize, forward):
    """Where no cluster size cuts a group on channel boundaries, both kernels take
    the pixel-split plan (the forward's warp plan first where the group fits a
    warp), and one launch takes the shape."""
    b, c, h, w = shape
    n = h * w
    assert not groupnorm._cluster_sizes(c // groups, n, itemsize)
    assert groupnorm.in_kernel_envelope(b, c, groups, n, itemsize, forward=forward)
    if forward:
        plan = groupnorm._fwd_plan(b, c, groups, n, itemsize)
        if plan.cluster == 0:
            assert groupnorm._warp_plan(c, groups, n, itemsize, True)
            return
        _check_split_plan(plan, c, groups, n, itemsize, operands=1)
    else:
        _check_split_plan(groupnorm._bwd_plan(b, c, groups, n, itemsize), c, groups, n,
                          itemsize, operands=2)


def test_split_plan_leaves_every_channel_cut_plan_as_it_was():
    """The pixel-split plan is taken only where no cluster size cuts a group on
    channel boundaries: every width of the shipped models keeps its plan."""
    for c in (32, 64, 128, 256, 512):
        for n in (16, 64, 256, 1024, 4096, 16384, 65536, 262144, 35):
            for itemsize in (2, 4):
                assert not groupnorm._fwd_plan(16, c, 32, n, itemsize).split
                assert not groupnorm._bwd_plan(16, c, 32, n, itemsize).split


@pytest.mark.parametrize("limit", [64, 1000, 2 ** 31 - 1])
def test_batch_blocks_cover_the_batch_within_the_grid(monkeypatch, limit):
    """Past the grid's 2³¹ − 1 CTAs (here also a grid cut to ``limit``) a call runs
    as launches over blocks of the batch: each row in one block, in order, and
    each block's grid within the limit."""
    monkeypatch.setattr(groupnorm, "_MAX_GRID", limit)
    shapes = [(7, 64, 32, 64), (5, 2080, 32, 64), (3, 2048, 1, 16)]
    if limit == 2 ** 31 - 1:
        shapes.append((2 ** 26 + 3, 32, 32, 1))  # one CTA a group: 2³¹ + 96 CTAs
    for b, c, groups, n in shapes:
        for plan in (groupnorm._fwd_plan(b, c, groups, n, 2),
                     groupnorm._bwd_plan(b, c, groups, n, 2)):
            blocks = groupnorm._batch_blocks(b, groups, plan)
            assert blocks[0][0] == 0 and blocks[-1][1] == b
            assert all(hi == lo for (_, hi), (lo, _) in zip(blocks, blocks[1:]))
            per_row = groups * max(plan.cluster, 1)
            if per_row <= limit:
                assert all((b1 - b0) * per_row <= limit for b0, b1 in blocks)
            assert (len(blocks) == 1) == (b * per_row <= limit)
            assert groupnorm.in_kernel_envelope(b, c, groups, n, 2, forward=isinstance(
                plan, groupnorm.FwdPlan)) == (len(blocks) == 1)


def test_kernel_library_is_keyed_by_source_hash():
    lib = build.library_path(groupnorm.SOURCE)
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("groupnorm_") and lib.suffix == ".so"
    assert (build.CSRC / groupnorm.SOURCE).exists()


# The stage-2 train step's GroupNorm shapes (12-band 256² B=16, the shipped
# architecture), and two whose slices do not fit in shared memory whole.
TRAIN_STEP_SHAPES = [(16, 128, 256, 256), (16, 256, 256, 256), (16, 128, 128, 128),
                     (16, 256, 128, 128), (16, 512, 128, 128), (16, 256, 64, 64),
                     (16, 512, 64, 64), (16, 512, 32, 32)]
STREAMED_SHAPES = [((2, 128, 512, 512), 2), ((2, 256, 256, 256), 4)]
MAX_SMEM = 232448  # the H100's shared memory for one block (227 KB)


def _check_plan(plan, b, c, groups, n, itemsize, operands=2):
    """``operands`` tensors of a slice in shared memory: the forward's x, the
    backward's x and g."""
    cpg, vec = c // groups, 16 // itemsize
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.slice * plan.cluster == cpg * n
    # On channel boundaries: whole planes (at most 64 a slice) or a whole fraction of one.
    assert plan.slice % n == 0 and plan.slice // n <= 64 or n % plan.slice == 0
    assert 0 < plan.resident <= plan.slice
    assert plan.smem_bytes == operands * itemsize * plan.resident <= MAX_SMEM
    if n % vec == 0:
        assert plan.slice % vec == 0 and plan.resident % vec == 0
    # Resident and streamed parts cover each CTA's slice, and the slices the span, once.
    cover = np.zeros(cpg * n, np.int32)
    for q in range(plan.cluster):
        lo = q * plan.slice
        cover[lo:lo + plan.resident] += 1
        cover[lo + plan.resident:lo + plan.slice] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize(
    "shape,itemsize,streamed",
    [(s, 2, s == (16, 256, 256, 256)) for s in TRAIN_STEP_SHAPES]
    + [(s, i, True) for s, i in STREAMED_SHAPES]
    + [((2, 32, 16, 16), 2, False), ((2, 32, 256, 256), 4, False),
       ((2, 512, 8, 8), 4, False), ((2, 96, 37, 53), 2, False), ((1, 64, 5, 7), 4, False)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_bwd_plan_partitions_each_group_on_channel_boundaries(shape, itemsize, streamed):
    """Train-step shapes, the two streamed ones, cpg 1 and 16, and ragged n."""
    b, c, h, w = shape
    plan = groupnorm._bwd_plan(b, c, 32, h * w, itemsize)
    _check_plan(plan, b, c, 32, h * w, itemsize)
    assert (plan.resident < plan.slice) == streamed
    if streamed:
        assert plan.cluster == 16 and plan.smem_bytes == groupnorm._BWD_SMEM_TARGET
    elif c * 2 * itemsize * h * w // 32 >= groupnorm._BWD_SMEM_TARGET:
        # A group larger than one slice: three CTAs' slices fit on an SM.
        assert plan.smem_bytes <= groupnorm._BWD_SMEM_TARGET


def _replay_plan(plan, g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish):
    """The kernel's partition in plain PyTorch: per CTA of each (b, group) cluster
    and per channel of its slice, partial Σ dz and Σ dz·x̂ (the resident part,
    then the streamed rest); per channel the partials of its CTAs in rank order;
    then dx = k1·dz + k0 + k2·x̂ from the group's Σ a·S1 and Σ a·S2."""
    b, c, h, w = x.shape
    groups, n = mean.shape[1], h * w
    cpg = c // groups
    coef = groupnorm._plane_coefficients(x, mean, rstd, weight, bias, ada_scale, ada_shift)
    xh, dz = groupnorm._xhat_dz(x, g, coef, swish)
    xh, dz = xh.reshape(b, groups, cpg * n), dz.reshape(b, groups, cpg * n)
    seg = min(plan.slice, n)
    parts = {}
    for q in range(plan.cluster):
        for j in range(plan.slice // seg):
            lo = q * plan.slice + j * seg
            res = min(lo + seg, q * plan.slice + plan.resident)
            pieces = [(lo, max(lo, res)), (max(lo, res), lo + seg)]
            parts[q, j] = [sum(v[..., a:e].sum(-1) for a, e in pieces)
                           for v in (dz, dz * xh)]
    s1, s2 = torch.zeros(b, groups, cpg), torch.zeros(b, groups, cpg)
    for cc in range(cpg):
        q0 = cc * n // plan.slice
        nq = n // plan.slice if plan.slice < n else 1
        jj = (cc * n - q0 * plan.slice) // n
        for q in range(q0, q0 + nq):
            s1[..., cc] += parts[q, jj][0]
            s2[..., cc] += parts[q, jj][1]
    mu, r, a, _ = coef
    a = a.reshape(b, groups, cpg)
    inv = 1.0 / (n * cpg)
    k0 = -r.reshape(b, groups, cpg)[..., :1] * (a * s1).sum(-1, keepdim=True) * inv
    k2 = -r.reshape(b, groups, cpg)[..., :1] * (a * s2).sum(-1, keepdim=True) * inv
    k1 = (r.reshape(b, groups, cpg) * a)
    expand = (lambda v: v.repeat_interleave(n, dim=-1))
    dx = expand(k1) * dz + expand(k0.expand(-1, -1, cpg)) + expand(k2.expand(-1, -1, cpg)) * xh
    return dx.reshape(x.shape).to(x.dtype), s1.reshape(b, c), s2.reshape(b, c)


# form: (shape, _BWD_SMEM_TARGET for fp32, scaled with the element size), each
# plan form at a tiny shape, the target cut (and the cluster not grown for the
# grid's size) so that the plan takes it.
PLAN_FORMS = {
    "plane-parts": ((2, 64, 8, 8), 128),    # k = m·cpg: cpg 2, 8 CTAs, a quarter plane each
    "whole-planes": ((2, 128, 4, 4), 256),  # cpg = m·k: cpg 4, 2 CTAs of 2 planes
    "streamed": ((2, 64, 8, 16), 64),       # 16 CTAs of 1/8 plane each, half of it resident
    "ragged": ((1, 128, 5, 7), 1024),       # n = 35: whole planes, scalar loads
}


def _plan_form(monkeypatch, form, itemsize=4):
    shape, target = PLAN_FORMS[form]
    monkeypatch.setattr(groupnorm, "_BWD_SMEM_TARGET", target * itemsize // 4)
    monkeypatch.setattr(groupnorm, "_MIN_CTAS", 0)
    b, c, h, w = shape
    plan = groupnorm._bwd_plan(b, c, 32, h * w, itemsize)
    _check_plan(plan, b, c, 32, h * w, itemsize)
    cpg = c // 32
    assert {"plane-parts": plan.cluster > cpg, "whole-planes": plan.slice >= 2 * h * w,
            "streamed": plan.resident < plan.slice,
            "ragged": h * w % 4 != 0 and plan.cluster > 1}[form], plan
    return shape, plan


@pytest.mark.parametrize("swish,ada", [(True, "batched"), (False, None)],
                         ids=["adain-swish", "plain"])
@pytest.mark.parametrize("form", list(PLAN_FORMS))
def test_plan_replay_matches_jax_vjp(monkeypatch, form, swish, ada):
    """The kernel's partition and rank-order combine, replayed in fp32, against
    jax.vjp through the JAX package's group_norm (``_gn_bwd``), AdaIN and SiLU."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import group_norm as jax_group_norm
    from eovax.nn.blocks import swish as jax_swish

    shape, plan = _plan_form(monkeypatch, form)
    b, c = shape[:2]
    x = _x(shape, seed=20, loc=0.5)
    w, bias = _params(c, seed=21)
    rng = np.random.default_rng(22)
    extra = []
    if ada:
        extra = [(1.0 + 0.2 * rng.standard_normal((b, c))).astype(np.float32),
                 (0.2 * rng.standard_normal((b, c))).astype(np.float32)]
    g = rng.standard_normal(shape).astype(np.float32)

    def jax_fn(xx, ww, bb, *st):
        y = jax_group_norm(xx, ww, bb, 32, 1e-6, False)
        if st:
            y = y * st[0][:, None, None, :] + st[1][:, None, None, :]
        return jax_swish(y) if swish else y

    _, vjp = jax.vjp(jax_fn, jnp.asarray(_nhwc(x)), jnp.asarray(w), jnp.asarray(bias),
                     *map(jnp.asarray, extra))
    refs = vjp(jnp.asarray(_nhwc(g)))
    refs = [_nchw(refs[0])] + [np.asarray(r) for r in refs[1:]]

    t = [torch.from_numpy(a) for a in [x, w, bias] + extra]
    ada_scale, ada_shift = (t[3], t[4]) if extra else (None, None)
    mean, rstd = groupnorm.group_stats_plain(t[0], 32, 1e-6)
    got = groupnorm._backward(lambda *args: _replay_plan(plan, *args), torch.from_numpy(g), t[0],
                              mean, rstd, t[1], t[2], ada_scale, ada_shift, swish)
    got = [v for v in got if v is not None]
    assert len(got) == len(refs)
    for a, ref in zip(got, refs):
        np.testing.assert_allclose(a.numpy(), ref, **TOL_BWD)


# The forward's shapes: the train step's 8, the three 2-4 MiB groups of a 512²
# reconstruct, and the SR UNet's two (2 and 16 channels a group); and, by
# element size, those whose slices do not fit in shared memory whole.
FWD_SHAPES = TRAIN_STEP_SHAPES + [(4, 128, 512, 512), (4, 512, 256, 256), (4, 256, 512, 512),
                                  (8, 512, 64, 64), (8, 64, 16, 16)]
FWD_STREAMED = {2: {(4, 128, 512, 512), (4, 512, 256, 256), (4, 256, 512, 512)}}
FWD_STREAMED[4] = FWD_STREAMED[2] | {(16, 256, 256, 256)}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fwd_plan_partitions_each_group_on_channel_boundaries(shape, itemsize):
    """Every element of a (b, group) owned once, on channel boundaries; the
    slices of the 2-4 MiB groups (and fp32 1 MiB) streamed past the target; the
    SR UNet's 1 KiB groups in one warp's registers."""
    b, c, h, w = shape
    plan = groupnorm._fwd_plan(b, c, 32, h * w, itemsize)
    span = c // 32 * h * w
    if shape == (8, 64, 16, 16):
        assert plan == groupnorm.FwdPlan(0, span, span, 0)
        assert span * itemsize <= 32 * groupnorm._WARP_VECS * 16
        return
    _check_plan(plan, b, c, 32, h * w, itemsize, operands=1)
    streamed = shape in FWD_STREAMED[itemsize]
    assert (plan.resident < plan.slice) == streamed
    assert plan.smem_bytes <= groupnorm._FWD_SMEM_TARGET
    if streamed:
        assert plan.cluster == 16 and plan.smem_bytes == groupnorm._FWD_SMEM_TARGET


def _replay_fwd_plan(plan, x, weight, bias, ada_scale, ada_shift, swish, groups=32, eps=1e-6):
    """The forward kernel's partition in plain PyTorch (the warp plan: two exact
    passes over the group): per CTA of each (b, group)
    cluster, Σx, Σ(x − K) and Σ(x − K)² over its slice about K, the mean of the
    slice's first 256 elements; the group's mean from the partials in rank
    order; per CTA its shifted sums moved to μ, Σ(x − μ)² = Σd² + 2(K − μ)Σd +
    m(K − μ)²; those in rank order; then y = (x − μ)·a + c per channel,
    a = r·γ·s, c = β·s + t. Returns (y, mean, rstd)."""
    b, c, h, w = x.shape
    cpg, n = c // groups, h * w
    if plan.cluster == 0:  # the warp plan: the exact two passes over the group
        xf = x.float().reshape(b, groups, -1)
        mu = xf.sum(-1) / (cpg * n)
        m2 = (xf - mu[..., None]).square().sum(-1)
    else:
        sl, k = plan.slice, plan.cluster
        xf = x.float().reshape(b, groups, k, sl)
        shift = xf[..., :min(256, sl)].mean(-1)
        d = xf - shift[..., None]
        total = torch.zeros(b, groups)
        for q in range(k):
            total = total + xf[..., q, :].sum(-1)
        mu = total / (cpg * n)
        dk = shift - mu[..., None]
        parts = d.square().sum(-1) + dk * (2.0 * d.sum(-1) + sl * dk)
        m2 = torch.zeros(b, groups)
        for q in range(k):
            m2 = m2 + parts[..., q]
    rstd = torch.rsqrt(m2.clamp_min(0.0) / (cpg * n) + eps)
    s = (ada_scale if ada_scale is not None else torch.ones(c)).float().expand(b, c)
    t = (ada_shift if ada_shift is not None else torch.zeros(c)).float().expand(b, c)
    a = rstd.repeat_interleave(cpg, dim=1) * weight.float() * s
    cc = bias.float() * s + t
    y = ((x.float() - mu.repeat_interleave(cpg, dim=1)[:, :, None, None]) * a[:, :, None, None]
         + cc[:, :, None, None])
    if swish:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype), mu, rstd


# form: (shape, _FWD_SMEM_TARGET for fp32, scaled with the element size), each
# plan form at a small shape, the target cut (and the cluster not grown for the
# grid's size, and the warp plan off but in its own form) so that the plan
# takes it. Together they cover cluster sizes 1-16; every slice is longer than
# the 256 elements its shift K is taken from.
FWD_PLAN_FORMS = {
    "warp": ((2, 64, 16, 16), 1024),           # cpg 2, 512 elements in one warp
    "one-cta": ((2, 32, 16, 24), 1536),       # cpg 1, one CTA of one plane
    "whole-planes": ((2, 128, 16, 16), 2048),  # cpg 4, 2 CTAs of 2 planes
    "plane-parts": ((2, 64, 32, 48), 1536),    # cpg 2, 8 CTAs of a quarter plane
    "streamed": ((2, 64, 64, 64), 1024),       # 16 CTAs of 1/8 plane, half of it resident
    "ragged": ((1, 128, 15, 21), 1280),        # n = 315, 4 CTAs of one plane, scalar loads
}


def _fwd_plan_form(monkeypatch, form, itemsize=4, batch=None):
    """The form's shape (its batch replaced by ``batch``) and plan."""
    shape, target = FWD_PLAN_FORMS[form]
    shape = shape if batch is None else (batch, *shape[1:])
    monkeypatch.setattr(groupnorm, "_FWD_SMEM_TARGET", target * itemsize // 4)
    monkeypatch.setattr(groupnorm, "_MIN_CTAS", 0)
    if form != "warp":
        monkeypatch.setattr(groupnorm, "_WARP_VECS", 0)
    b, c, h, w = shape
    plan = groupnorm._fwd_plan(b, c, 32, h * w, itemsize)
    if form == "warp":
        assert plan == groupnorm.FwdPlan(0, c // 32 * h * w, c // 32 * h * w, 0), plan
        return shape, plan
    _check_plan(plan, b, c, 32, h * w, itemsize, operands=1)
    assert {"one-cta": plan.cluster == 1 and c == 32,
            "whole-planes": plan.cluster == 2 and plan.slice == 2 * h * w,
            "plane-parts": plan.cluster == 8 and plan.slice * 4 == h * w,
            "streamed": plan.cluster == 16 and plan.resident < plan.slice,
            "ragged": h * w % 4 != 0 and plan.cluster == 4}[form], plan
    return shape, plan


# (loc, AdaIN [B, C] + swish). Limits relative to max |reference|, as on the
# card (PERF.md §2): 1e-5, fp32 sums in other orders (at loc = 30 a sum near
# 30·N rounds at a few 1e-6 of the mean). At loc = 30 the JAX kernel path's
# E[x²] − mean² loses about 4 digits of the variance to cancellation (its own
# test allows 1e-3 there); the JAX two-pass path holds 1e-5 in every case.
FWD_REPLAY_CASES = {"adain-swish": (0.5, True), "loc30": (30.0, False)}


def _assert_rel_max(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("case", list(FWD_REPLAY_CASES))
@pytest.mark.parametrize("form", list(FWD_PLAN_FORMS))
def test_fwd_plan_replay_matches_jax(monkeypatch, form, case):
    """The forward kernel's partition and rank-order combines, replayed in fp32,
    against the JAX package's ``_stats`` (its Pallas statistics kernel in
    interpret mode, and its two-pass path) + ``_apply``, then AdaIN and SiLU as
    the ResnetBlock writes them; the saved mean and rstd against its mean and
    rsqrt(var + eps)."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import _apply, _stats
    from eovax.nn.blocks import swish as jax_swish

    loc, film = FWD_REPLAY_CASES[case]
    shape, plan = _fwd_plan_form(monkeypatch, form)
    b, c = shape[:2]
    x = _x(shape, seed=30, loc=loc)
    w, bias = _params(c, seed=31)
    rng = np.random.default_rng(32)
    ada = [None, None]
    if film:
        ada = [(1.0 + 0.2 * rng.standard_normal((b, c))).astype(np.float32),
               (0.2 * rng.standard_normal((b, c))).astype(np.float32)]
    xj, wj, bj = jnp.asarray(_nhwc(x)), jnp.asarray(w), jnp.asarray(bias)
    t = (lambda v: None if v is None else torch.from_numpy(v))
    got, mean, rstd = _replay_fwd_plan(plan, t(x), t(w), t(bias), t(ada[0]), t(ada[1]), film)
    for pallas in (False, True):
        tol = 1e-3 if pallas and loc == 30.0 else 1e-5
        ref_mean, ref_var = _stats(xj, 32, use_pallas=pallas, interpret=True)
        y = _apply(xj, ref_mean, ref_var, wj, bj, 32, 1e-6)
        if film:
            y = y * jnp.asarray(ada[0])[:, None, None, :] + jnp.asarray(ada[1])[:, None, None, :]
            y = jax_swish(y)
        _assert_rel_max(got.numpy(), _nchw(y), tol)
        _assert_rel_max(mean.numpy(), ref_mean, tol)
        _assert_rel_max(rstd.numpy(), jax.lax.rsqrt(ref_var + 1e-6), tol)


def _split_slices(plan, span):
    """(first element, length) of each CTA's slice on the pixel-split plan."""
    return [(q * plan.slice, min(plan.slice, span - q * plan.slice)) for q in range(plan.cluster)]


def _replay_split_fwd(plan, x, weight, bias, ada_scale, ada_shift, swish, groups, eps=1e-6):
    """The forward kernel on the pixel-split plan in plain PyTorch: per CTA of each
    (b, group) cluster, Σx, Σ(x − K) and Σ(x − K)² over its slice about K, the
    mean of the slice's first 256 elements; the group's mean from the partials
    in rank order; each CTA's shifted sums moved to μ with its own length, in
    rank order; then y = (x − μ)·a + c per channel. Returns (y, mean, rstd)."""
    b, c, h, w = x.shape
    cpg, n = c // groups, h * w
    xf = x.float().reshape(b, groups, cpg * n)
    parts = []
    for lo, length in _split_slices(plan, cpg * n):
        xs = xf[..., lo:lo + length]
        shift = xs[..., :min(256, length)].mean(-1)
        d = xs - shift[..., None]
        parts.append((xs.sum(-1), shift, d.sum(-1), d.square().sum(-1), length))
    total = torch.zeros(b, groups)
    for part in parts:
        total = total + part[0]
    mu = total / (cpg * n)
    m2 = torch.zeros(b, groups)
    for _, shift, sd, sd2, length in parts:
        dk = shift - mu
        m2 = m2 + (sd2 + dk * (2.0 * sd + length * dk))
    rstd = torch.rsqrt(m2.clamp_min(0.0) / (cpg * n) + eps)
    y = _normalize_replay(x, mu, rstd, weight, bias, ada_scale, ada_shift, swish)
    return y, mu, rstd


def _normalize_replay(x, mu, rstd, weight, bias, ada_scale, ada_shift, swish):
    b, c = x.shape[:2]
    cpg = c // mu.shape[1]
    s = (ada_scale if ada_scale is not None else torch.ones(c)).float().expand(b, c)
    t = (ada_shift if ada_shift is not None else torch.zeros(c)).float().expand(b, c)
    a = rstd.repeat_interleave(cpg, dim=1) * weight.float() * s
    cc = bias.float() * s + t
    y = ((x.float() - mu.repeat_interleave(cpg, dim=1)[:, :, None, None]) * a[:, :, None, None]
         + cc[:, :, None, None])
    return (torch.nn.functional.silu(y) if swish else y).to(x.dtype)


def _replay_split_bwd(plan, g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish):
    """The backward kernel on the pixel-split plan in plain PyTorch: per CTA and
    per channel its slice touches, partial Σ dz and Σ dz·x̂; a channel whole in
    one slice keeps its CTA's sums, a split one adds its CTAs' partials in rank
    order; the group's Σ a·S1 and Σ a·S2 are each CTA's Σ a·(its partials), in
    channel order, added in rank order; then dx = k1·dz + k0 + k2·x̂."""
    b, c, h, w = x.shape
    groups, n = mean.shape[1], h * w
    cpg = c // groups
    coef = groupnorm._plane_coefficients(x, mean, rstd, weight, bias, ada_scale, ada_shift)
    xh, dz = groupnorm._xhat_dz(x, g, coef, swish)
    xh, dz = xh.reshape(b, groups, cpg * n), dz.reshape(b, groups, cpg * n)
    a = coef[2].reshape(b, groups, cpg)
    s1, s2 = torch.zeros(b, groups, cpg), torch.zeros(b, groups, cpg)
    g1, g2 = torch.zeros(b, groups), torch.zeros(b, groups)
    for lo, length in _split_slices(plan, cpg * n):
        t1, t2 = torch.zeros(b, groups), torch.zeros(b, groups)
        for cc in range(lo // n, (lo + length - 1) // n + 1):
            e0, e1 = max(cc * n, lo), min((cc + 1) * n, lo + length)
            p1, p2 = dz[..., e0:e1].sum(-1), (dz * xh)[..., e0:e1].sum(-1)
            s1[..., cc] += p1  # the channel's CTAs in rank order
            s2[..., cc] += p2
            t1, t2 = t1 + a[..., cc] * p1, t2 + a[..., cc] * p2
        g1, g2 = g1 + t1, g2 + t2
    r = coef[1].reshape(b, groups, cpg)
    k0 = -r[..., :1] * g1[..., None] / (n * cpg)
    k2 = -r[..., :1] * g2[..., None] / (n * cpg)
    expand = (lambda v: v.repeat_interleave(n, dim=-1))
    dx = expand(r * a) * dz + expand(k0.expand(-1, -1, cpg)) + expand(k2.expand(-1, -1, cpg)) * xh
    return dx.reshape(x.shape).to(x.dtype), s1.reshape(b, c), s2.reshape(b, c)


# (shape, groups) of the replays: 65 channels a group at n = 64 (slices cut
# inside channels) and n = 35 (ragged), GroupNorm(1, 2048) at n = 16 (a slice
# of 128 channels: two windows of the kernels').
SPLIT_REPLAY_CASES = {"cpg65": ((2, 2080, 8, 8), 32), "cpg65-ragged": ((1, 2080, 5, 7), 32),
                      "G1-C2048": ((2, 2048, 4, 4), 1)}


@pytest.mark.parametrize("case", list(SPLIT_REPLAY_CASES))
def test_split_plan_replay_matches_jax(case):
    """The pixel-split plan's partition and rank-order combines of both kernels,
    replayed in fp32 with AdaIN [B, C] and swish, against the JAX package: the
    forward (and the saved mean and rstd) against its ``_stats`` two-pass path +
    ``_apply``, within 1e-5 of max |reference|; the backward's five gradients
    against ``jax.vjp`` of its ``group_norm`` (``_gn_bwd``), AdaIN and SiLU,
    within ``TOL_BWD``; and the port's ``group_norm`` and its autograd on the
    CPU against the same references."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.groupnorm import _apply, _stats
    from eovax.kernels.groupnorm import group_norm as jax_group_norm
    from eovax.nn.blocks import swish as jax_swish

    shape, groups = SPLIT_REPLAY_CASES[case]
    b, c, h, w = shape
    fplan = groupnorm._fwd_plan(b, c, groups, h * w, 4)
    bplan = groupnorm._bwd_plan(b, c, groups, h * w, 4)
    assert fplan.split and bplan.split and bplan.cluster > 1, (fplan, bplan)
    x = _x(shape, seed=40, loc=0.5)
    wt, bias = _params(c, seed=41)
    rng = np.random.default_rng(42)
    ada = [(1.0 + 0.2 * rng.standard_normal((b, c))).astype(np.float32),
           (0.2 * rng.standard_normal((b, c))).astype(np.float32)]
    g = rng.standard_normal(shape).astype(np.float32)
    t = [torch.from_numpy(a) for a in [x, wt, bias] + ada]

    xj = jnp.asarray(_nhwc(x))
    ref_mean, ref_var = _stats(xj, groups, use_pallas=False)
    y = _apply(xj, ref_mean, ref_var, jnp.asarray(wt), jnp.asarray(bias), groups, 1e-6)
    y = jax_swish(y * jnp.asarray(ada[0])[:, None, None, :] + jnp.asarray(ada[1])[:, None, None, :])
    got, mean, rstd = _replay_split_fwd(fplan, *t, swish=True, groups=groups)
    _assert_rel_max(got.numpy(), _nchw(y), 1e-5)
    _assert_rel_max(mean.numpy(), ref_mean, 1e-5)
    _assert_rel_max(rstd.numpy(), jax.lax.rsqrt(ref_var + 1e-6), 1e-5)

    def jax_fn(xx, ww, bb, sc, sh):
        yy = jax_group_norm(xx, ww, bb, groups, 1e-6, False)
        return jax_swish(yy * sc[:, None, None, :] + sh[:, None, None, :])

    _, vjp = jax.vjp(jax_fn, xj, *map(jnp.asarray, [wt, bias] + ada))
    refs = vjp(jnp.asarray(_nhwc(g)))
    refs = [_nchw(refs[0])] + [np.asarray(r) for r in refs[1:]]
    mean, rstd = groupnorm.group_stats_plain(t[0], groups, 1e-6)
    grads = groupnorm._backward(lambda *args: _replay_split_bwd(bplan, *args), torch.from_numpy(g),
                                t[0], mean, rstd, t[1], t[2], t[3], t[4], True)
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, **TOL_BWD)

    # The port's own group_norm (its CPU path) and its autograd, at the same widths.
    inputs = [v.clone().requires_grad_() for v in t]
    out = groupnorm.group_norm(*inputs[:3], groups, 1e-6, ada_scale=inputs[3],
                               ada_shift=inputs[4], swish=True)
    _assert_rel_max(out.detach().numpy(), _nchw(y), 1e-5)
    for got, ref in zip(torch.autograd.grad(out, inputs, torch.from_numpy(g)), refs):
        np.testing.assert_allclose(got.numpy(), ref, **TOL_BWD)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(device, shape, dtype, ada, loc=0.0):
    g = torch.Generator(device=device).manual_seed(0)
    b, c = shape[:2]
    x = (torch.randn(shape, generator=g, device=device) + loc).to(dtype)
    w = 1.0 + 0.1 * torch.randn(c, generator=g, device=device)
    bias = 0.1 * torch.randn(c, generator=g, device=device)
    ada_shape = {"shared": (c,), "batched": (b, c)}.get(ada)
    kw = {}
    if ada_shape:
        kw = dict(ada_scale=1.0 + 0.2 * torch.randn(ada_shape, generator=g, device=device),
                  ada_shift=0.2 * torch.randn(ada_shape, generator=g, device=device))
    return x, w, bias, kw


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype,ada,swish,loc,tol",
    [
        ((2, 128, 256, 256), torch.bfloat16, None, True, 0.0, 1e-2),
        ((4, 512, 64, 64), torch.bfloat16, "batched", True, 0.0, 1e-2),
        ((2, 256, 32, 32), torch.bfloat16, "shared", True, 0.0, 1e-2),
        ((2, 96, 37, 53), torch.float32, "shared", True, 0.0, 1e-5),
        ((2, 96, 37, 53), torch.float32, None, False, 30.0, 1e-5),
        ((2, 32, 40, 40), torch.float32, "batched", True, 0.0, 1e-5),
        ((2, 32, 40, 40), torch.bfloat16, None, False, 0.0, 1e-2),
    ],
)
def test_kernels_match_plain_on_card(cuda_device, shape, dtype, ada, swish, loc, tol):
    """bf16: one rounding of the output; fp32: sums in another order. Both
    relative to max |reference|."""
    x, w, bias, kw = _card_inputs(cuda_device, shape, dtype, ada, loc)
    before = groupnorm.group_norm.launches
    out = groupnorm.group_norm(x, w, bias, swish=swish, **kw)
    torch.cuda.synchronize()
    assert groupnorm.group_norm.launches == before + 1
    assert out.dtype == dtype
    ref = groupnorm.group_norm_plain(x, w, bias, swish=swish, **kw).float()
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()

    sums = groupnorm.gn_channel_sums(x)
    for got, want in zip(sums, groupnorm.gn_channel_sums_plain(x)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-3


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    w = torch.ones(64, device=cuda_device)
    x = torch.zeros(1, 64, 8, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        groupnorm.group_norm(x, w, w)
    x = torch.zeros(1, 64, 8, 16, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.group_norm(x, w, w)
    x = torch.zeros(1, 48, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="groups"):
        groupnorm.group_norm(x, w[:48], w[:48])
    x = torch.zeros(2, 64, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="AdaIN"):
        groupnorm.group_norm(x, w, w, ada_scale=torch.ones(3, 64, device=cuda_device),
                             ada_shift=torch.ones(3, 64, device=cuda_device))


# Backward on the card: dx bf16 one output rounding; fp32 and every parameter
# gradient, fp32 sums in another order. Relative to max |reference|.
TOL_BWD_CARD = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype,ada,swish",
    [
        ((2, 96, 37, 53), torch.bfloat16, None, True),
        ((2, 96, 37, 53), torch.bfloat16, "batched", True),
        ((2, 96, 37, 53), torch.float32, "shared", True),
        ((2, 96, 37, 53), torch.float32, None, False),
        ((2, 128, 64, 64), torch.bfloat16, "shared", True),
        ((3, 512, 16, 16), torch.bfloat16, None, False),
        ((2, 32, 5, 7), torch.float32, "batched", True),
    ],
)
def test_backward_kernels_match_plain_on_card(cuda_device, shape, dtype, ada, swish):
    x, w, bias, kw = _card_inputs(cuda_device, shape, dtype, ada, loc=0.5)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    grad = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    mean, rstd = groupnorm.group_stats_plain(x, 32, 1e-6)
    before = groupnorm.group_norm_backward.launches
    got = groupnorm.group_norm_backward(grad, x, mean, rstd, w, bias, swish=swish, **kw)
    torch.cuda.synchronize()
    assert groupnorm.group_norm_backward.launches == before + 1
    ref = groupnorm.group_norm_backward_plain(grad, x, mean, rstd, w, bias, swish=swish, **kw)
    assert got[0].dtype == dtype
    for name, a, r in zip(("dx", "dw", "db", "ds", "dt"), got, ref):
        if r is None:
            assert a is None
            continue
        tol = TOL_BWD_CARD[dtype] if name == "dx" else 1e-4
        assert (a.float() - r.float()).abs().max().item() <= tol * r.abs().max().item(), name


# (shape, groups) on the pixel-split plan on the card: 65 channels a group
# (n 8², 16² and 5·7, ragged), 130 a group, and GroupNorm(1, 2048) at n = 16 and 1.
CARD_SPLIT_CASES = [((2, 2080, 8, 8), 32), ((2, 2080, 16, 16), 32), ((3, 2080, 5, 7), 32),
                    ((2, 4160, 24, 24), 32), ((2, 2048, 4, 4), 1), ((2, 2048, 1, 1), 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", CARD_SPLIT_CASES,
                         ids=["x".join(map(str, s)) + f"-G{g}" for s, g in CARD_SPLIT_CASES])
def test_pixel_split_plan_matches_plain_on_card(cuda_device, shape, groups, dtype):
    """Groups that no cluster cuts on channel boundaries, on the pixel-split plan:
    the forward (one launch) and the backward (one launch) with AdaIN [B, C] and
    swish against the plain versions, and two calls of each bit-identical."""
    b, c, h, w = shape
    itemsize = torch.tensor([], dtype=dtype).element_size()
    assert groupnorm._bwd_plan(b, c, groups, h * w, itemsize).split
    x, wt, bias, kw = _card_inputs(cuda_device, shape, dtype, "batched", loc=0.5)
    args = (x, wt, bias, groups, 1e-6, kw["ada_scale"], kw["ada_shift"], True)
    before = (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches)
    first = groupnorm._forward(*args, with_stats=True)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    grad = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    mean, rstd = groupnorm.group_stats_plain(x, groups, 1e-6)
    bargs = (grad, x, mean, rstd, wt, bias, kw["ada_scale"], kw["ada_shift"], True)
    dfirst = groupnorm._backward_kernel(*bargs)
    torch.cuda.synchronize()
    assert (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches) == (
        before[0] + 1, before[1] + 1)
    second = groupnorm._forward(*args, with_stats=True)
    dsecond = groupnorm._backward_kernel(*bargs)
    torch.cuda.synchronize()
    for u, v in zip(first + dfirst, second + dsecond):
        assert torch.equal(u, v)
    ref = groupnorm.group_norm_plain(x, wt, bias, groups, swish=True, **kw).float()
    tol = TOL_FWD_CARD[dtype]
    assert (first[0].float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    for got, want in zip(first[1:], (mean, rstd)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    got = groupnorm.group_norm_backward(grad, x, mean, rstd, wt, bias, swish=True, **kw)
    ref = groupnorm.group_norm_backward_plain(grad, x, mean, rstd, wt, bias, swish=True, **kw)
    for name, u, r in zip(("dx", "dw", "db", "ds", "dt"), got, ref):
        tol = TOL_BWD_CARD[dtype] if name == "dx" else 1e-4
        assert (u.float() - r.float()).abs().max().item() <= tol * r.abs().max().item(), name


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups", [((5, 64, 8, 8), 32), ((5, 2080, 8, 8), 32)],
                         ids=["warp-plan", "pixel-split"])
def test_batch_blocks_on_card(cuda_device, monkeypatch, shape, groups):
    """A grid past the limit (cut here to 64 CTAs) runs as one launch a batch
    block, forward and backward, with each block's rows of x, the [B, C] AdaIN,
    the saved statistics and the per-plane sums: the plain versions' results."""
    monkeypatch.setattr(groupnorm, "_MAX_GRID", 64)
    b, c, h, w = shape
    x, wt, bias, kw = _card_inputs(cuda_device, shape, torch.float32, "batched", loc=0.5)
    blocks = (len(groupnorm._batch_blocks(b, groups, groupnorm._fwd_plan(b, c, groups, h * w, 4))),
              len(groupnorm._batch_blocks(b, groups, groupnorm._bwd_plan(b, c, groups, h * w, 4))))
    assert min(blocks) > 1
    before = (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches)
    out, mean, rstd = groupnorm._forward(x, wt, bias, groups, 1e-6, kw["ada_scale"],
                                         kw["ada_shift"], True, with_stats=True)
    grad = torch.randn(shape, device=cuda_device)
    got = groupnorm.group_norm_backward(grad, x, mean, rstd, wt, bias, swish=True, **kw)
    torch.cuda.synchronize()
    assert (groupnorm.group_norm.launches - before[0],
            groupnorm.group_norm_backward.launches - before[1]) == blocks
    ref = groupnorm.group_norm_plain(x, wt, bias, groups, swish=True, **kw)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    for u, r in zip((mean, rstd), groupnorm.group_stats_plain(x, groups, 1e-6)):
        assert (u - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    ref = groupnorm.group_norm_backward_plain(grad, x, mean, rstd, wt, bias, swish=True, **kw)
    for u, r in zip(got, ref):
        assert (u - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.mark.gpu
def test_backward_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    x, w, bias, _ = _card_inputs(cuda_device, (2, 64, 8, 8), torch.float32, None)
    mean, rstd = groupnorm.group_stats_plain(x, 32, 1e-6)
    for bad_mean, bad_rstd in ((mean[:1], rstd[:1]), (mean, rstd[:, :16]), (mean.cpu(), rstd)):
        with pytest.raises(ValueError, match="mean and rstd"):
            groupnorm.group_norm_backward(x, x, bad_mean, bad_rstd, w, bias)
    with pytest.raises(ValueError, match="g must be"):
        groupnorm.group_norm_backward(x.bfloat16(), x, mean, rstd, w, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_on_card_saves_kernel_statistics_and_launches_the_backward(cuda_device, dtype):
    """Autograd through group_norm on the card: a grad_fn, one forward launch, one
    backward launch, and the gradients of the plain backward from the plain
    statistics."""
    x, w, bias, kw = _card_inputs(cuda_device, (2, 64, 24, 40), dtype, "batched", loc=1.0)
    x, w = x.requires_grad_(), w.requires_grad_()
    kw = {k: v.requires_grad_() for k, v in kw.items()}
    before = (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches)
    out = groupnorm.group_norm(x, w, bias, swish=True, **kw)
    assert out.grad_fn is not None
    grad = torch.randn(out.shape, device=cuda_device).to(dtype)
    out.backward(grad)
    torch.cuda.synchronize()
    assert (groupnorm.group_norm.launches, groupnorm.group_norm_backward.launches) == (
        before[0] + 1, before[1] + 1)
    mean, rstd = groupnorm.group_stats_plain(x.detach(), 32, 1e-6)
    ref = groupnorm.group_norm_backward_plain(
        grad, x.detach(), mean, rstd, w.detach(), bias, swish=True,
        **{k: v.detach() for k, v in kw.items()})
    for name, a, r in zip(("dx", "dw", "ds", "dt"), (x.grad, w.grad, kw["ada_scale"].grad,
                                                      kw["ada_shift"].grad),
                          (ref[0], ref[1], ref[3], ref[4])):
        tol = TOL_BWD_CARD[dtype] if name == "dx" else 1e-4
        assert (a.float() - r.float()).abs().max().item() <= tol * r.abs().max().item(), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(PLAN_FORMS))
def test_backward_kernel_plan_forms_match_plain_on_card(cuda_device, monkeypatch, form, dtype):
    """Each plan form against the plain backward; two calls bit-identical."""
    shape, plan = _plan_form(monkeypatch, form, itemsize=torch.tensor([], dtype=dtype)
                             .element_size())
    x, w, bias, kw = _card_inputs(cuda_device, shape, dtype, "batched", loc=0.5)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    grad = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    mean, rstd = groupnorm.group_stats_plain(x, 32, 1e-6)
    args = (grad, x, mean, rstd, w, bias, kw["ada_scale"], kw["ada_shift"], True)
    first = groupnorm._backward_kernel(*args)
    second = groupnorm._backward_kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    ref = groupnorm._backward_plain(*args)
    for name, a, r in zip(("dx", "s1", "s2"), first, ref):
        tol = TOL_BWD_CARD[dtype] if name == "dx" else 1e-4
        assert (a.float() - r.float()).abs().max().item() <= tol * r.abs().max().item(), name


# (shape, plan) that the kernel refuses: a cluster size that is not a power of
# two; slices of 1.5 planes (cpg 3); shared memory that is not the resident
# part's; more shared memory than a block has (fp32, cpg 2, 128² whole).
REFUSED_PLANS = {
    "cluster-3": ((2, 96, 8, 8), groupnorm.BwdPlan(3, 64, 64, 512)),
    "slice-straddles": ((2, 96, 8, 8), groupnorm.BwdPlan(2, 96, 96, 768)),
    "smem-mismatch": ((2, 64, 8, 8), groupnorm.BwdPlan(1, 128, 128, 512)),
    "smem-too-large": ((2, 64, 128, 128), groupnorm.BwdPlan(1, 32768, 32768, 262144)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bad", list(REFUSED_PLANS))
def test_backward_wrapper_raises_on_a_plan_the_kernel_refuses(cuda_device, monkeypatch, bad):
    shape, plan = REFUSED_PLANS[bad]
    x, w, bias, _ = _card_inputs(cuda_device, shape, torch.float32, None)
    mean, rstd = groupnorm.group_stats_plain(x, 32, 1e-6)
    monkeypatch.setattr(groupnorm, "_bwd_plan", lambda *args: plan)
    before = groupnorm.group_norm_backward.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        groupnorm.group_norm_backward(x, x, mean, rstd, w, bias)
    assert groupnorm.group_norm_backward.launches == before
    # The refusal leaves no error behind for the library's next launch.
    groupnorm.group_norm(x, w, bias)
    torch.cuda.synchronize()


# Forward on the card, relative to max |reference|: bf16 one output rounding;
# fp32 (and the saved statistics) sums in another order.
TOL_FWD_CARD = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,loc", [(torch.float32, 0.0), (torch.float32, 30.0),
                                       (torch.bfloat16, 0.0)], ids=["fp32", "fp32-loc30", "bf16"])
@pytest.mark.parametrize("form", list(FWD_PLAN_FORMS))
def test_forward_kernel_plan_forms_match_plain_on_card(cuda_device, monkeypatch, form, dtype,
                                                       loc):
    """Each plan form (the warp plan, cluster sizes 1-16, streamed slices, cpg 1,
    2 and 4, a ragged n) against the plain forward, the saved mean and rstd against
    ``group_stats_plain``, and two calls bit-identical. At B = 48 the grid's
    1536 clusters outnumber those the card holds at once: they run in waves."""
    shape, plan = _fwd_plan_form(monkeypatch, form, itemsize=torch.tensor([], dtype=dtype)
                                 .element_size(), batch=48)
    x, w, bias, kw = _card_inputs(cuda_device, shape, dtype, "batched", loc=loc)
    args = (x, w, bias, 32, 1e-6, kw["ada_scale"], kw["ada_shift"], True)
    before = groupnorm.group_norm.launches
    first = groupnorm._forward(*args, with_stats=True)
    second = groupnorm._forward(*args, with_stats=True)
    torch.cuda.synchronize()
    assert groupnorm.group_norm.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    ref = groupnorm.group_norm_plain(x, w, bias, swish=True, **kw).float()
    tol = TOL_FWD_CARD[dtype]
    assert (first[0].float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    for got, want in zip(first[1:], groupnorm.group_stats_plain(x, 32, 1e-6)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype,loc",
    [((2, 128, 512, 512), torch.bfloat16, 0.0), ((2, 256, 256, 256), torch.float32, 30.0),
     ((8, 64, 16, 16), torch.bfloat16, 0.0), ((2, 32, 64, 64), torch.float32, 0.0)],
    ids=["streamed-bf16", "streamed-fp32-loc30", "cpg2-16x16", "cpg1"],
)
def test_forward_kernel_saves_the_group_statistics_on_card(cuda_device, shape, dtype, loc):
    """At full-size plans (streamed 2 MiB groups, the SR UNet's 2 channels a
    group, 1 channel a group): the output and the saved [B, G] mean and rstd."""
    x, w, bias, kw = _card_inputs(cuda_device, shape, dtype, "shared", loc=loc)
    out, mean, rstd = groupnorm._forward(x, w, bias, 32, 1e-6, kw["ada_scale"], kw["ada_shift"],
                                         True, with_stats=True)
    torch.cuda.synchronize()
    assert mean.shape == rstd.shape == (shape[0], 32) and mean.dtype == torch.float32
    ref = groupnorm.group_norm_plain(x, w, bias, swish=True, **kw).float()
    tol = TOL_FWD_CARD[dtype]
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    for got, want in zip((mean, rstd), groupnorm.group_stats_plain(x, 32, 1e-6)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# (shape, plan) that the forward kernel refuses, as REFUSED_PLANS for the
# backward; the shared memory is x's alone.
FWD_REFUSED_PLANS = {
    "cluster-3": ((2, 96, 8, 8), groupnorm.FwdPlan(3, 64, 64, 256)),
    "slice-straddles": ((2, 96, 8, 8), groupnorm.FwdPlan(2, 96, 96, 384)),
    "smem-mismatch": ((2, 64, 8, 8), groupnorm.FwdPlan(1, 128, 128, 1024)),
    "smem-too-large": ((2, 64, 256, 256), groupnorm.FwdPlan(1, 131072, 131072, 524288)),
    "warp-too-large": ((2, 64, 32, 32), groupnorm.FwdPlan(0, 2048, 2048, 0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bad", list(FWD_REFUSED_PLANS))
def test_forward_wrapper_raises_on_a_plan_the_kernel_refuses(cuda_device, monkeypatch, bad):
    shape, plan = FWD_REFUSED_PLANS[bad]
    x, w, bias, _ = _card_inputs(cuda_device, shape, torch.float32, None)
    with monkeypatch.context() as m:
        m.setattr(groupnorm, "_fwd_plan", lambda *args, **kw: plan)
        before = groupnorm.group_norm.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            groupnorm.group_norm(x, w, bias)
        assert groupnorm.group_norm.launches == before
    # The refusal leaves no error behind for the library's next launch.
    out = groupnorm.group_norm(x, w, bias)
    torch.cuda.synchronize()
    ref = groupnorm.group_norm_plain(x, w, bias)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
