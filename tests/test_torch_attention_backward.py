"""The attention backward from the forward's row statistics, against the JAX package.

On a CUDA tensor the port's attention saves each row's log-sum-exp (in log2
units) from the forward kernel, and its backward runs the hand kernels of
``csrc/flash_attention_bwd.cu``. Their arithmetic in tensor ops,
``flash_attention_lse_plain`` and ``flash_attention_backward_from_stats_plain``,
is held here against ``jax.nn.logsumexp`` of the scaled logits and against
``jax.vjp`` of ``sdpa_auto`` (what the JAX trainer differentiates), on
numpy-seeded fp32 inputs, within 1e-5 of max |reference|; so is the widening
of a width the kernels lack (D = 96 padded to 128 with q scaled by √(128/96),
its gradient narrowed by the chain rule), and at the tile edges of the
`wgmma` kernels that bf16 takes at D = 64 and 128 and of the cluster kernels it
takes at D = 256 and 512 (S = 63, 65, 127, 129).
``backward_kernels``, the wrapper's choice of kernels by dtype and width, is
held to its rule. The tests marked ``gpu`` hold the kernels against those plain
versions on the card and skip without one. They import no JAX:

    python -m pytest tests/test_torch_attention_backward.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from eovax_torch.kernels import attention

# fp32 on both sides; Δ from dO∘O where the autodiff sums dP∘P, other summation
# orders: within 1e-5 of max |reference|.
TOL_JAX = 1e-5
# On the card, kernel against plain version, relative to max |reference|: bf16
# (the inputs rounded alike; products in another order, P and dS rounded to bf16
# at other points of a tie) and fp32 (other summation orders).
TOL_CARD = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# (B, S, D): the kernels' widths, odd S (partial last tiles), and the D-split width.
SHAPES = [(2, 100, 64), (1, 77, 128), (2, 90, 256), (1, 65, 512), (1, 33, 640)]
# The tile edges of the wgmma kernels (D = 64, 128) and of the cluster kernels
# (D = 256, 512): 64-row tiles, 64 or 128 resident rows a block.
TILE_EDGES = [(1, s, d) for d in (64, 128, 256, 512) for s in (63, 65, 127, 129)]


def _inputs(b, s, d, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal((b, s, d), dtype=np.float32) for _ in range(4)]


def _assert_close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (err, scale)


def _jax_grads(q, k, v, g):
    import jax
    import jax.numpy as jnp

    from eovax.kernels.attention import sdpa_auto

    _, vjp = jax.vjp(lambda *a: sdpa_auto(*a, precision=jax.lax.Precision.HIGHEST),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(r) for r in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,s,d", SHAPES)
def test_lse_plain_matches_jax_logsumexp(b, s, d):
    """The row statistics: log-sum-exp of q kᵀ/√D, in log2 units."""
    import jax
    import jax.numpy as jnp

    q, k, v, _ = _inputs(b, s, d, seed=d + s)
    logits = jnp.einsum("bqd,bkd->bqk", jnp.asarray(q), jnp.asarray(k),
                        precision=jax.lax.Precision.HIGHEST) / np.sqrt(d)
    ref = np.asarray(jax.nn.logsumexp(logits, axis=-1)) * np.log2(np.e)
    got = attention.flash_attention_lse_plain(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (b, s)
    _assert_close(got.numpy(), ref, TOL_JAX)


@pytest.mark.parametrize("b,s,d", SHAPES)
def test_backward_from_stats_plain_matches_jax_vjp(b, s, d):
    """(dq, dk, dv) from o and lse against autodiff of the JAX package's attention."""
    q, k, v, g = _inputs(b, s, d, seed=d + s + 1)
    refs = _jax_grads(q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = attention.flash_attention_with_lse(*t[:3])
    grads = attention.flash_attention_backward_from_stats_plain(*t[:3], o, lse, t[3])
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.float32
        _assert_close(got.numpy(), ref, TOL_JAX)


@pytest.mark.parametrize("b,s,d", TILE_EDGES)
def test_backward_from_stats_plain_matches_jax_vjp_at_tile_edges(b, s, d):
    """The kernels' arithmetic at the edges of the wgmma kernels' tiles, against
    autodiff of the JAX package's attention."""
    q, k, v, g = _inputs(b, s, d, seed=d + s + 2)
    refs = _jax_grads(q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = attention.flash_attention_with_lse(*t[:3])
    grads = attention.flash_attention_backward_from_stats_plain(*t[:3], o, lse, t[3])
    for got, ref in zip(grads, refs):
        _assert_close(got.numpy(), ref, TOL_JAX)


@pytest.mark.parametrize("d,route", [(64, "wgmma"), (96, "wgmma"), (128, "wgmma"),
                                     (192, "cluster"), (256, "cluster"), (512, "cluster"),
                                     (640, "mma")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_backward_kernels_by_dtype_and_width(dtype, d, route):
    """bf16 takes the wgmma kernels where the call's kernel width is 64 or 128
    (D = 96 is widened to 128), the cluster kernels at 256 and 512 (D = 192 is
    widened to 256), the mma.sync kernels above 512; fp32 the FMA kernels at
    every width. Each route names three C entries."""
    want = route if dtype == torch.bfloat16 else "fma"
    assert attention.backward_kernels(dtype, d) == want
    assert len(attention._BACKWARD_PARTS[want]) == 3


@pytest.mark.parametrize("route,dtype,d,takes", [
    ("cluster", torch.bfloat16, 512, True), ("cluster", torch.bfloat16, 192, True),
    ("cluster", torch.bfloat16, 128, False), ("cluster", torch.float32, 256, False),
    ("cluster", torch.bfloat16, 640, False), ("wgmma", torch.bfloat16, 256, False),
    ("mma", torch.bfloat16, 512, True), ("mma", torch.float32, 64, False),
    ("fma", torch.float32, 512, True), ("fma", torch.bfloat16, 64, False)])
def test_route_takes(route, dtype, d, takes):
    """Which routes a caller may name for a width (the card compares the cluster
    kernels with the mma.sync kernels at D = 512); the chosen route always takes it."""
    assert attention.route_takes(route, dtype, d) is takes
    assert attention.route_takes(attention.backward_kernels(dtype, d), dtype, d)


def test_backward_kernels_refuse_other_dtypes():
    with pytest.raises(ValueError):
        attention.backward_kernels(torch.float16, 64)


@pytest.mark.parametrize("d,part", [(128, "dkdv"), (640, "dq"), (512, "dk")])
def test_backward_active_clusters_refuses_what_has_no_cluster_kernel(d, part):
    """Only the cluster kernels' widths (256, 512) and parts (dkdv, dq) have an
    occupancy to ask for; anything else raises before a library is built."""
    with pytest.raises(ValueError):
        attention.backward_active_clusters(d, part)


@pytest.mark.parametrize("d,width", [(96, 128), (32, 64)])
def test_widened_backward_matches_jax_vjp(d, width):
    """The card's path at a width the kernels lack, the plain version standing in
    for the kernels: q, k, v widened as the forward widens them (q scaled by
    √(width/D)), o and dO zero-padded, the gradients at the width narrowed by
    ``narrowed_gradients`` (dq times √(width/D)), against the JAX package's at D."""
    q, k, v, g = _inputs(2, 61, d, seed=d)
    refs = _jax_grads(q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o = attention.flash_attention_plain(*t[:3])
    wide = attention.widened_for_backward(*t[:3], o, t[3])
    assert all(w.shape == (2, 61, width) for w in wide)
    qw, kw, vw, ow, dow = wide
    assert attention.in_kernel_envelope(qw.shape)
    assert not ow[..., d:].any() and not dow[..., d:].any()
    lse = attention.flash_attention_lse_plain(qw, kw, vw)
    wide_grads = attention.flash_attention_backward_from_stats_plain(qw, kw, vw, ow, lse, dow)
    grads = attention.narrowed_gradients(*wide_grads, d)
    for got, ref in zip(grads, refs):
        assert got.shape == (2, 61, d)
        _assert_close(got.numpy(), ref, TOL_JAX)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_from_stats_plain_agrees_with_tensor_op_backward(dtype):
    """The two tensor-op backwards compute one gradient: fp32 to TOL_JAX; bf16,
    where one rounds dP and the other dS to bf16, within 2e-2 of max."""
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs(2, 90, 64, seed=11))
    o, lse = attention.flash_attention_with_lse(q, k, v)
    got = attention.flash_attention_backward_from_stats_plain(q, k, v, o, lse, g)
    ref = attention.flash_attention_backward(q, k, v, g)
    tol = TOL_JAX if dtype == torch.float32 else 2e-2
    for a, r in zip(got, ref):
        assert a.dtype == dtype
        _assert_close(a.float().numpy(), r.float().numpy(), tol)


def test_cpu_tensors_take_the_plain_versions_without_launch():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 40, 64, seed=12))
    before = (attention.flash_attention.launches, attention.flash_attention_backward.launches)
    o, lse = attention.flash_attention_with_lse(q, k, v)
    assert torch.equal(o, attention.flash_attention_plain(q, k, v))
    assert torch.equal(lse, attention.flash_attention_lse_plain(q, k, v))
    grads = attention.flash_attention_backward_from_stats(q, k, v, o, lse, g)
    refs = attention.flash_attention_backward_from_stats_plain(q, k, v, o, lse, g)
    assert all(torch.equal(a, r) for a, r in zip(grads, refs))
    assert (attention.flash_attention.launches,
            attention.flash_attention_backward.launches) == before


def test_backward_library_is_keyed_by_source_hash():
    from eovax_torch.kernels import build

    lib = build.library_path(attention.BACKWARD_SOURCE)
    assert lib.name.startswith("flash_attention_bwd_") and lib.suffix == ".so"
    assert (build.CSRC / attention.BACKWARD_SOURCE).exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(b, s, d, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, s, d, generator=g, device=device).to(dtype) for _ in range(4)]


def _rel(got, ref):
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def _backward_twice(q, k, v, o, lse, do):
    """Two backward calls; asserts their six launches, on the kernels of the
    route that ``backward_kernels`` names, and that both give the same bits."""
    route = attention.backward_kernels(q.dtype, q.shape[-1])
    before = attention.flash_attention_backward.launches
    attention.flash_attention_backward.kernels = {}
    grads = attention.flash_attention_backward_from_stats(q, k, v, o, lse, do)
    again = attention.flash_attention_backward_from_stats(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert attention.flash_attention_backward.launches == before + 6
    assert attention.flash_attention_backward.kernels == {
        part: 2 for part in attention._BACKWARD_PARTS[route]}
    for got, rep in zip(grads, again):
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got, rep)
    return grads


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(2, 333, 64), (2, 200, 128), (1, 130, 256), (2, 257, 512),
                                   (1, 100, 640), (1, 65, 1024), (3, 3, 64), *TILE_EDGES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_backward_kernels_match_plain_on_card(cuda_device, b, s, d, dtype):
    """The forward's row statistics against ``flash_attention_lse_plain`` and its
    output ``torch.equal`` with and without them; the three backward launches
    against ``flash_attention_backward_from_stats_plain`` on the same o and lse
    (TOL_CARD), and two calls bit-identical."""
    q, k, v, do = _card_inputs(b, s, d, dtype, cuda_device, seed=d + s)
    o, lse = attention.flash_attention_with_lse(q, k, v)
    assert torch.equal(o, attention.flash_attention(q, k, v))
    ref_lse = attention.flash_attention_lse_plain(q, k, v)
    assert _rel(lse, ref_lse) <= 1e-5
    grads = _backward_twice(q, k, v, o, lse, do)
    refs = attention.flash_attention_backward_from_stats_plain(q, k, v, o, lse, do)
    for got, ref in zip(grads, refs):
        assert _rel(got, ref) <= TOL_CARD[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("d", attention.CLUSTER_BACKWARD_WIDTHS)
@pytest.mark.parametrize("part", ["dkdv", "dq"])
def test_cluster_kernels_are_scheduled_on_card(cuda_device, d, part):
    """``cudaOccupancyMaxActiveClusters`` of each cluster plan: at least one cluster
    fits on the card (a launch raises where none does)."""
    assert attention.backward_active_clusters(d, part) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_backward_kernels_at_one_key_on_card(cuda_device, d, dtype):
    """S = 1: the softmax is 1, so dq and dk are 0 but for the two roundings of
    dP − Δ (dP = dO·v in the kernel, Δ = dO·o in its own launch, o = v): they are
    held within TOL_CARD of max(|ref|, 1) (|dO·v| is of order 1 here), dv = dO
    within TOL_CARD of it."""
    q, k, v, do = _card_inputs(3, 1, d, dtype, cuda_device, seed=d + 1)
    o, lse = attention.flash_attention_with_lse(q, k, v)
    grads = _backward_twice(q, k, v, o, lse, do)
    refs = attention.flash_attention_backward_from_stats_plain(q, k, v, o, lse, do)
    for got, ref in zip(grads, refs):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL_CARD[dtype] * max(ref.float().abs().max().item(), 1.0)
    assert _rel(grads[2], do) <= TOL_CARD[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,dtype,launches", [
    (2, 300, 96, torch.bfloat16, 3), (2, 300, 96, torch.float32, 3),
    (2, 300, 192, torch.bfloat16, 3), (2, 77, 520, torch.bfloat16, 3),
    (65537, 16, 64, torch.bfloat16, 5), (65537, 3, 128, torch.bfloat16, 5),
    (65537, 2, 512, torch.bfloat16, 5)],
    ids=["96-bf16", "96-fp32", "192-bf16", "520-bf16", "batch-past-the-grid",
         "batch-past-the-grid-128", "batch-past-the-grid-512"])
def test_autograd_outside_the_envelope_on_card(cuda_device, b, s, d, dtype, launches):
    """``backward()`` through ``flash_attention`` at a width the kernels lack and a
    batch past their grid: the kernels' launches exactly (Δ once, dK/dV and dQ a
    batch block), no tensor-op backward, and the gradients within TOL_CARD of the
    tensor-op backward on the same inputs."""
    q, k, v, do = _card_inputs(b, s, d, dtype, cuda_device, seed=d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attention.flash_attention_backward.launches, attention.flash_attention_backward.calls)
    attention.flash_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    assert (attention.flash_attention_backward.launches - before[0],
            attention.flash_attention_backward.calls - before[1]) == (launches, 0)
    refs = attention.flash_attention_backward(q.float(), k.float(), v.float(), do.float())
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == q.shape
        assert _rel(leaf.grad, ref) <= TOL_CARD[dtype]
