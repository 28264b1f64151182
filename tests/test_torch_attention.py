"""The port's attention wrapper against the JAX package's flash kernel.

``flash_attention_plain`` is what the port computes on the CPU; here it is
held against ``eovax.kernels.attention.flash_attention`` run in Pallas
interpret mode, and its backward against ``jax.vjp`` of ``sdpa_auto``, which
is what the JAX trainer differentiates. The tests marked ``gpu`` hold the
CUDA kernel against ``flash_attention_plain`` on the card, and the port's
backward through the model on the card against the CPU, and skip without
one. They import no JAX, so the card's machine runs them without it:

    python -m pytest tests/test_torch_attention.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from eovax_torch.kernels import attention, build

# fp32 on both sides, online softmax vs one-shot softmax: the tolerance of
# the JAX package's own kernel test.
TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(b, s, d, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal((b, s, d), dtype=np.float32) for _ in range(3)]


# (B, S, D) of the permutation cases: S ≤ D, and (2, 100, 128) and (2, 300, 512)
# end in a partial key tile.
PERMUTATION_SHAPES = [(1, 64, 64), (2, 100, 128), (1, 512, 512), (2, 300, 512)]


def permutation_qkv(b, s, d, device, seed=0):
    """bf16 q, k, v whose attention is a row permutation of v, and that permutation of v.

    K is the first S rows of the identity and Q = c·K[π] for a random
    permutation π of each batch row, with c the power of two that makes the
    logit gap c/√D at least 30. V is bounded away from zero (|v| ≥ 1/4), so
    the weight softmax leaves on the other keys (below e^-30 each) stays far
    below half a bf16 ulp of every output, and the output is V[π] exactly.
    """
    rng = np.random.default_rng(seed)
    c = 2.0 ** np.ceil(np.log2(30.0 * np.sqrt(d)))
    eye = np.eye(s, d, dtype=np.float32)
    perm = np.stack([rng.permutation(s) for _ in range(b)])
    v = rng.standard_normal((b, s, d), dtype=np.float32)
    arrays = (c * eye[perm], np.repeat(eye[None], b, axis=0), v + np.copysign(np.float32(0.25), v))
    q, k, v = (torch.from_numpy(a).to(device, torch.bfloat16) for a in arrays)
    return q, k, v, v[torch.arange(b)[:, None], torch.from_numpy(perm).to(device)]


@pytest.mark.parametrize("s,d,block", [(256, 64, 128), (512, 128, 256), (1024, 512, 512)])
def test_plain_matches_jax_flash_kernel(s, d, block):
    import jax.numpy as jnp

    from eovax.kernels.attention import flash_attention as jax_flash_attention

    q, k, v = _qkv(2, s, d)
    ref = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=block, block_k=block, interpret=True,
    )
    out = attention.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,s,d", [(2, 100, 64), (1, 256, 512)])
def test_backward_matches_jax_sdpa_auto(b, s, d):
    """fp32 (dq, dk, dv) against autodiff of the JAX package's plain attention."""
    import jax
    import jax.numpy as jnp

    from eovax.kernels.attention import sdpa_auto

    q, k, v = _qkv(b, s, d, seed=2)
    g = np.random.default_rng(3).standard_normal((b, s, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: sdpa_auto(*a, precision=jax.lax.Precision.HIGHEST),
                     *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = attention.flash_attention_backward.calls
    out = attention.flash_attention(*inputs)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    assert attention.flash_attention_backward.calls == before + 1
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_backward_rounds_probabilities_to_the_compute_dtype_before_dv():
    """bf16: dV = (P in bf16)ᵀ·dO, as sdpa_auto rounds probs to v's dtype."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 40, 64, seed=4))
    do = torch.ones(1, 40, 64, dtype=torch.bfloat16)
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2) / 8.0, dim=-1)
    _, _, dv = attention.flash_attention_backward(q, k, v, do)
    assert dv.dtype == torch.bfloat16
    torch.testing.assert_close(dv, p.to(torch.bfloat16).transpose(-1, -2) @ do, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_plain_path_without_launch(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 100, 64, seed=1))
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v)
    assert attention.flash_attention.launches == before
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out, attention.flash_attention_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("b,s,d", PERMUTATION_SHAPES)
def test_permutation_inputs_are_one_hot_in_the_plain_version(b, s, d):
    """The premise of the card's permutation test, on the CPU: the plain
    version (fp32 softmax, one rounding) gives V[π] exactly."""
    q, k, v, expected = permutation_qkv(b, s, d, "cpu")
    assert torch.equal(attention.flash_attention(q, k, v), expected)


def test_non_cpu_non_cuda_tensor_raises():
    q = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.flash_attention(q, q, q)


@pytest.mark.parametrize("shape,inside", [
    ((2, 64, 64), True), ((2, 64, 128), True), ((2, 64, 256), True), ((2, 64, 512), True),
    ((2, 64, 96), False), ((2, 64, 32), False), ((2, 64, 1024), True), ((1, 16, 768), True),
    ((65535, 16, 64), True), ((65536, 16, 64), False), ((2, 64, 520), False),
    ((2, 64, 576), True)])
def test_kernel_envelope_case_by_case(shape, inside):
    """D in (64, 128, 256, 512), or a multiple of 64 above 512 (the D-split
    kernel), and B at most 65535 (the kernel's grid y)."""
    assert attention.in_kernel_envelope(shape) == inside


@pytest.mark.parametrize("d", [96, 32, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_library_path_matches_jax_sdpa_auto(d, dtype):
    """The path the card takes at a width the kernel lacks: the inputs
    zero-padded to the next kernel width Dk, q scaled by √(Dk/D), the attention
    of the widened inputs (the plain version standing in for the kernel) less
    the padded columns, against the JAX package's attention at D. fp32: to the
    tolerance above; bf16: sdpa_auto rounds P to bf16 and q's scaled copy
    rounds once more here, then one output rounding (2e-2 of max |ref|)."""
    import jax.numpy as jnp

    from eovax.kernels.attention import sdpa_auto

    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v = _qkv(2, 80, d, seed=5)
    ref = np.asarray(sdpa_auto(*(jnp.asarray(a, jd) for a in (q, k, v))), np.float32)
    wide = attention.widened(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
    dk = next(w for w in attention.KERNEL_HEAD_DIMS if w >= d)
    assert all(t.shape == (2, 80, dk) and t.dtype == dtype for t in wide)
    assert attention.in_kernel_envelope(wide[0].shape)
    out = attention.flash_attention_plain(*wide)[..., :d]
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    else:
        assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_widened_leaves_kernel_widths_and_raises_above_them():
    """Kernel widths stay as they are, the D-split kernel's multiples of 64 above
    512 too; a D above 512 between them is zero-padded to the next multiple of 64
    with q unscaled (the D-split kernel takes the true D's scale), and no D
    raises."""
    q = torch.zeros(1, 4, 128)
    assert all(a is b for a, b in zip(attention.widened(q, q, q), (q, q, q)))
    q = torch.zeros(1, 4, 1024)
    assert all(a is b for a, b in zip(attention.widened(q, q, q), (q, q, q)))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 520, seed=6))
    wide = attention.widened(q, k, v)
    assert all(t.shape == (1, 4, 576) for t in wide)
    for t, ref in zip(wide, (q, k, v)):
        assert torch.equal(t[..., :520], ref) and not t[..., 520:].any()


def _replay_d_split(q, k, v, chunk=512, tile=64):
    """The D-split kernel in plain PyTorch (fp32): D zero-padded to a multiple of
    64; for each chunk of ``chunk`` output columns and each tile of ``tile`` keys,
    the logits accumulated over d in pieces of ``chunk`` columns and scaled by
    the true D's 1/√D, the online softmax (running max and sum), and the chunk's
    O += P·V; then O divided by the row sums, less the padded columns."""
    b, s, d = q.shape
    dp = -(-d // 64) * 64
    q, k, v = (torch.nn.functional.pad(t.float(), (0, dp - d)) for t in (q, k, v))
    scale = 1.0 / d ** 0.5
    out = torch.empty(b, s, dp)
    for c0 in range(0, dp, chunk):
        m = torch.full((b, s, 1), -torch.inf)
        l_sum = torch.zeros(b, s, 1)
        acc = torch.zeros(b, s, min(chunk, dp - c0))
        for j0 in range(0, s, tile):
            logits = torch.zeros(b, s, min(tile, s - j0))
            for d0 in range(0, dp, chunk):
                logits += q[..., d0:d0 + chunk] @ k[:, j0:j0 + tile, d0:d0 + chunk].transpose(1, 2)
            logits = logits * scale
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ v[:, j0:j0 + tile, c0:c0 + chunk]
            m = m_new
        out[..., c0:c0 + chunk] = acc / l_sum
    return out[..., :d]


@pytest.mark.parametrize("d", [520, 640, 1024])
def test_d_split_matches_jax_sdpa_auto(d):
    """Above D = 512, in fp32: the port's attention (the plain version on the CPU)
    and the D-split kernel's arithmetic replayed in PyTorch (logits over D in
    pieces of 512, output in chunks of 512 columns, 1/√D of the true D) against
    the JAX package's ``sdpa_auto``, to the tolerance above."""
    import jax.numpy as jnp

    from eovax.kernels.attention import sdpa_auto

    q, k, v = _qkv(2, 150, d, seed=7)
    ref = np.asarray(sdpa_auto(*map(jnp.asarray, (q, k, v))))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(attention.flash_attention(*t).numpy(), ref, **TOL)
    np.testing.assert_allclose(_replay_d_split(*t).numpy(), ref, **TOL)


def test_attn_block_at_640_channels_matches_jax():
    """The port's ``AttnBlock`` over a 640-channel latent (D = 640: the D-split
    kernel's width on the card) against the JAX package's, with the JAX block's
    variables perturbed by N(0, 0.05) and carried across by
    ``state_dict_from_variables``; fp32, other summation orders over 640
    channels: within 1e-5 of max |reference|."""
    import jax
    import jax.numpy as jnp

    from eovax.nn import blocks as jb
    from eovax_torch.nn import blocks as tb
    from eovax_torch.utils.convert import state_dict_from_variables

    x = np.random.default_rng(8).standard_normal((2, 640, 6, 7)).astype(np.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    jmod = jb.AttnBlock(in_channels=640)
    noise = np.random.default_rng(9)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + noise.normal(0.0, 0.05, a.shape)).astype(np.float32),
        jmod.init(jax.random.PRNGKey(0), xj))
    ref = np.transpose(np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), xj)),
                       (0, 3, 1, 2))
    block = tb.AttnBlock(640)
    block.load_state_dict(state_dict_from_variables(variables), strict=True)
    with torch.no_grad():
        out = block.eval()(torch.from_numpy(x)).numpy()
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_kernel_library_is_keyed_by_source_hash():
    lib = build.library_path(attention.SOURCE)
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("flash_attention_") and lib.suffix == ".so"
    assert (build.CSRC / attention.SOURCE).exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s,d,dtype,tol",
    [
        (4, 4096, 512, torch.bfloat16, 2e-2),
        (16, 1024, 512, torch.bfloat16, 2e-2),
        (3, 1037, 512, torch.bfloat16, 2e-2),
        (2, 200, 64, torch.bfloat16, 2e-2),
        # the wgmma kernel's tile edges: one key, one query and key tile short
        # of full, one past it, two past; D = 256 with a partial last tile
        (2, 1, 512, torch.bfloat16, 2e-2),
        (2, 63, 512, torch.bfloat16, 2e-2),
        (2, 65, 512, torch.bfloat16, 2e-2),
        (2, 129, 512, torch.bfloat16, 2e-2),
        (2, 1000, 256, torch.bfloat16, 2e-2),
        (2, 1037, 512, torch.float32, 1e-4),
        (2, 77, 128, torch.float32, 1e-4),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, b, s, d, dtype, tol):
    """bf16: output rounding and P rounded to bf16 before P·V; fp32: another
    summation order. Both relative to max |reference|."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(b, s, d, generator=g, device=cuda_device, dtype=dtype)
               for _ in range(3))
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    assert out.dtype == dtype
    ref = attention.flash_attention_plain(q, k, v).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", PERMUTATION_SHAPES)
def test_kernel_permutation_is_exact(cuda_device, b, s, d):
    """One-hot softmax: the output is V[π] bit for bit. This pins the Q, K
    and V descriptors (LBO, SBO, the k-step offsets, each warpgroup's half of
    D), the register-P fragments of P·V and the fences."""
    q, k, v, expected = permutation_qkv(b, s, d, cuda_device)
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    assert torch.equal(out, expected)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,dtype,launches", [(2, 96, torch.bfloat16, 1),
                                                (2, 96, torch.float32, 1),
                                                (2, 32, torch.bfloat16, 1),
                                                (65537, 64, torch.bfloat16, 2)],
                         ids=["96-bf16", "96-fp32", "32-bf16", "batch-past-the-grid"])
def test_outside_the_envelope_widens_for_the_kernel_on_card(cuda_device, b, d, dtype, launches):
    """A width the kernel lacks (padded to the next) and a batch past its grid
    (two launches): the kernel computes each, one count a launch, within the
    card's tolerances of the plain version."""
    s = 16 if b > 2 else 300
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(b, s, d, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + launches
    ref = attention.flash_attention_plain(q, k, v).float()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,dtype", [
    (2, 77, 520, torch.bfloat16), (2, 77, 520, torch.float32), (3, 333, 640, torch.bfloat16),
    (2, 129, 640, torch.float32), (1, 1037, 1024, torch.bfloat16), (2, 65, 1024, torch.float32),
    (1, 257, 2048, torch.bfloat16), (1, 33, 2048, torch.float32)])
def test_d_split_kernel_matches_plain_on_card(cuda_device, b, s, d, dtype):
    """D above 512 on the D-split kernel (D = 520 padded to 576; 640, 1024 and
    2048 as they are), odd S: one launch, within the card's tolerances of the
    plain version (bf16 2e-2, fp32 1e-4 of max |reference|)."""
    g = torch.Generator(device=cuda_device).manual_seed(d + s)
    q, k, v = (torch.randn(b, s, d, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    ref = attention.flash_attention_plain(q, k, v).float()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    """Operand errors raise; a width the kernels lack is widened for them
    (``test_outside_the_envelope_widens_for_the_kernel_on_card``), and D above
    512 goes to the D-split kernel (``test_d_split_kernel_matches_plain_on_card``)."""
    q = torch.zeros(1, 64, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        attention.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 128, device=cuda_device, dtype=torch.bfloat16)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("policy_name,tol", [("fp32", 1e-3), ("bf16", 1e-1)])
def test_tiny_model_on_card_launches_kernel_and_matches_cpu(cuda_device, policy_name, tol):
    """reconstruct on the card against the same weights on the CPU: two
    kernel launches (encoder and decoder mid blocks). fp32: other summation
    orders; bf16: bf16 activations between layers. Relative to max |ref|."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.core import config
    from eovax_torch.core.precision import FULL_PRECISION, policy_from_name

    stem = config.StemConfig(num_layers=1, wv_planes=32)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    cfg = config.VAEConfig(encoder=config.EncoderConfig(**kw), decoder=config.DecoderConfig(**kw))
    cpu = EOFluxVAE(cfg, policy=FULL_PRECISION, device="cpu", seed=0)
    card = EOFluxVAE(cfg, cpu.core.state_dict(), policy=policy_from_name(policy_name))
    x = np.random.default_rng(0).standard_normal((2, 4, 40, 40)).astype(np.float32)
    wvs = [0.665, 0.56, 0.49, 0.842]
    before = attention.flash_attention.launches
    out = card.reconstruct(x, wvs).float().cpu()
    assert attention.flash_attention.launches == before + 2
    ref = cpu.reconstruct(x, wvs)
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_backward_on_card_has_grad_fn_and_matches_the_cpu(cuda_device, dtype, tol):
    """The kernel's output carries the backward, which launches the three
    backward kernels and no tensor-op backward; its gradients match the tensor-op
    backward on the CPU in fp32. bf16: P and dS rounded to bf16. Relative to max
    |reference|."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(2, 333, 512, generator=g, device=cuda_device).to(dtype)
               .requires_grad_() for _ in range(3))
    counters = ((attention.flash_attention, "launches"),
                (attention.flash_attention_backward, "launches"),
                (attention.flash_attention_backward, "calls"))
    before = [getattr(f, name) for f, name in counters]
    out = attention.flash_attention(q, k, v)
    assert out.grad_fn is not None
    do = torch.randn(out.shape, generator=g, device=cuda_device).to(dtype)
    out.backward(do)
    torch.cuda.synchronize()
    assert [getattr(f, name) - n for (f, name), n in zip(counters, before)] == [1, 3, 0]
    refs = attention.flash_attention_backward(*(t.detach().float().cpu() for t in (q, k, v)),
                                              do.float().cpu())
    for got, ref in zip((q.grad, k.grad, v.grad), refs):
        assert (got.float().cpu() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("policy_name,tol", [("fp32", 1e-3), ("bf16", 1e-1)])
def test_tiny_model_backward_on_card_matches_cpu(cuda_device, policy_name, tol):
    """backward() through EOVAECore in train mode on the card against the same
    weights on the CPU in fp32: every conv3x3 data gradient on the kernel, every
    GroupNorm backward on its kernels, each attention backward on its three
    kernels (no tensor-op backward), and the relative global norm of the
    difference of all parameter gradients within tol (fp32: other summation
    orders; bf16: bf16 activations and gradients between layers)."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.core import config
    from eovax_torch.core.precision import FULL_PRECISION, policy_from_name
    from eovax_torch.kernels import conv3x3, groupnorm
    from eovax_torch.nn.blocks import Conv3x3, GroupNorm

    stem = config.StemConfig(num_layers=1, wv_planes=32, use_adain=True)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    cfg = config.VAEConfig(encoder=config.EncoderConfig(**kw), decoder=config.DecoderConfig(**kw))
    cpu = EOFluxVAE(cfg, policy=FULL_PRECISION, device="cpu", seed=0)
    card = EOFluxVAE(cfg, cpu.core.state_dict(), policy=policy_from_name(policy_name))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 40, 40))
                         .astype(np.float32))
    wvs = torch.tensor([0.665, 0.56, 0.49, 0.842])
    grads = []
    for model, device in ((cpu, "cpu"), (card, cuda_device)):
        before = (conv3x3.conv3x3_dx.launches, groupnorm.group_norm_backward.launches,
                  attention.flash_attention_backward.launches,
                  attention.flash_attention_backward.calls)
        recon, _ = model.core(x.to(device), wvs.to(device), sample_posterior=False, train=True)
        (recon.float() - x.to(device)).square().mean().backward()
        if device != "cpu":
            torch.cuda.synchronize()
            n_conv = sum(isinstance(m, Conv3x3) for m in model.core.modules())
            n_gn = sum(isinstance(m, GroupNorm) for m in model.core.modules())
            assert (conv3x3.conv3x3_dx.launches - before[0],
                    groupnorm.group_norm_backward.launches - before[1],
                    attention.flash_attention_backward.launches - before[2],
                    attention.flash_attention_backward.calls - before[3]) == (n_conv, n_gn, 6, 0)
        grads.append({n: p.grad.float().cpu() for n, p in model.core.named_parameters()})
    ref_norm = torch.sqrt(sum(g.square().sum() for g in grads[0].values()))
    diff_norm = torch.sqrt(sum((grads[1][n] - g).square().sum() for n, g in grads[0].items()))
    assert diff_norm.item() <= tol * ref_norm.item()
