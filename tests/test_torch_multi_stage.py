"""The multi-stage decoder heads and the embeddings against the JAX package's,
in fp32 on the CPU.

The heads at the four variants of ``tests/test_multi_stage.py`` (64 wavelength
planes, embed 32, one generator layer, [2,16,16,32] in, 3 bands out) and the
embedding modules of ``tests/test_embeddings.py``, every JAX variable drawn
from numpy by the shapes of its traced init (``tests/test_torch_gan.py``'s
``_drawn``) and carried over by ``state_dict_from_variables`` with
``strict=True``.
"""

import numpy as np
import pytest
import torch

import test_torch_gan as tg
from eovax_torch.nn import embeddings as te
from eovax_torch.nn import multi_stage as tm
from eovax_torch.utils.convert import state_dict_from_variables

WVS = np.asarray([0.665, 0.56, 0.49], np.float32)
# A head: fp32 through 2-5 convs, GroupNorms and a small transformer, summed
# in other orders; relative to the largest entry.
TOL = 1e-5
HEADS = {
    "multi-stage": ("MultiStageDynamicDecoder", dict(num_shared_blocks=1)),
    "multi-stage-transformer": ("MultiStageDynamicDecoder",
                                dict(num_shared_blocks=1, use_enhanced_generator=False)),
    "stacked": ("StackedDynamicDecoder", dict(num_stack_layers=2)),
    "progressive": ("ProgressiveMultiStageDynamicDecoder", dict(num_stages=2)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got: torch.Tensor, ref) -> float:
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(got.shape)
    return (got.detach() - ref).abs().max().item() / ref.abs().max().item()


def _heads(name: str):
    import jax.numpy as jnp

    from eovax.nn import multi_stage as jm

    cls, kw = HEADS[name]
    kw = dict(wv_planes=64, embed_dim=32, num_layers=1, **kw)
    jhead, thead = getattr(jm, cls)(**kw), getattr(tm, cls)(**kw)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 32)).astype(np.float32)
    variables = tg._drawn(jhead, jnp.asarray(x), jnp.asarray(WVS), seed=1)
    thead.load_state_dict(state_dict_from_variables(variables), strict=True)
    return jhead, variables, thead.eval(), x


@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name):
    """The forward, its parameter and input gradients (of ⟨out, c⟩) and
    ``get_distillation_weight`` (torch layout [N, E, K, K] and [N])."""
    import jax
    import jax.numpy as jnp

    jhead, variables, thead, x = _heads(name)
    wvs = jnp.asarray(WVS)
    cot = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32)

    def jloss(params, xx):
        out = jhead.apply({"params": params}, xx, wvs)
        return jnp.sum(out * cot), out

    (_, ref), (jgrads, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    xt = tg._nchw(x).requires_grad_(True)
    out = thead(xt, torch.from_numpy(WVS))
    assert out.shape == (2, 3, 16, 16)
    assert _rel(out.permute(0, 2, 3, 1), ref) <= TOL
    (out * tg._nchw(cot)).sum().backward()
    # Parameter gradients against the largest entry of any: the biases into a
    # GroupNorm of one channel a group have a true gradient of 0 (round-off on
    # both sides), and the stacked head's inner generators' fc_bias none at all.
    grads = state_dict_from_variables({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    scale = max(g.abs().max().item() for g in grads.values())
    for key, p in thead.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert (got - grads[key].reshape(p.shape)).abs().max().item() <= TOL * scale, key
    assert _rel(xt.grad.permute(0, 2, 3, 1), jdx) <= TOL
    with torch.no_grad():
        weight, bias = thead.get_distillation_weight(torch.from_numpy(WVS))
    jw, jb = jhead.apply(variables, wvs, method=type(jhead).get_distillation_weight)
    assert tuple(weight.shape) == (3, 32, 3, 3) and tuple(bias.shape) == (3,)
    assert _rel(weight, jw) <= TOL and _rel(bias, jb) <= TOL


@pytest.mark.parametrize("name", list(HEADS))
def test_head_seeded_init_is_finite_and_deterministic_in_eval_mode(name):
    """``init_parameters`` gives every head finite outputs; in eval mode the
    forward is deterministic (the JAX package's dropout needs a dropout RNG)."""
    from eovax_torch.nn.init import init_parameters

    cls, kw = HEADS[name]
    head = getattr(tm, cls)(wv_planes=64, embed_dim=32, num_layers=1, **kw)
    init_parameters(head, torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 16, 16, generator=torch.Generator().manual_seed(1))
    head.eval()
    with torch.no_grad():
        a, b = head(x, torch.from_numpy(WVS)), head(x, torch.from_numpy(WVS))
    assert torch.isfinite(a).all() and torch.equal(a, b)


# -- the embeddings -----------------------------------------------------------------------------


@pytest.mark.parametrize("dim,flip,shift,scale", [(128, False, 1.0, 1.0), (64, True, 0.0, 2.0),
                                                  (33, False, 1.0, 1.0)])
def test_timestep_embedding_matches_jax(dim, flip, shift, scale):
    """``get_timestep_embedding`` and ``Timesteps`` (odd width zero-padded):
    within 1e-6 plus 4 ulps of the argument (XLA's fp32 sin/cos and exp differ
    from torch's in the last bits, as for the SR UNet's embedding)."""
    import jax.numpy as jnp

    from eovax.nn import embeddings as je

    t = np.asarray([0.0, 1.0, 17.5, 999.0], np.float32)
    kw = dict(flip_sin_to_cos=flip, downscale_freq_shift=shift, scale=scale)
    ref = np.asarray(je.get_timestep_embedding(jnp.asarray(t), dim, **kw))
    got = te.get_timestep_embedding(torch.from_numpy(t), dim, **kw)
    assert got.shape == ref.shape == (4, dim)
    atol = 1e-6 + 4 * np.spacing(np.float32(999.0 * scale))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)
    assert torch.equal(te.Timesteps(dim, **kw)(torch.from_numpy(t)), got)
    with pytest.raises(ValueError, match="1d"):
        te.get_timestep_embedding(torch.zeros(2, 2), dim)


@pytest.mark.parametrize("act,post,cond,out_dim", [("silu", "silu", 8, None),
                                                   ("gelu", None, None, 12),
                                                   ("mish", "relu", None, None)])
def test_timestep_embedding_mlp_matches_jax(act, post, cond, out_dim):
    import jax.numpy as jnp

    from eovax.nn import embeddings as je

    g = np.random.default_rng(3)
    sample = g.standard_normal((2, 16)).astype(np.float32)
    condition = g.standard_normal((2, 8)).astype(np.float32) if cond else None
    kw = dict(act_fn=act, post_act_fn=post, cond_proj_dim=cond, out_dim=out_dim)
    jmod = je.TimestepEmbedding(time_embed_dim=32, **kw)
    args = (jnp.asarray(sample),) + ((jnp.asarray(condition),) if cond else ())
    variables = tg._drawn(jmod, *args)
    tmod = te.TimestepEmbedding(16, 32, **kw)
    tmod.load_state_dict(state_dict_from_variables(variables), strict=True)
    ref = np.asarray(jmod.apply(variables, *args))
    got = tmod(torch.from_numpy(sample), None if condition is None else torch.from_numpy(condition))
    assert got.shape == ref.shape == (2, out_dim or 32)
    assert _rel(got, ref) <= TOL
    if cond:
        assert tmod.cond_proj.bias is None
    else:
        with pytest.raises(ValueError, match="cond_proj_dim"):
            tmod(torch.from_numpy(sample), torch.zeros(2, 8))


@pytest.mark.parametrize("h,w", [(3, 4), (4, 4), (6, 6), (1, 5)])
def test_relative_position_index_is_the_jax_index_bit_for_bit(h, w):
    from eovax.nn.embeddings import _relative_position_index

    ours, ref = te._relative_position_index(h, w), _relative_position_index(h, w)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("window,grid", [(4, (3, 4, 4)), (4, (1, 6, 6)), ((2, 3), (2, 2, 5))])
def test_relative_position_bias_matches_jax(window, grid):
    """A drawn table, read at its own window and extrapolated to a larger grid
    (the −1e7 sentinel beyond the table), bit for bit: a gather and a pad."""
    import jax

    from eovax.nn import embeddings as je

    jmod = je.RelativePositionBias(window_size=window, num_heads=2)
    win = (window, window) if isinstance(window, int) else window
    shapes = jax.eval_shape(lambda key: jmod.init(key, (1, *win)), jax.random.PRNGKey(0))
    g = np.random.default_rng(5)
    variables = jax.tree_util.tree_map(
        lambda s: g.normal(0.0, 0.02, s.shape).astype(np.float32), shapes)
    tmod = te.RelativePositionBias(window, num_heads=2)
    tmod.load_state_dict(state_dict_from_variables(variables), strict=True)
    ref = np.asarray(jmod.apply(variables, grid))
    got = tmod(grid)
    b, h, w = grid
    assert got.shape == ref.shape == (b * 2, h * w, h * w)
    assert np.array_equal(got.detach().numpy(), ref)
    assert (got.min().item() == -(10.0**7)) == (grid[1:] != tuple(win))
    with pytest.raises(NotImplementedError):
        tmod((1, win[0] - 1, win[1]))
    fresh = te.RelativePositionBias(window, num_heads=2)
    assert not fresh.relative_bias_table.any()  # zero-initialised, as in JAX


@pytest.mark.parametrize("shape,states", [((8, 16), (2, 8, 16)), ((6, 2, 4), (1, 8, 6))])
def test_learned_positional_embedding_matches_jax(shape, states):
    import jax.numpy as jnp

    from eovax.nn import embeddings as je

    x = np.random.default_rng(4).standard_normal(states).astype(np.float32)
    jmod = je.LearnedPositionalEmbedding(embeds_shape=shape)
    variables = tg._drawn(jmod, jnp.asarray(x))
    tmod = te.LearnedPositionalEmbedding(shape)
    tmod.load_state_dict(state_dict_from_variables(variables), strict=True)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    assert np.array_equal(tmod(torch.from_numpy(x)).detach().numpy(), ref)
    with pytest.raises(ValueError, match="does not match"):
        tmod(torch.zeros(states[0], states[1], states[2] + 1))


def test_nn_package_reexports_the_embeddings():
    import eovax_torch.nn as nn_pkg

    for name in ("LearnedPositionalEmbedding", "RelativePositionBias", "TimestepEmbedding",
                 "Timesteps", "get_timestep_embedding"):
        assert getattr(nn_pkg, name) is getattr(te, name)
