"""The port's data parallel (``eovax_torch.parallel``) on 2 gloo ranks on the CPU.

Two processes of ``tests/_torch_dp_worker.py`` (a file store under the test's
directory, one torch thread each, every rank killed after 180 s) each take
their half of one global batch; the same scenario functions run in this
process without a group on the whole batch as the reference, and the JAX
package's modules on the 8-device CPU mesh of ``tests/conftest.py`` as the
second one. The tiny VAE (ch 32, ch_mult (1, 2), 4 bands, 32²) starts from
JAX variables drawn from numpy and carried over by
``state_dict_from_variables``.

- ``place_batch``'s leaf rules against ``global_batch_from_local``'s; a batch
  whose rows differ across ranks is refused on every rank.
- ``LatentBatchNorm``: output rows, running statistics (the unbiased update
  with the global count) and the input gradient through the all-reduce against
  one process (1e-6) and the JAX module under ``jit`` on the mesh (1e-5).
- ``make_train_step``, 3 steps: with the posterior sampled and the latent noise
  on against one process (rtol 1e-5); on the posterior's mode against the JAX
  step on the mesh at ``tests/test_torch_train.py``'s tolerances. Both ranks'
  parameters are ``torch.equal``.
- ``make_adversarial_steps``, 2 steps with EOPatchLoss over the
  DynamicPatchGAN: the adaptive weight, both players' parameters, u and σ.
- The SR ``train_step``, 3 steps, and ``validate``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as dpw
import test_torch_gan as tg
from eovax.core import config as jcfg
from eovax.losses import EOConsistencyLoss as JaxLoss
from eovax.nn.latent import LatentBatchNorm as JaxBN
from eovax.parallel import mesh as jmesh
from eovax.train import stage2 as jstage2
from eovax_torch.core import config as tcfg
from eovax_torch.losses import gan
from eovax_torch.models.unet import UNet
from eovax_torch.nn.init import init_parameters
from eovax_torch.parallel import mesh
from eovax_torch.utils.convert import state_dict_from_variables

WORLD, ROWS = 2, 8
# 2 ranks against one process: the same float32 arithmetic but the batch sums
# taken in halves (the BatchNorm statistics, the losses' means, the gradients'
# all-reduce), through ~20 conv layers and STEPS Adam updates.
RTOL, ATOL = 1e-5, 1e-7
# Parameters after a few Adam updates: Adam moves an entry by about lr a step
# whatever its gradient's size, so where the gradient is a sum that cancels
# (the hypernetwork stems, the biases before one-channel GroupNorm groups),
# the round-off of either side sets much of its step: every entry within 2·Σlr
# and all but a thousandth of them within a hundredth of Σlr, as
# tests/test_torch_train.py holds the port against JAX; the losses and
# gradient norms (sums over every entry) at RTOL; the ranks bit for bit.
PARAM_FAR_SHARE = 1e-3
# The stage-2 steps' learning rates (a cosine from BASE_LR down over 10 steps).
LR_SUM = dpw.STEPS * dpw.BASE_LR
BN_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_BN_TOL = dict(rtol=1e-5, atol=1e-5)
# The JAX step on the mesh: tests/test_torch_train.py's tolerances for logs, and
# for parameters every entry within 2·Σlr, all but a thousandth within a
# hundredth of Σlr (entries whose true gradient is 0 move by ±lr a step).
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_model():
    return tg._jax_vae(tg._cfg(jcfg))


def _spec() -> dict:
    g = np.random.default_rng(0)
    _, variables = _jax_model()
    disc = gan.DynamicPatchGAN(ndf=16, n_layers=2, wv_planes=32)
    init_parameters(disc, torch.Generator().manual_seed(1))
    unet = UNet(**dpw.UNET_KW)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.from_numpy(g.normal(0.0, 0.1, p.shape).astype(np.float32)))
    return {
        "variables": state_dict_from_variables(variables),
        "image": g.standard_normal((ROWS, 4, 32, 32)).astype(np.float32),
        "disc": disc.state_dict(),
        "unet": unet.state_dict(),
        "sr_hr": g.standard_normal((ROWS, 16, 16, 4)).astype(np.float32),
        "sr_lr": g.standard_normal((ROWS, 16, 16, 4)).astype(np.float32),
        "bn_x": (g.standard_normal((ROWS, 16, 4, 4)) * 2 + 0.5).astype(np.float32),
        "bn_w": g.standard_normal((ROWS, 16, 4, 4)).astype(np.float32),
        "bn_a": g.standard_normal(16).astype(np.float32),
        "bn_c": g.standard_normal(16).astype(np.float32),
        "bn_mean": g.standard_normal(16).astype(np.float32),
        "bn_var": g.uniform(0.5, 2.0, 16).astype(np.float32),
        "scenarios": ["latent_bn", "unequal_rows", "stage2_sampled", "stage2_mode",
                      "adversarial", "sr"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 2 ranks' results, one process's); the ranks run while this process
    computes its own."""
    spec = _spec()
    tmp = tmp_path_factory.mktemp("dp")
    spawned = dpw.start(spec, tmp, WORLD)  # the ranks run while this process computes
    one = dpw.run({**spec, "scenarios": [s for s in spec["scenarios"] if s != "unequal_rows"]},
                  0, 1)
    return dpw.finish(*spawned), one


def _close(got, ref, rtol=RTOL, atol=ATOL, label=""):
    torch.testing.assert_close(torch.as_tensor(got), torch.as_tensor(ref), rtol=rtol, atol=atol,
                               msg=lambda m: f"{label}: {m}")


def _assert_adam_close(got: dict, ref: dict, lr_sum: float, label: str) -> None:
    """Parameters after Adam updates whose learning rates sum to ``lr_sum``."""
    far = total = 0
    for name, value in ref.items():
        if not value.is_floating_point() or name.endswith(("running_mean", "running_var")):
            continue
        diff = (got[name] - value).abs()
        assert diff.max().item() <= 2 * lr_sum, (label, name, diff.max().item())
        far += int((diff > 1e-2 * lr_sum).sum())
        total += diff.numel()
    assert far <= PARAM_FAR_SHARE * total, (label, far, total)


def _assert_ranks_equal(ranks, key):
    for name, value in ranks[0][key].items():
        assert torch.equal(value, ranks[1][key][name]), (key, name)


# -- the mesh's rules ---------------------------------------------------------------------


@pytest.mark.parametrize("leaves", [
    {"image": (8, 4, 4, 3), "wvs": (3,)},
    {"image": (8, 4, 4, 3), "norm_mean": (8, 3), "wvs": (3,), "scale": ()},
    {"image": (8, 4, 4, 3), "label": (8,)},
    {"wvs": (3,), "weights": (3,)},
], ids=["image-wvs", "descriptors-scalar", "per-sample-1d", "unknown-1d"])
def test_place_batch_keeps_the_jax_leaf_rules(leaves):
    """Placed like ``global_batch_from_local`` (wvs and scalars replicated, ndim ≥ 2
    this rank's rows), or refused by both for an unknown 1-D leaf."""
    g = np.random.default_rng(1)
    batch = {k: g.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
    refused = any(len(s) == 1 and k != "wvs" for k, s in leaves.items())
    jm = jmesh.make_mesh()
    if refused:
        with pytest.raises(ValueError, match="1-D batch leaf"):
            jmesh.global_batch_from_local(batch, jm)
        with pytest.raises(ValueError, match="1-D batch leaf"):
            mesh.place_batch(batch, mesh.make_mesh("cpu"))
        return
    ref = jmesh.global_batch_from_local(batch, jm)
    got = mesh.place_batch(batch, mesh.make_mesh("cpu"))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(mesh.local_numpy(v), jmesh.local_numpy(ref[k]))


def test_mesh_without_a_group_is_one_process():
    m = mesh.make_mesh("cpu")
    assert (m.device, m.rank, m.world_size) == (torch.device("cpu"), 0, 1)
    assert mesh.REPLICATED_BATCH_KEYS == jmesh.REPLICATED_BATCH_KEYS
    assert not mesh.init_distributed("cpu") and not mesh.grouped()  # no launch: a no-op
    g0, g1 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(mesh.global_rows(lambda s: torch.randn(s, generator=g0), (4, 2)),
                       torch.randn((4, 2), generator=g1))
    x = torch.randn(3)
    assert mesh.all_sum(x) is x and mesh.rank_mean(x) is x and mesh.rank_max(x) is x
    logs = {"a": x[0], "b": 0.5}
    assert mesh.mean_over_ranks(logs) is logs and mesh.any_rank(True)


@pytest.mark.parametrize("shuffle, drop_remainder", [(True, True), (False, False)])
def test_sen2naip_batches_split_each_global_batch_by_rank(shuffle, drop_remainder):
    """The SR CLI's data: process r of R holds rows [r·b, (r + 1)·b) of each
    global batch of R·b, the batches of one process at R·b (a short last
    batch split evenly, or dropped where it cannot be)."""
    from eovax_torch.data.sen2naip import _epoch_batches

    def batches(n, b, **kw):
        return list(_epoch_batches(list(range(n)), b, shuffle=shuffle, seed=5,
                                   drop_remainder=drop_remainder, repeat=False,
                                   make_batch=list, **kw))

    for n in (14, 13):  # a short last global batch of 2 rows, then of 1
        one = batches(n, 6)
        ranks = [batches(n, 3, process_index=r, process_count=2) for r in range(2)]
        assert [a + b for a, b in zip(*ranks, strict=True)] == [
            g for g in one if len(g) % 2 == 0]
        assert all(len(a) == len(b) for a, b in zip(*ranks))


def test_unequal_rows_are_refused_on_every_rank(runs):
    ranks, _ = runs
    for r in ranks:
        assert "every rank must hold the same number of rows" in r["unequal_rows"]


# -- the latent BatchNorm -----------------------------------------------------------------


def test_latent_batchnorm_uses_global_statistics(runs):
    """2 ranks against one process on the 8 rows: outputs, running statistics
    (the unbiased update with n = 8·4·4, not 4·4·4) and the input gradient."""
    ranks, one = runs
    ref = one["latent_bn"]
    _close(torch.cat([r["latent_bn"]["y"] for r in ranks]), ref["y"], **BN_TOL, label="y")
    _close(torch.cat([r["latent_bn"]["grad"] for r in ranks]), ref["grad"], **BN_TOL,
           label="grad")
    for r in ranks:
        for key in ("running_mean", "running_var"):
            _close(r["latent_bn"][key], ref[key], **BN_TOL, label=key)
        assert r["latent_bn"]["count"] == 1
    assert torch.equal(ranks[0]["latent_bn"]["running_var"], ranks[1]["latent_bn"]["running_var"])


def test_latent_batchnorm_matches_jax_on_the_mesh(runs):
    """The JAX module under ``jit`` on the global batch sharded over the 8-device
    mesh: XLA's global statistics, and the gradient of the same loss."""
    ranks, _ = runs
    spec = _spec()
    x = jnp.asarray(spec["bn_x"].transpose(0, 2, 3, 1))
    w = jnp.asarray(spec["bn_w"].transpose(0, 2, 3, 1))
    a, c = jnp.asarray(spec["bn_a"]), jnp.asarray(spec["bn_c"])
    stats = {"batch_stats": {"mean": jnp.asarray(spec["bn_mean"]),
                             "var": jnp.asarray(spec["bn_var"])}}
    bn = JaxBN(16)

    def f(x):
        y, new = bn.apply(stats, x, use_running_average=False, mutable=["batch_stats"])
        loss = (y * w).sum() + (new["batch_stats"]["mean"] * a).sum() + (
            new["batch_stats"]["var"] * c).sum()
        return loss, (y, new["batch_stats"])

    jm = jmesh.make_mesh()
    assert jm.shape[jmesh.DATA_AXIS] == 8
    grad, (y, new) = jax.jit(jax.grad(f, has_aux=True))(jmesh.shard_batch(x, jm))
    _close(torch.cat([r["latent_bn"]["y"] for r in ranks]),
           np.array(y).transpose(0, 3, 1, 2), **JAX_BN_TOL, label="y")
    _close(torch.cat([r["latent_bn"]["grad"] for r in ranks]),
           np.array(grad).transpose(0, 3, 1, 2), **JAX_BN_TOL, label="grad")
    _close(ranks[0]["latent_bn"]["running_mean"], np.array(new["mean"]), **JAX_BN_TOL)
    _close(ranks[0]["latent_bn"]["running_var"], np.array(new["var"]), **JAX_BN_TOL)


# -- the stage-2 step --------------------------------------------------------------------


def test_stage2_step_with_a_sampled_posterior_matches_one_process(runs):
    ranks, one = runs
    ref = one["stage2_sampled"]
    for r in ranks:
        for log, ref_log in zip(r["stage2_sampled"]["logs"], ref["logs"], strict=True):
            assert sorted(log) == sorted(ref_log)
            for k in log:
                _close(log[k], ref_log[k], label=k)
        _assert_adam_close(r["stage2_sampled"]["final"], ref["final"], LR_SUM, "stage2")
        for key in ("bn.running_mean", "bn.running_var"):  # of the moved parameters' latents
            _close(r["stage2_sampled"]["final"][key], ref["final"][key], **TOL, label=key)
    _assert_ranks_equal([r["stage2_sampled"] for r in ranks], "final")


def _jax_mesh_trajectory():
    """STEPS JAX steps on the 8 rows sharded over the 8-device mesh."""
    jm, variables = _jax_model()
    cfg, loss = tg._cfg(jcfg), JaxLoss(rec_loss_type="char")
    tx, schedule = jstage2.make_optimizer(cfg, total_steps=10)
    step = jax.jit(functools.partial(
        jstage2.make_train_step(jm.core, loss, tx, cfg, schedule=schedule), scale=None,
        angle=None))
    m = jmesh.make_mesh()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jmesh.replicate(jstage2.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params)), m)
    x = jmesh.shard_batch(jnp.asarray(_spec()["image"].transpose(0, 2, 3, 1)), m)
    wvs = jmesh.replicate(jnp.asarray(dpw.WVS), m)
    logs = []
    for _ in range(dpw.STEPS):
        state, log = step(state, x, wvs, jax.random.PRNGKey(0))
        logs.append({k: float(v) for k, v in log.items()})
    final = {"params": state.params, "batch_stats": state.batch_stats}
    return logs, state_dict_from_variables(jax.tree_util.tree_map(np.asarray, final))


def test_stage2_step_on_two_ranks_matches_jax_on_the_mesh(runs):
    ranks, one = runs
    jlogs, jfinal = _jax_mesh_trajectory()
    start = state_dict_from_variables(_jax_model()[1])
    tr = ranks[0]["stage2_mode"]
    for log, jlog in zip(tr["logs"], jlogs, strict=True):
        assert sorted(log) == sorted(jlog)
        for k in jlog:
            np.testing.assert_allclose(log[k], jlog[k], **TOL, err_msg=k)
    _assert_adam_close(tr["final"], jfinal, LR_SUM, "against JAX")
    for key in ("bn.running_mean", "bn.running_var"):
        torch.testing.assert_close(tr["final"][key], jfinal[key], **TOL)
    assert any(not torch.equal(v, start[k]) for k, v in tr["final"].items())
    _assert_ranks_equal([r["stage2_mode"] for r in ranks], "final")
    _assert_adam_close(tr["final"], one["stage2_mode"]["final"], LR_SUM, "against one process")


# -- the adversarial step and the SR step ------------------------------------------------------


def test_adversarial_steps_match_one_process(runs):
    """The adaptive weight (the ranks' kernel gradients averaged before their
    norms), both players' parameters and the spectral-norm u and σ."""
    ranks, one = runs
    ref = one["adversarial"]
    for r in ranks:
        got = r["adversarial"]
        for log, ref_log in zip(got["logs"], ref["logs"], strict=True):
            assert sorted(log) == sorted(ref_log)
            for k in log:
                _close(log[k], ref_log[k], label=k)
        assert all(log["train/disc_weight"] > 0 for log in got["logs"])
        for key in ("final", "disc"):
            _assert_adam_close(got[key], ref[key], 2 * dpw.BASE_LR, key)
        for name in ("final.u", "final.sigma"):
            _close(got["disc"][name], ref["disc"][name], label=name)
    for key in ("final", "disc"):
        _assert_ranks_equal([r["adversarial"] for r in ranks], key)


def test_sr_steps_and_validation_match_one_process(runs):
    """t, the noise and the validation's x1 drawn over the global batch."""
    ranks, one = runs
    ref = one["sr"]
    for r in ranks:
        _close(r["sr"]["losses"], ref["losses"], label="losses")
        _close(r["sr"]["val"]["val_mse"], ref["val"]["val_mse"], label="val_mse")
        _assert_adam_close(r["sr"]["final"], ref["final"], sum(ref["lrs"]), "sr")
    _assert_ranks_equal([r["sr"] for r in ranks], "final")
    assert ranks[0]["sr"]["val"] == ranks[1]["sr"]["val"]
