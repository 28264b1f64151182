"""The port's stage-2 losses against the JAX package's, value and gradient.

The same numpy inputs (NCHW here, NHWC there) go through each loss of
``eovax_torch.losses`` and ``eovax.losses`` in fp32 on the CPU; the gradient
with respect to the reconstruction is held against ``jax.grad``. The JAX
MS-SSIM runs its blur at ``Precision.HIGHEST``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eovax.losses import consistency as jcons
from eovax.losses import ffl as jffl
from eovax.losses import msssim as jmsssim
from eovax_torch.losses import consistency, ffl, msssim

# fp32 on both sides: reductions over ~10⁵ elements in other orders.
TOL = dict(rtol=1e-5, atol=1e-6)
# Gradients: per element, relative to the largest.
GRAD_TOL = 1e-4


def _pair(shape=(2, 4, 96, 96), seed=0, noise=0.5):
    g = np.random.default_rng(seed)
    target = g.standard_normal(shape).astype(np.float32)
    pred = (target + noise * g.standard_normal(shape)).astype(np.float32)
    return pred, target


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _check(torch_fn, jax_fn, pred, target):
    p = torch.from_numpy(pred).requires_grad_()
    value = torch_fn(p, torch.from_numpy(target))
    value.backward()
    ref, ref_grad = jax.value_and_grad(lambda a: jax_fn(a, _nhwc(target)))(_nhwc(pred))
    np.testing.assert_allclose(value.item(), float(ref), **TOL)
    ref_grad = np.transpose(np.asarray(ref_grad), (0, 3, 1, 2))
    assert np.abs(p.grad.numpy() - ref_grad).max() <= GRAD_TOL * np.abs(ref_grad).max()


@pytest.mark.parametrize("name", ["charbonnier_loss", "l1_loss", "sam_loss",
                                  "gradient_difference_loss", "berhu_loss",
                                  "spatial_gradient_loss"])
def test_pixel_losses_match_jax(name):
    pred, target = _pair((2, 5, 24, 20), seed=1)
    _check(getattr(consistency, name), getattr(jcons, name), pred, target)


@pytest.mark.parametrize("shape,noise", [((2, 4, 96, 96), 0.5), ((1, 12, 83, 97), 0.2),
                                         ((2, 3, 96, 96), 2.0)],
                         ids=["square", "odd-sides", "low-similarity"])
def test_msssim_matches_jax(shape, noise):
    pred, target = _pair(shape, seed=2, noise=noise)
    hi = jax.lax.Precision.HIGHEST
    _check(msssim.msssim_loss, lambda a, b: jmsssim.msssim_loss(a, b, precision=hi), pred, target)


def test_msssim_rejects_inputs_too_small_for_five_scales():
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="> 64px"):
        msssim.multiscale_ssim(x, x)


@pytest.mark.parametrize("kw", [dict(patch_factor=2, log_matrix=True, batch_matrix=True),
                                dict(patch_factor=1), dict(patch_factor=2, ave_spectrum=True,
                                                           alpha=2.0)],
                         ids=["consistency-loss", "plain", "ave-spectrum-alpha2"])
def test_focal_frequency_loss_matches_jax(kw):
    pred, target = _pair((2, 3, 32, 48), seed=3)
    _check(lambda a, b: ffl.focal_frequency_loss(a, b, **kw),
           lambda a, b: jffl.focal_frequency_loss(a, b, **kw), pred, target)


ALL_TERMS = dict(pixel_weight=1.0, rec_loss_type="char", spectral_weight=0.3, spatial_weight=0.2,
                 freq_weight=0.5, msssim_weight=0.7, spectral_start_step=10,
                 spatial_start_step=20, freq_start_step=30, msssim_start_step=40)


@pytest.mark.parametrize("step", [0, 15, 25, 30, 530, 1030, 5000])
def test_consistency_loss_gates_and_ffl_warm_in_match_jax(step):
    """Every term, below and above each start step, across the FFL warm-in."""
    pred, target = _pair((2, 4, 96, 96), seed=4)
    wvs = np.asarray([0.49, 0.56, 0.665, 0.842], np.float32)
    ours, ref = consistency.EOConsistencyLoss(**ALL_TERMS), jcons.EOConsistencyLoss(**ALL_TERMS)
    p = torch.from_numpy(pred).requires_grad_()
    total, logs = ours(torch.from_numpy(target), torch.from_numpy(wvs), p, global_step=step)
    total.backward()

    def jax_total(a):
        return ref(_nhwc(target), jnp.asarray(wvs), a, global_step=step)

    (ref_total, ref_logs), ref_grad = jax.value_and_grad(jax_total, has_aux=True)(_nhwc(pred))
    assert sorted(logs) == sorted(ref_logs)
    for key, value in ref_logs.items():
        np.testing.assert_allclose(logs[key].item(), float(value), **TOL, err_msg=key)
        assert not logs[key].requires_grad
    np.testing.assert_allclose(total.item(), float(ref_total), **TOL)
    ref_grad = np.transpose(np.asarray(ref_grad), (0, 3, 1, 2))
    assert np.abs(p.grad.numpy() - ref_grad).max() <= GRAD_TOL * np.abs(ref_grad).max()
    expected_w = 0.5 * min(max((step - 30) / 1000, 0.0), 1.0)
    assert logs["train/ffl_weight"].item() == pytest.approx(expected_w)


def test_consistency_loss_l1_and_feature_term_match_jax():
    """The L1 pixel term and a feature callable (here a fixed linear map), with
    the input branch taken without gradient as in the JAX package."""
    pred, target = _pair((2, 3, 16, 16), seed=5)
    wvs = np.asarray([0.49, 0.56, 0.665], np.float32)
    m = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)
    kw = dict(rec_loss_type="l1", feature_weight=0.4, feature_start_step=0)

    def torch_features(x, _):
        tokens = x.flatten(2).transpose(1, 2)  # [B, N, C]
        return [tokens @ torch.from_numpy(m), torch.tanh(tokens)]

    def jax_features(x, _):
        tokens = x.reshape(x.shape[0], -1, x.shape[-1])
        return [tokens @ jnp.asarray(m), jnp.tanh(tokens)]

    ours = consistency.EOConsistencyLoss(dofa_features=torch_features, **kw)
    ref = jcons.EOConsistencyLoss(dofa_features=jax_features, **kw)
    p = torch.from_numpy(pred).requires_grad_()
    total, logs = ours(torch.from_numpy(target), torch.from_numpy(wvs), p, split="val")
    total.backward()
    (ref_total, ref_logs), ref_grad = jax.value_and_grad(
        lambda a: ref(_nhwc(target), jnp.asarray(wvs), a, split="val"), has_aux=True)(
        _nhwc(pred))
    assert sorted(logs) == sorted(ref_logs) == ["val/loss_feature", "val/loss_rec",
                                                "val/loss_total"]
    np.testing.assert_allclose(total.item(), float(ref_total), **TOL)
    ref_grad = np.transpose(np.asarray(ref_grad), (0, 3, 1, 2))
    assert np.abs(p.grad.numpy() - ref_grad).max() <= GRAD_TOL * np.abs(ref_grad).max()


def test_from_dict_reads_the_reference_config():
    d = {"_target_": "eo_vae.models.modules.consistency_loss.EOConsistencyLoss",
         "rec_loss_type": "char", "pixel_weight": 1.0, "msssim_weight": 1.0,
         "msssim_start_step": 2000}
    assert consistency.EOConsistencyLoss.from_dict(d) == consistency.EOConsistencyLoss(
        rec_loss_type="char", msssim_weight=1.0, msssim_start_step=2000)
    with pytest.raises(ValueError, match="Unknown loss"):
        consistency.EOConsistencyLoss.from_dict({"_target_": "other.Loss"})
    with pytest.raises(ValueError, match="rec_loss_type"):
        consistency.EOConsistencyLoss(rec_loss_type="l2")(torch.zeros(1, 1, 4, 4), None,
                                                          torch.zeros(1, 1, 4, 4))
