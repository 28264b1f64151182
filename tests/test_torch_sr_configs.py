"""The shipped SR configurations in the port against the JAX package, in fp32 on the CPU.

Each ``configs_superres/*.yaml`` is built by both packages'
``build_denoiser_from_config``: the port's UNet loads the JAX package's init of
the same file with ``strict=True`` and holds as many parameters, and both
build the same denoiser and schedule. One Karras train step of
``pixel.yaml``'s denoiser, narrowed to widths (32, 16) × one block a level, on
4-band [2,4,32,32] pixels with a 4-band condition, is held against the JAX
trainer's step; t and the noise are the JAX key's draws, injected into the
port. ``reference_latent_stats`` is held equal to the JAX package's for every
name in its JSON.

The card case mirrors ``chip_smoke.py`` phase 19 (a)'s gradient check and
needs no JAX:

    python -m pytest tests/test_torch_sr_configs.py -m gpu --noconftest
"""

import concurrent.futures
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from eovax_torch.cli.train_super_res import build_denoiser_from_config
from eovax_torch.core.config import load_yaml
from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
from eovax_torch.data.sen2naip import reference_latent_stats
from eovax_torch.train.sr import DiffusionSuperRes
from eovax_torch.utils.convert import state_dict_from_variables

ROOT = Path(__file__).resolve().parents[1]
SR_CONFIGS = ["eo_vae_latent.yaml", "eo_vae_latent_batch.yaml", "flux_vae_latent.yaml",
              "pixel.yaml"]
STATS_NAMES = sorted(json.loads((ROOT / "eovax_torch" / "data" / "latent_stats.json")
                                .read_text()))
B, HW, BANDS = 2, 32, 4
# The narrowed pixel step: the losses at rtol 1e-5 (fp32 through the UNet in
# other summation orders); the parameters after the step per tensor within 1e-4
# of the tensor's largest entry plus 1e-6 (tests/test_torch_sr_train.py's TOL),
# those whose true gradient is 0 within 2·lr (Adam moves them by ±lr on the sign
# of their round-off).
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-6)
STEP_LR = 1e-3
# A key whose t draws lie inside [0.2, 0.9], where the Karras weight 1/c_out²
# stays below 11 under VP (the parity tests' range; test_torch_sr_train.py holds
# the ends apart).
STEP_KEY = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lm(name: str) -> dict:
    return load_yaml(str(ROOT / "configs_superres" / name))["lightning_module"]


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _narrow_pixel_lm() -> dict:
    lm = copy.deepcopy(_lm("pixel.yaml"))
    lm["denoiser"]["backbone"].update(hid_channels=[32, 16], hid_blocks=[1, 1])
    return lm


def _backbone_key(lm: dict) -> str:
    return json.dumps(lm["denoiser"]["backbone"], sort_keys=True)


def _jax_build(lm: dict, *, init: bool = False, **kw):
    """The JAX package's ``build_denoiser_from_config`` on a config block: its
    denoiser, its params' shapes (``ShapeDtypeStruct``) and, with ``init``, its
    params. Without ``init`` the function is traced only (``jax.eval_shape``);
    with it, jitted whole and compiled at XLA's lowest backend optimization
    level, which nearly halves the compile of the ~280 initializers (the values
    are only loaded, not compared)."""
    import jax

    from eovax.cli.train_super_res import build_denoiser_from_config as jax_build

    built = {}

    def params_of():
        built["denoiser"], params = jax_build(lm, **kw)
        return params

    if not init:
        shapes = jax.eval_shape(params_of)
        return built["denoiser"], shapes, None
    compiled = jax.jit(params_of).lower().compile({"xla_backend_optimization_level": 0})
    params = jax.tree_util.tree_map(np.asarray, compiled())
    return built["denoiser"], jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params), params


def _random_params(params, seed: int):
    """Every leaf from a numpy seed (the shipped init zeroes ``conv2``, ``proj``
    and ``conv_out``): GroupNorm scales 1 + N(0, 0.1), the rest N(0, 0.1)."""
    import jax

    g = np.random.default_rng(seed)

    def draw(path, a):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + g.normal(0.0, 0.1, a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _jax_step() -> dict:
    """One step of the JAX trainer on ``pixel.yaml``'s denoiser, narrowed, from
    numpy-drawn parameters: its inputs, its draws (t from the first half of its
    key, the noise from the second), its loss and its parameters after the step."""
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import FULL_PRECISION as JAX_FULL
    from eovax.parallel.mesh import make_mesh
    from eovax.train.sr import DiffusionSuperRes as JaxSR

    lm = _narrow_pixel_lm()
    jden, shapes, _ = _jax_build(lm, policy=JAX_FULL)
    params = _random_params(shapes, seed=0)
    g = np.random.default_rng(1)
    hr, lr = (g.standard_normal((B, HW, HW, BANDS)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(STEP_KEY)
    t_key, n_key = jax.random.split(key)
    jtrainer = JaxSR(denoiser=jden, init_params=params, sampler_steps=2, base_lr=STEP_LR,
                     grad_clip=_clip("pixel.yaml"), mesh=make_mesh(jax.devices()[:1]))
    jstate, jlogs = jtrainer._train_step(jtrainer.init_state(), jnp.asarray(hr),
                                         jnp.asarray(lr), key)
    return dict(lm=lm, params=params, hr=hr, lr=lr,
                t=np.array(jax.random.uniform(t_key, (B,))),
                eps=np.array(jax.random.normal(n_key, hr.shape, jnp.float32)),
                loss=float(jlogs["train_loss"]),
                final=state_dict_from_variables({"params": jax.tree_util.tree_map(
                    np.asarray, jstate.params)}))


def _clip(name: str) -> float:
    return load_yaml(str(ROOT / "configs_superres" / name))["trainer"]["gradient_clip_val"]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's side of the cases, run at once in threads (the XLA
    compiles run outside the GIL): each shipped file's build, initialized for the
    first file of each backbone block and traced for the others (the params are a
    function of the block and the seed alone: the three latent configs share
    one), and the narrowed pixel step. Returns each file's (denoiser, param
    shapes, params) and the step."""
    lms = {name: _lm(name) for name in SR_CONFIGS}
    first = {}
    for name, lm in lms.items():
        first.setdefault(_backbone_key(lm), name)
    inits = set(first.values())
    with concurrent.futures.ThreadPoolExecutor(len(inits) + 1) as pool:
        step = pool.submit(_jax_step)
        runs = {name: pool.submit(_jax_build, lms[name], init=True) for name in inits}
        # The traces hold the GIL: this thread takes them while the pool compiles.
        builds = {name: _jax_build(lm) for name, lm in lms.items() if name not in inits}
        builds.update({name: run.result() for name, run in runs.items()})
        return {name: (den, shapes, builds[first[_backbone_key(lms[name])]][2])
                for name, (den, shapes, _) in builds.items()}, step.result()


@pytest.mark.parametrize("name", SR_CONFIGS)
def test_config_loads_the_jax_init(jax_side, name):
    """The port's UNet of each shipped SR config takes the JAX package's init of
    the same file strictly, with its parameter count, its denoiser and schedule."""
    import jax

    lm = _lm(name)
    jden, shapes, params = jax_side[0][name]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(
        lambda a: a.shape, params)
    den, unet = build_denoiser_from_config(lm, device="cpu")
    unet.load_state_dict(state_dict_from_variables({"params": params}), strict=True)
    assert sum(p.numel() for p in unet.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    assert type(den).__name__ == type(jden).__name__
    assert type(den.schedule).__name__ == type(jden.schedule).__name__
    bb = lm["denoiser"]["backbone"]
    assert unet.conv_in.weight.shape[1] == bb["in_channels"] + bb["cond_channels"]
    assert unet.conv_out.weight.shape[0] == bb["out_channels"]


@pytest.mark.parametrize("name", STATS_NAMES)
def test_reference_latent_stats_match_jax(name):
    from eovax.data.sen2naip import reference_latent_stats as jax_stats

    got, want = reference_latent_stats(name), jax_stats(name)
    assert sorted(got) == sorted(want) == ["mean", "std"]
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        assert got[key].shape == (32,)
        np.testing.assert_array_equal(got[key], want[key])


def test_karras_pixel_step_matches_jax(jax_side):
    """One step of ``pixel.yaml``'s Karras + VP denoiser (narrowed) under its clip
    and Adam: the loss and every parameter after the update against the JAX
    trainer's ``_train_step`` from the same parameters, t and noise."""
    run = jax_side[1]
    assert ((run["t"] >= 0.2) & (run["t"] <= 0.9)).all(), run["t"]
    den, unet = build_denoiser_from_config(run["lm"], policy=FULL_PRECISION, device="cpu")
    unet.load_state_dict(state_dict_from_variables({"params": run["params"]}), strict=True)
    trainer = DiffusionSuperRes(denoiser=den, init_params=unet, sampler_steps=2,
                                base_lr=STEP_LR, grad_clip=_clip("pixel.yaml"))
    state = trainer.init_state()
    grads, opt_step = [], state.optimizer.step

    def spy():  # the gradients the optimizer is handed
        grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()})
        return opt_step()

    state.optimizer.step = spy
    logs = trainer.train_step(state, _nchw(run["hr"]), _nchw(run["lr"]),
                              t=torch.from_numpy(run["t"]), eps=_nchw(run["eps"]))
    np.testing.assert_allclose(float(logs["train_loss"]), run["loss"], rtol=LOSS_RTOL)
    got, want = state.model.state_dict(), run["final"]
    assert sorted(got) == sorted(want)
    norm = torch.sqrt(sum(v.double().square().sum() for v in grads[0].values())).item()
    zero = {k for k, v in grads[0].items() if v.abs().max().item() <= 1e-7 * norm}
    assert all(k.endswith(("conv1.bias", "conv2.bias", "skip.bias")) for k in zero), zero
    for name, w in want.items():
        w = w.reshape(got[name].shape)
        if name in zero:
            assert (got[name] - w).abs().max().item() <= 2 * STEP_LR, name
        else:
            tol = TOL["rtol"] * w.abs().max().item() + TOL["atol"]
            assert (got[name] - w).abs().max().item() <= tol, name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pixel_gradients_on_card_match_cpu(cuda_device):
    """``pixel.yaml``'s full-width UNet under its Karras loss at [1,4,64,64] + cond:
    every parameter's gradient on the card, fp32 (TF32 off) and bf16, against
    fp32 on the CPU, as ‖diff‖/‖ref‖ (chip_smoke.py phase 19 (a)'s limits)."""
    lm = _lm("pixel.yaml")
    g = torch.Generator().manual_seed(0)
    x, cond, eps = (torch.randn(1, BANDS, 64, 64, generator=g) for _ in range(3))
    t = torch.tensor([0.6])
    _, unet = build_denoiser_from_config(lm, policy=FULL_PRECISION, device="cpu")
    sd = {k: 0.02 * torch.randn(v.shape, generator=g) for k, v in unet.state_dict().items()}

    def grads(policy, device) -> dict:
        den, model = build_denoiser_from_config(lm, policy=policy, device=device)
        model.load_state_dict(sd)
        den.loss(model, *(a.to(device) for a in (x, t, cond)), eps=eps.to(device)).backward()
        return {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    ref = grads(FULL_PRECISION, "cpu")
    norm = sum((r.double() ** 2).sum() for r in ref.values()) ** 0.5
    for policy, tol in ((FULL_PRECISION, 1e-3), (DEFAULT_POLICY, 1e-1)):
        got = grads(policy, cuda_device)
        diff = sum(((got[n].double() - r.double()) ** 2).sum() for n, r in ref.items()) ** 0.5
        assert float(diff / norm) <= tol
