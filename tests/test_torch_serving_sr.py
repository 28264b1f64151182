"""The port's SR-pipeline artifact (``eovax_torch.serving.export_sr_pipeline``)
on the CPU: encode → sampler → decode as one graph against the JAX package's
composition from the same x1, the per-sample seed contract, the unrolled
sampler's hand-kernel ops, and SR requests batched by the daemon.

The tiny VAE and its numpy-drawn weights are ``tests/test_torch_serving.py``'s;
the UNet ((32, 16) × (1, 1), 8 latent channels) holds the JAX package's
parameter tree with every leaf drawn from a numpy seed, loaded into the port
through ``state_dict_from_variables`` strictly. The JAX artifact draws its x1
from threefry keys, which torch cannot reproduce: the composition is held
instead, with the x1 the port's artifact draws.
"""

import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import test_torch_serving as ts
from eovax_torch.serving import ServedModel, export_sr_pipeline, per_sample_seeds
from test_torch_serving import TOL_JAX, WVS, Z, _fill, _hand_kernel_calls, _npy, _rel, _Serving, _x

UNET_KW = dict(in_channels=Z, out_channels=Z, cond_channels=Z, hid_channels=(32, 16),
               hid_blocks=(1, 1))
models = ts.models  # the module-scoped fixture, shared by name

LATENT_STATS = (np.linspace(-0.3, 0.4, Z).astype(np.float32),
                np.linspace(0.6, 1.8, Z).astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unets():
    """(JAX UNet, its params, the port's UNet) with every leaf from a numpy seed."""
    import jax
    import jax.numpy as jnp

    from eovax.core.precision import FULL_PRECISION
    from eovax.models.unet import UNet as JaxUNet
    from eovax_torch.models.unet import UNet
    from eovax_torch.utils.convert import state_dict_from_variables

    ju = JaxUNet(**UNET_KW, policy=FULL_PRECISION)
    x = jnp.zeros((1, 16, 16, Z))
    shapes = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), x, jnp.zeros((1,)), x))
    params = _fill(shapes, seed=1)["params"]
    tu = UNet(**UNET_KW)
    tu.load_state_dict(state_dict_from_variables({"params": params}), strict=True)
    return ju, params, tu.eval()


@pytest.fixture(scope="module")
def sr_artifact(request, models, unets, tmp_path_factory):
    """The pipeline's artifact with the sampler named by the test's indirect
    parameter, 4 steps, non-trivial latent statistics."""
    from eovax_torch.models.sr_diffusion import RectifiedSchedule, SimpleDenoiser

    out = tmp_path_factory.mktemp("sr")
    manifest = export_sr_pipeline(
        models[1], SimpleDenoiser(RectifiedSchedule()), unets[2], str(out), resolution=32,
        steps=4, sampler=request.param, wvs=WVS, latent_stats=LATENT_STATS)
    return str(out), manifest


@pytest.mark.parametrize("sr_artifact", ["ddim", "dpm++2m"], indirect=True)
def test_sr_pipeline_matches_the_jax_composition(models, unets, sr_artifact):
    """encode_spatial_normalized → the JAX sampler from the same x1 → decode
    (≤ 1e-4 relative to max); the manifest keeps the JAX keys."""
    import jax.numpy as jnp

    from eovax.models.sr_diffusion import RectifiedSchedule, SimpleDenoiser, make_sampler

    jm, _, _ = models
    ju, params, _ = unets
    out, manifest = sr_artifact
    assert manifest["pipeline"] == "sr" and manifest["steps"] == manifest["ddim_steps"] == 4
    assert manifest["functions"]["super_resolve"]["extra_args"] == ["seed:int32[b]"]
    assert manifest["latent_shape"] == [Z, 16, 16]
    served = ServedModel.load(out, device="cpu")
    assert served.per_sample_seed() and served.batchable("super_resolve")
    x_lr = _x(2, seed=5)
    y = served.super_resolve(x_lr, seed=7)
    assert y.shape == (2, 3, 32, 32) and torch.isfinite(y).all()

    eps = served.noise(per_sample_seeds(7, 2)).numpy()  # σ(1) = 1 for the rectified flow
    den = SimpleDenoiser(apply_fn=lambda p, x_t, t, cond=None: ju.apply({"params": p}, x_t, t,
                                                                        cond),
                         schedule=RectifiedSchedule())
    mean, std = (v.reshape(1, -1, 1, 1) for v in LATENT_STATS)
    cond = (np.asarray(jm.encode_spatial_normalized(x_lr, WVS)) - mean) / std
    nhwc = (lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 3, 1)))
    z_hr = make_sampler(manifest["sampler"], den, steps=4)(params, nhwc(eps), cond=nhwc(cond))
    z_hr = np.transpose(np.asarray(z_hr), (0, 3, 1, 2)) * std + mean
    ref = np.asarray(jm.decode_spatial_normalized(z_hr, WVS))
    assert _rel(y, ref) <= TOL_JAX


@pytest.mark.parametrize("sr_artifact", ["ddim"], indirect=True)
def test_sr_per_sample_seed_contract(sr_artifact):
    """Row i of a batched super_resolve draws the noise of the B=1 call with
    seed[i] exactly, and agrees with its output (≤ 1e-5); an int seed expands
    to per_sample_seeds; the seed count must match the batch."""
    served = ServedModel.load(sr_artifact[0], device="cpu")
    x = _x(3, seed=2)
    y = served.super_resolve(x, seed=[3, 5, -9])
    for i, s in enumerate((3, 5, -9)):
        assert torch.equal(served.noise([3, 5, -9])[i:i + 1], served.noise([s]))
        assert _rel(y[i:i + 1], served.super_resolve(x[i:i + 1], seed=[s])) <= 1e-5
    # same composition, scalar vs its expansion: bit for bit
    assert torch.equal(served.super_resolve(x, seed=7),
                       served.super_resolve(x, seed=per_sample_seeds(7, 3)))
    # a different seed changes the draw
    assert not torch.allclose(served.super_resolve(x[:1], seed=[3]),
                              served.super_resolve(x[:1], seed=[4]))
    with pytest.raises(ValueError, match="one seed per sample"):
        served.super_resolve(x, seed=[1, 2])


@pytest.mark.parametrize("sr_artifact", ["ddim", "dpm++2m"], indirect=True)
def test_sr_graph_holds_the_unrolled_sampler(sr_artifact, models, unets):
    """The sampler's loop is unrolled: 4 UNet evals between one encode and one decode."""
    out, manifest = sr_artifact
    program = torch.export.load(os.path.join(out, "super_resolve.pt2"))
    ops = Counter(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("eovax."))
    _, port, _ = models
    x = _x(1)
    z = port.encode_spatial_normalized(x, WVS)
    vae = (_hand_kernel_calls(port, lambda: port.encode_spatial_normalized(x, WVS))
           + _hand_kernel_calls(port, lambda: port.decode_spatial_normalized(z, WVS)))
    unet = unets[2]
    # Two convs and two norms a residual block (the mid blocks among them), the
    # mid attention's norm and norm_out, the attention.
    blocks = sum(len(level.block) for level in (*unet.down, *unet.up)) + 2
    per_eval = Counter({"eovax.conv3x3.default": 2 * blocks,
                        "eovax.group_norm.default": 2 * blocks + 2,
                        "eovax.flash_attention.default": 1})
    assert ops == vae + Counter({k: 4 * v for k, v in per_eval.items()})




@pytest.mark.parametrize("sr_artifact", ["ddim"], indirect=True)
def test_http_sr_batched_requests_keep_their_seeds(sr_artifact):
    """Concurrent super_resolve requests coalesce on a per-sample-seed
    artifact, and each reply matches the direct unbatched call with its seed."""
    served = ServedModel.load(sr_artifact[0], device="cpu")
    x = _x(1, seed=3)
    results, errors = {}, []
    with _Serving(served, max_batch=4, batch_wait_ms=300.0) as srv:
        def post(seed):
            try:
                results[seed] = srv.post(f"/v1/super_resolve?seed={seed}", _npy(x), timeout=300)
            except Exception as e:
                errors.append(e)

        ts = [threading.Thread(target=post, args=(s,)) for s in (3, 9)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=600)
        assert not errors, errors
        for s in (3, 9):  # the contract's bound across batch compositions
            assert _rel(results[s], served.super_resolve(x, seed=s)) <= 1e-5
        b = srv.get("/metrics")["_batching"]["super_resolve"]
        assert b["requests"] == 2 and b["samples"] == 2


def test_export_cli_writes_the_sr_pipeline(models, unets, tmp_path, capsys):
    """``eovax_torch.cli.export --sr-config`` with the ``.msgpack`` that the JAX
    package's SR trainer writes as ``--sr-ckpt``: the artifact holds that UNet's
    every weight and serves finite images at the LR shape (4 Sen2NAIP bands)."""
    import yaml

    from eovax.utils.checkpoint import save_variables
    from eovax_torch.cli.export import main as export_main
    from eovax_torch.utils.convert import state_dict_from_variables

    params = unets[1]
    save_variables(str(tmp_path / "sr-best.msgpack"), {"params": params})
    (tmp_path / "model_config.yaml").write_text(yaml.safe_dump(ts._YAML))
    torch.save({"state_dict": models[1].core.state_dict()}, tmp_path / "eo-vae.ckpt")
    backbone = dict(UNET_KW, hid_channels=list(UNET_KW["hid_channels"]),
                    hid_blocks=list(UNET_KW["hid_blocks"]))
    (tmp_path / "sr.yaml").write_text(yaml.safe_dump(
        {"lightning_module": {"denoiser": {"backbone": backbone}}}))
    export_main(["--config", str(tmp_path / "model_config.yaml"), "--ckpt",
                 str(tmp_path / "eo-vae.ckpt"), "--output", str(tmp_path / "art"),
                 "--sr-config", str(tmp_path / "sr.yaml"), "--sr-ckpt",
                 str(tmp_path / "sr-best.msgpack"), "--sr-steps", "2", "--resolution", "32",
                 "--precision", "32-true", "--device", "cpu"])
    assert "exported SR pipeline (2 ddim steps, 32² LR input)" in capsys.readouterr().out
    served = ServedModel.load(str(tmp_path / "art"), device="cpu")
    want = state_dict_from_variables({"params": params})
    assert all(torch.equal(served._state["sr"][k], v) for k, v in want.items())
    assert served.input_shape("super_resolve") == (4, 32, 32)
    y = served.super_resolve(_x(2, seed=4, shape=(4, 32, 32)), seed=1)
    assert y.shape == (2, 4, 32, 32) and torch.isfinite(y).all()

