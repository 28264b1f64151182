"""The port's bridge to the JAX package's ``.msgpack`` files: the codec of
``eovax_torch.utils.flax_msgpack`` against ``flax.serialization`` both ways,
``variables_from_state_dict`` as the inverse of ``state_dict_from_variables``,
``EOFluxVAE.save`` / ``load_checkpoint`` / ``from_pretrained``, the convert CLI
both ways, and the SR eval CLI on a UNet file the JAX package wrote.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from eovax_torch.core import config as tcfg
from eovax_torch.models.eo_flux_vae import EOFluxVAE
from eovax_torch.utils import flax_msgpack
from eovax_torch.utils.convert import state_dict_from_variables, variables_from_state_dict
from test_torch_serving import _YAML, WVS, _cfg, _fill, _jax_vae_variables, _rel, _x


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(tree):
    """A flax tree (FrozenDicts, jax arrays) as dicts of numpy leaves."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


def _equal(a, b, path="") -> None:
    """The same tree: keys, leaf types, dtypes, shapes and values bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or torch.is_tensor(a):
        if torch.is_tensor(a):  # bfloat16 arrives as a tensor, flax gives ml_dtypes
            a, b = a.view(torch.int16).numpy(), np.asarray(b).view(np.int16)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == np.asarray(b).tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


def _trees():
    g = np.random.default_rng(0)
    return {
        "nested-fp32": {"params": {"conv": {"kernel": g.standard_normal((3, 3, 4, 5))
                                            .astype(np.float32),
                                            "bias": np.zeros(5, np.float32)},
                                   "norm": {"scale": np.ones(5, np.float32)}},
                        "batch_stats": {"bn": {"mean": g.standard_normal(32).astype(np.float32),
                                               "var": np.ones(32, np.float32)}}},
        "bf16": {"w": np.asarray(jnp.asarray(g.standard_normal((4, 6)), jnp.bfloat16)),
                 "b": np.asarray(jnp.zeros((7,), jnp.bfloat16))},
        "ints": {"i8": np.arange(-60, 70, dtype=np.int8),
                 "i32": g.integers(-2**31, 2**31 - 1, (3, 100)).astype(np.int32),
                 "u8": np.arange(256, dtype=np.uint8), "i64": np.asarray([2**40, -2**40])},
        "scalars": {"step": 3, "neg": -70000, "big": 2**40, "lr": 1.5e-4, "name": "x" * 40,
                    "flag": True, "none": None, "np32": np.float32(2.5), "np_i": np.int32(-7),
                    **{str(i): i for i in range(20)}},
        "odd-shapes": {"empty": np.zeros((0, 3), np.float32), "0d": np.asarray(1.25),
                       "f16": np.arange(300, dtype=np.float16), "f64": np.linspace(0, 1, 70000)},
    }


@pytest.mark.parametrize("case", list(_trees()))
def test_codec_writes_what_flax_writes(case):
    tree = _trees()[case]
    assert flax_msgpack.packb(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("case", list(_trees()))
def test_codec_reads_what_flax_writes(case):
    data = serialization.to_bytes(_trees()[case])
    _equal(flax_msgpack.unpackb(data), _plain(serialization.msgpack_restore(data)))


def test_flax_reads_bf16_tensors_the_codec_writes():
    """A torch.bfloat16 tensor goes out under the name ``bfloat16`` with its raw
    16-bit words, as flax writes the same values."""
    ref = jnp.asarray(np.random.default_rng(1).standard_normal((5, 3)), jnp.bfloat16)
    t = torch.from_numpy(np.asarray(ref, np.float32)).bfloat16()
    assert flax_msgpack.packb({"w": t}) == serialization.to_bytes({"w": ref})
    got = serialization.msgpack_restore(flax_msgpack.packb({"w": t}))["w"]
    assert got.dtype == jnp.bfloat16 and np.array_equal(np.asarray(got, np.float32),
                                                        t.float().numpy())


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays above the chunk size go out as flax's chunked dicts and come back whole."""
    monkeypatch.setattr(flax_msgpack, "_MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10), "small": np.ones(3)}
    data = serialization.to_bytes(tree)
    assert flax_msgpack.packb(tree) == data
    _equal(flax_msgpack.unpackb(data), _plain(serialization.msgpack_restore(data)))


def test_malformed_documents_raise():
    data = flax_msgpack.packb({"w": np.ones(4, np.float32)})
    for bad in (data[:-3], data + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            flax_msgpack.unpackb(bad)


def _unet_shapes(**kw):
    from eovax.core.precision import FULL_PRECISION
    from eovax.models.unet import UNet as JaxUNet

    ju = JaxUNet(**kw, policy=FULL_PRECISION)
    x = jnp.zeros((1, 8, 8, kw["in_channels"]))
    return jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), x, jnp.zeros((1,)), x))


def _vae_shapes(adain, generator):
    from eovax.core import config as jcfg
    from eovax.models.backbone import EOVAECore as JaxCore

    stem = jcfg.StemConfig(num_layers=2, wv_planes=32, use_adain=adain, generator_type=generator)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    cfg = jcfg.VAEConfig(encoder=jcfg.EncoderConfig(**kw), decoder=jcfg.DecoderConfig(**kw))
    core = JaxCore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    return jax.eval_shape(lambda: core.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)), jnp.linspace(0.4, 2.5, 4),
        sample_posterior=False, method=JaxCore.forward))


@pytest.mark.parametrize("tree", ["vae-transformer", "vae-adain-factorized", "unet"])
def test_variables_from_state_dict_inverts_the_converter(tree):
    """``variables_from_state_dict(state_dict_from_variables(v))`` is ``v`` bit for
    bit: every name, layout and value of the JAX package's tree."""
    shapes = {"vae-transformer": lambda: _vae_shapes(False, "transformer"),
              "vae-adain-factorized": lambda: _vae_shapes(True, "factorized"),
              "unet": lambda: _unet_shapes(in_channels=4, out_channels=4, cond_channels=4,
                                           hid_channels=(32, 16), hid_blocks=(1, 1))}[tree]()
    v = _plain(jax.tree_util.tree_map(
        lambda s, g=np.random.default_rng(2): g.standard_normal(s.shape).astype(np.float32),
        shapes))
    back = variables_from_state_dict(state_dict_from_variables(v))
    assert set(back) == set(v)
    for collection in v:
        flat = dict(jax.tree_util.tree_flatten_with_path(v[collection])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back[collection])[0])
        assert flat.keys() == got.keys()
        for path, arr in flat.items():
            assert got[path].dtype == arr.dtype and np.array_equal(got[path], arr), path


@pytest.fixture(scope="module")
def port_model():
    _, variables = _jax_vae_variables(seed=5)
    return EOFluxVAE(_cfg(tcfg), state_dict_from_variables(variables), device="cpu")


def test_port_msgpack_loads_in_the_jax_package(port_model, tmp_path):
    """A ``.msgpack`` the port writes loads into the JAX package's
    ``EOFluxVAE.load_checkpoint`` and reproduces the port's reconstruct
    (≤ 1e-4 relative to max, fp32)."""
    from eovax.core import config as jcfg
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE

    path = str(tmp_path / "eo-vae.msgpack")
    port_model.save(path)
    jm = JaxVAE(_cfg(jcfg), _jax_vae_variables(seed=9)[1])  # other weights, replaced
    jm.load_checkpoint(path)
    x = _x(2, seed=3)
    assert _rel(jm.reconstruct(x, WVS), port_model.reconstruct(x, WVS)) <= 1e-4


def test_save_and_load_checkpoint_round_trip(port_model, tmp_path):
    """The port's ``.msgpack`` and the JAX package's own file of the same
    variables load into a fresh port model with every weight bit for bit;
    a directory (orbax) is refused with the JAX converter's name."""
    from eovax.utils.checkpoint import save_variables

    ours, theirs = str(tmp_path / "ours.msgpack"), str(tmp_path / "theirs.eovax")
    port_model.save(ours)
    save_variables(theirs, variables_from_state_dict(port_model.core.state_dict()))
    for path in (ours, theirs):
        fresh = EOFluxVAE(_cfg(tcfg), device="cpu", seed=1)
        fresh.load_checkpoint(path)
        for k, v in port_model.core.state_dict().items():
            assert torch.equal(fresh.core.state_dict()[k], v), k
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="eovax.cli.convert_checkpoint"):
        EOFluxVAE(_cfg(tcfg), device="cpu").load_checkpoint(str(tmp_path / "orbax"))


def test_from_pretrained_with_a_stub_hub(port_model, tmp_path, monkeypatch):
    """``from_pretrained`` downloads the config and the checkpoint through
    ``huggingface_hub.hf_hub_download`` (imported when called) and builds."""
    (tmp_path / "model_config.yaml").write_text(yaml.safe_dump(_YAML))
    port_model.save(str(tmp_path / "eo-vae.msgpack"))
    calls = []

    def hf_hub_download(*, filename, **kw):
        calls.append((filename, kw))
        return str(tmp_path / filename)

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))
    model = EOFluxVAE.from_pretrained("org/eo-vae", ckpt_filename="eo-vae.msgpack",
                                      revision="v1", device="cpu")
    assert [c[0] for c in calls] == ["model_config.yaml", "eo-vae.msgpack"]
    assert calls[0][1] == dict(repo_id="org/eo-vae", revision="v1", cache_dir=None,
                               local_files_only=False)
    x = _x(1, seed=6)
    assert torch.equal(model.reconstruct(x, WVS), port_model.reconstruct(x, WVS))


def test_convert_cli_both_ways(port_model, tmp_path):
    """A reference-format ``.ckpt`` → ``.msgpack`` (the JAX package reads it),
    and that ``.msgpack`` → a torch file the port loads: the same weights."""
    from eovax.utils.checkpoint import load_variables
    from eovax_torch.cli.convert_checkpoint import main

    cfg = tmp_path / "model_config.yaml"
    cfg.write_text(yaml.safe_dump(_YAML))
    torch.save({"state_dict": port_model.core.state_dict()}, tmp_path / "eo-vae.ckpt")
    main(["--config", str(cfg), "--input", str(tmp_path / "eo-vae.ckpt"),
          "--output", str(tmp_path / "eo-vae.msgpack")])
    want = variables_from_state_dict(port_model.core.state_dict())
    got = _plain(load_variables(str(tmp_path / "eo-vae.msgpack"), want))
    _equal(got, want)
    main(["--config", str(cfg), "--input", str(tmp_path / "eo-vae.msgpack"),
          "--output", str(tmp_path / "back.pt")])
    fresh = EOFluxVAE(_cfg(tcfg), device="cpu", seed=1)
    fresh.load_checkpoint(str(tmp_path / "back.pt"))
    for k, v in port_model.core.state_dict().items():
        assert torch.equal(fresh.core.state_dict()[k], v), k


def test_eval_cli_reads_a_jax_written_unet(tmp_path):
    """``eval_metric_super_res --sr-ckpt`` takes the ``sr-best.msgpack`` that the
    JAX package's SR trainer writes (``{"params": ...}`` of its full-width
    UNet): ``read_state_dict`` gives the UNet every weight of it (strictly), and
    the CLI runs on it to finite metrics."""
    from eovax.utils.checkpoint import save_variables
    from eovax_torch.cli.eval_metric_super_res import main
    from eovax_torch.models.unet import UNet
    from eovax_torch.utils.convert import read_state_dict
    from test_torch_sr import _VAE_YAML, Z, _tiny_vae_config, _write_latent_tree

    params = _fill(_unet_shapes(in_channels=Z, out_channels=Z, cond_channels=Z), seed=4)
    save_variables(str(tmp_path / "sr-best.msgpack"), params)
    want = state_dict_from_variables(params)
    got = read_state_dict(str(tmp_path / "sr-best.msgpack"))
    UNet(in_channels=Z, out_channels=Z, cond_channels=Z).load_state_dict(got, strict=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(_VAE_YAML))
    vae = EOFluxVAE(_tiny_vae_config(tcfg), device="cpu", seed=1)
    torch.save({"state_dict": vae.core.state_dict()}, tmp_path / "m.ckpt")
    _write_latent_tree(tmp_path / "latents")
    main(["--vae-config", str(tmp_path / "c.yaml"), "--vae-ckpt", str(tmp_path / "m.ckpt"),
          "--sr-ckpt", str(tmp_path / "sr-best.msgpack"), "--data-root",
          str(tmp_path / "latents"), "--batch-size", "2", "--num-batches", "1",
          "--sr-steps", "2", "--output", str(tmp_path / "out"), "--device", "cpu"])
    metrics = json.loads((tmp_path / "out" / "all_metrics.json").read_text())
    assert set(metrics) == {"rmse", "psnr", "ssim", "sam"}
    assert all(np.isfinite(v) for v in metrics.values())
