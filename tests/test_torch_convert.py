"""The weight bridge, checkpoint loading and config parsing of the port."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eovax.core import config as jcfg
from eovax.models.backbone import EOVAECore as JaxCore
from eovax.utils.torch_convert import export_state_dict
from eovax_torch import EOFluxVAE
from eovax_torch.core import config as tcfg
from eovax_torch.core.precision import policy_from_name
from eovax_torch.utils.convert import state_dict_from_variables

CONFIG = str(pathlib.Path(__file__).resolve().parents[1] / "configs" / "eo-vae.yaml")


def _tiny(m, adain, generator):
    stem = m.StemConfig(num_layers=2, wv_planes=32, use_adain=adain, generator_type=generator)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(**kw), decoder=m.DecoderConfig(**kw))


def _shapes(cfg, bands):
    """The JAX package's variable tree as ShapeDtypeStructs (no compute)."""
    core = JaxCore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    x = jnp.zeros((1, 32, 32, bands), jnp.float32)
    wvs = jnp.linspace(0.4, 2.5, bands)
    return jax.eval_shape(
        lambda: core.init(jax.random.PRNGKey(0), x, wvs, sample_posterior=False,
                          method=JaxCore.forward)
    )


def _fill(shapes, seed=0):
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: g.standard_normal(s.shape).astype(np.float32), shapes
    )


@pytest.mark.parametrize("adain,generator", [(False, "transformer"), (True, "factorized")])
def test_state_dict_matches_export_state_dict(adain, generator):
    variables = _fill(_shapes(_tiny(jcfg, adain, generator), 4))
    ours = state_dict_from_variables(variables)
    ref = export_state_dict(variables)
    assert sorted(ours) == sorted(ref)
    for key, arr in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), arr, err_msg=key)
    EOFluxVAE(_tiny(tcfg, adain, generator), ours, device="cpu")  # loads strict


def test_full_width_state_dict_loads_strict():
    """The shipped config (~95.5M params): eval_shape + numpy fill, no JAX compute."""
    jc = jcfg.load_model_config(CONFIG)
    stem = dataclasses.replace(jc.encoder.stem, num_layers=4, wv_planes=256)
    shapes = _shapes(
        dataclasses.replace(jc, encoder=dataclasses.replace(jc.encoder, stem=stem),
                            decoder=dataclasses.replace(jc.decoder, stem=stem)),
        12,
    )
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    variables = _fill(shapes)
    tc = tcfg.load_model_config(CONFIG)
    tstem = dataclasses.replace(tc.encoder.stem, num_layers=4, wv_planes=256)
    tc = dataclasses.replace(tc, encoder=dataclasses.replace(tc.encoder, stem=tstem),
                             decoder=dataclasses.replace(tc.decoder, stem=tstem))
    model = EOFluxVAE(tc, state_dict_from_variables(variables), device="cpu")
    assert model.param_count() == jax_count == 95_514_145
    got = model.core.state_dict()["decoder.mid.attn_1.q.weight"].numpy()
    want = variables["params"]["decoder"]["mid_attn_1"]["q"]["kernel"]
    np.testing.assert_array_equal(got, np.transpose(want, (3, 2, 0, 1)))


@pytest.fixture
def tiny_pair():
    cfg = _tiny(tcfg, False, "transformer")
    src = EOFluxVAE(cfg, device="cpu", seed=1)
    with torch.no_grad():
        src.core.bn.running_mean.normal_(generator=torch.Generator().manual_seed(2))
    return cfg, src, EOFluxVAE(cfg, device="cpu", seed=2)


def _assert_same_weights(a, b, prefix=""):
    sa, sb = a.core.state_dict(), b.core.state_dict()
    for key in sa:
        if key.startswith(prefix):
            torch.testing.assert_close(sa[key], sb[key], rtol=0, atol=0, msg=key)


def test_ckpt_roundtrip(tiny_pair, tmp_path):
    _, src, dst = tiny_pair
    path = tmp_path / "eo-vae.ckpt"
    sd = src.core.state_dict()
    sd["loss_fn.logvar"] = torch.zeros(())  # trainer extras are ignored
    torch.save({"state_dict": sd, "epoch": 3}, path)
    dst.load_checkpoint(str(path))
    _assert_same_weights(src, dst)
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(np.float32)
    wvs = [0.665, 0.56, 0.49]
    torch.testing.assert_close(dst.reconstruct(x, wvs), src.reconstruct(x, wvs))


def test_distilled_stems_load_alone(tiny_pair, tmp_path):
    _, src, dst = tiny_pair
    path = tmp_path / "stems.pt"
    torch.save({
        "encoder_conv_in_state_dict": src.core.encoder.conv_in.state_dict(),
        "decoder_conv_out_state_dict": src.core.decoder.conv_out.state_dict(),
    }, path)
    before = dst.core.state_dict()["encoder.mid.block_1.conv1.weight"].clone()
    dst.load_checkpoint(str(path))
    _assert_same_weights(src, dst, "encoder.conv_in")
    _assert_same_weights(src, dst, "decoder.conv_out")
    assert torch.equal(dst.core.state_dict()["encoder.mid.block_1.conv1.weight"], before)


def test_ckpt_strictness(tiny_pair, tmp_path):
    _, src, dst = tiny_pair
    sd = src.core.state_dict()
    unknown = dict(sd, **{"encoder.extra.weight": torch.zeros(1)})
    torch.save({"state_dict": unknown}, tmp_path / "unknown.ckpt")
    with pytest.raises(ValueError, match="Unconvertible"):
        dst.load_checkpoint(str(tmp_path / "unknown.ckpt"))
    missing = {k: v for k, v in sd.items() if not k.startswith("decoder.mid.")}
    torch.save({"state_dict": missing}, tmp_path / "missing.ckpt")
    with pytest.raises(ValueError, match="missing"):
        dst.load_checkpoint(str(tmp_path / "missing.ckpt"))
    # Dynamic stems may be absent (a teacher checkpoint has static stems only).
    body = {k: v for k, v in sd.items() if not k.startswith("encoder.conv_in")}
    body["encoder.conv_in.weight"] = torch.zeros(32, 3, 3, 3)
    torch.save({"state_dict": body}, tmp_path / "teacher.ckpt")
    dst.load_checkpoint(str(tmp_path / "teacher.ckpt"))
    _assert_same_weights(src, dst, "decoder.")


def test_teacher_safetensors_loads_body(tiny_pair, tmp_path):
    """A Flux-teacher .safetensors holds the body and static stems only."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    _, src, dst = tiny_pair
    body = {k: v.contiguous() for k, v in src.core.state_dict().items()
            if not k.startswith(("encoder.conv_in", "decoder.conv_out", "bn."))}
    body["decoder.conv_out.weight"] = torch.zeros(3, 32, 3, 3)
    safetensors_torch.save_file(body, str(tmp_path / "ae.safetensors"))
    stem_before = dst.core.state_dict()["decoder.conv_out.fclayer.w1.weight"].clone()
    dst.load_checkpoint(str(tmp_path / "ae.safetensors"))
    _assert_same_weights(src, dst, "encoder.down.")
    _assert_same_weights(src, dst, "decoder.up.")
    assert torch.equal(dst.core.state_dict()["decoder.conv_out.fclayer.w1.weight"], stem_before)


def test_from_config_with_checkpoint(tiny_pair, tmp_path):
    _, src, _ = tiny_pair
    (tmp_path / "model_config.yaml").write_text(
        "model:\n"
        "  encoder: {ch: 32, ch_mult: [1, 2], num_res_blocks: 1, z_channels: 8,\n"
        "            use_dynamic_ops: true, dynamic_conv_kwargs: {num_layers: 2, wv_planes: 32}}\n"
        "  decoder: {ch: 32, ch_mult: [1, 2], num_res_blocks: 1, z_channels: 8,\n"
        "            use_dynamic_ops: true, dynamic_conv_kwargs: {num_layers: 2, wv_planes: 32}}\n"
    )
    torch.save({"state_dict": src.core.state_dict()}, tmp_path / "eo-vae.ckpt")
    torch.backends.cudnn.allow_tf32 = True
    model = EOFluxVAE.from_config(str(tmp_path / "model_config.yaml"),
                                  str(tmp_path / "eo-vae.ckpt"), device="cpu")
    _assert_same_weights(src, model)
    assert model.param_count() == src.param_count()
    assert not torch.backends.cudnn.allow_tf32  # FULL_PRECISION ≙ Precision.HIGHEST
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("name,dtype", [("32-true", torch.float32), ("16-mixed", torch.bfloat16),
                                        ("bf16-mixed", torch.bfloat16)])
def test_policy_from_name(name, dtype):
    policy = policy_from_name(name)
    assert policy.compute_dtype == dtype
    assert policy.param_dtype == policy.norm_dtype == torch.float32


def test_policy_from_name_rejects_unported_policies():
    # int8 is ported (tests/test_torch_qconv.py); the Winograd conv is not.
    for name in ("winograd", "bf16-winograd"):
        with pytest.raises(ValueError, match="ROADMAP Queue 1 item 10"):
            policy_from_name(name)


def test_config_dataclasses_match_jax_package():
    ours, ref = tcfg.load_model_config(CONFIG), jcfg.load_model_config(CONFIG)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.encoder.stem == tcfg.StemConfig(num_layers=4, wv_planes=256)
