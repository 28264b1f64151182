"""The port's serving path (``eovax_torch.serving``) on the CPU: the exported
artifact against the live port model and against the JAX package's
``ServedModel`` of the same weights, the CLIs and the HTTP daemon. The SR
pipeline's artifact is in ``tests/test_torch_serving_sr.py``.

A tiny 3-band VAE (ch 32, ch_mult (1, 2), one res block, z 8, 32²) holds the
JAX package's variable tree with every leaf drawn from a numpy seed (the
shapes of its traced init), carried into the port with
``state_dict_from_variables``. JAX is imported inside the fixtures and tests
that need it, so that the ``gpu`` cases run on a machine without JAX:

    python -m pytest tests/test_torch_serving.py -m gpu --noconftest
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from eovax_torch.core import config as tcfg
from eovax_torch.models.eo_flux_vae import EOFluxVAE
from eovax_torch.serving import ServedModel, export_model

ROOT = Path(__file__).resolve().parents[1]
WVS = [0.665, 0.56, 0.49]  # S2RGB
Z = 8
# fp32 on both sides through ~20 conv layers, summed in other orders (as
# tests/test_torch_model.py holds the model), relative to max |reference|.
TOL_JAX = 1e-4


def _cfg(m, bands: int = 3):
    stem = m.StemConfig(num_layers=1, wv_planes=64)
    kw = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=Z,
              use_dynamic_ops=True, stem=stem)
    return m.VAEConfig(encoder=m.EncoderConfig(in_channels=bands, **kw),
                       decoder=m.DecoderConfig(out_ch=bands, **kw))


_YAML = {"model": {
    part: {"z_channels": Z, "resolution": 32, channels: 3, "ch": 32, "ch_mult": [1, 2],
           "num_res_blocks": 1, "use_dynamic_ops": True,
           "dynamic_conv_kwargs": {"num_layers": 1, "wv_planes": 64}}
    for part, channels in (("encoder", "in_channels"), ("decoder", "out_ch"))}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _fill(shapes, seed: int):
    """Every leaf from a numpy seed: norm scales 1 + N(0, 0.1), the rest N(0, 0.05);
    the latent BatchNorm's statistics N(0, 1) and U(0.5, 2)."""
    import jax

    g = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "var":
            return g.uniform(0.5, 2.0, s.shape).astype(np.float32)
        base, std = (1.0, 0.1) if name == "scale" else (0.0, 1.0 if name == "mean" else 0.05)
        return (base + g.normal(0.0, std, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_vae_variables(seed: int = 0):
    import jax
    import jax.numpy as jnp

    from eovax.core import config as jcfg
    from eovax.models.backbone import EOVAECore as JaxCore

    cfg = _cfg(jcfg)
    core = JaxCore(encoder_cfg=cfg.encoder, decoder_cfg=cfg.decoder)
    shapes = jax.eval_shape(lambda: core.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.asarray(WVS),
        sample_posterior=False, method=JaxCore.forward))
    return cfg, _fill(shapes, seed)


@pytest.fixture(scope="module")
def models():
    """(JAX EOFluxVAE, port EOFluxVAE, variables): the same numpy-drawn weights."""
    from eovax.models.eo_flux_vae import EOFluxVAE as JaxVAE
    from eovax_torch.utils.convert import state_dict_from_variables

    cfg, variables = _jax_vae_variables()
    port = EOFluxVAE(_cfg(tcfg), state_dict_from_variables(variables), device="cpu")
    return JaxVAE(cfg, variables), port, variables


@pytest.fixture(scope="module")
def artifact(models, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifact")
    manifest = export_model(models[1], str(out), modalities=("S2RGB",), resolution=32)
    return str(out), manifest


@pytest.fixture(scope="module")
def served(artifact):
    """The artifact loaded on the CPU, shared (its graphs load once)."""
    return ServedModel.load(artifact[0], device="cpu")


def _x(b: int, seed: int = 0, shape=(3, 32, 32)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, *shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------


def test_manifest_and_files(artifact):
    out, manifest = artifact
    assert manifest["format"] == "eovax-torch-serving-v1"
    assert manifest["policy"] == "fp32" and manifest["device"] == "cpu"
    assert manifest["params"] == "params.pt"
    assert len(manifest["functions"]) == 3
    for entry in manifest["functions"].values():
        assert os.path.exists(os.path.join(out, entry["file"]))
        assert entry["file"].endswith(".pt2") and entry["dtype"] == "float32"
    # latent fn signature: ch_mult (1,2) -> one downsample -> 16x16 latent
    assert manifest["functions"]["decode_spatial_normalized.S2RGB"]["input_shape"] == [
        "b", 8, 16, 16]
    assert manifest["functions"]["reconstruct.S2RGB"]["input_shape"] == ["b", 3, 32, 32]
    assert json.loads(Path(out, "manifest.json").read_text()) == manifest
    # The weights live once, in params.pt: a graph holds none of them.
    params = os.path.getsize(os.path.join(out, "params.pt"))
    for entry in manifest["functions"].values():
        assert os.path.getsize(os.path.join(out, entry["file"])) < params / 2


@pytest.mark.parametrize("b", [1, 3, 5])
def test_artifact_matches_live_port_model(models, served, b):
    """The symbolic batch: each function at B = 1, 3 and 5 against the live
    model, the same plain versions in the same order (≤ 1e-6 is the bound;
    the two agree bit for bit)."""
    _, port, _ = models
    assert served.modalities == ["S2RGB"]
    x = _x(b, seed=b)
    for got, ref in (
            (served.reconstruct(x, modality="S2RGB"), port.reconstruct(x, WVS)),
            (served.encode_spatial_normalized(x, modality="S2RGB"),
             port.encode_spatial_normalized(x, WVS))):
        assert got.shape == ref.shape and got.shape[0] == b
        assert torch.equal(got, ref) or _rel(got, ref) <= 1e-6
    z = port.encode_spatial_normalized(x, WVS)
    got, ref = served.decode_spatial_normalized(z, modality="S2RGB"), \
        port.decode_spatial_normalized(z, WVS)
    assert got.shape == (b, 3, 32, 32)
    assert torch.equal(got, ref) or _rel(got, ref) <= 1e-6


def test_artifact_matches_the_jax_served_model(models, served, tmp_path):
    """The port's artifact against the JAX package's artifact of the same
    weights, fp32 (≤ 1e-4 relative to max)."""
    from eovax.serving import ServedModel as JaxServed
    from eovax.serving import export_model as jax_export

    jm, _, _ = models
    jax_export(jm, str(tmp_path), modalities=("S2RGB",), resolution=32)
    ref, got = JaxServed.load(str(tmp_path)), served
    x = _x(2, seed=11)
    for name in ("reconstruct", "encode_spatial_normalized"):
        out = getattr(got, name)(x, modality="S2RGB")
        assert _rel(out, getattr(ref, name)(x, modality="S2RGB")) <= TOL_JAX, name
    z = np.asarray(ref.encode_spatial_normalized(x, modality="S2RGB"))
    out = got.decode_spatial_normalized(z, modality="S2RGB")
    assert _rel(out, ref.decode_spatial_normalized(z, modality="S2RGB")) <= TOL_JAX


def test_unknown_function_raises_the_jax_key_error(artifact, served):
    """The KeyError text is the JAX package's, byte for byte (the daemon's 404
    body)."""
    from eovax.serving import ServedModel as JaxServed

    ref = JaxServed(*artifact, variables=None)
    for name, modality in (("reconstruct", "S1RTC"), ("super_resolve", None)):
        with pytest.raises(KeyError) as got:
            served._fn(name, modality)
        with pytest.raises(KeyError) as want:
            ref._entry(name, modality)
        assert str(got.value) == str(want.value)
        with pytest.raises(KeyError):
            served.input_shape(name, modality)


def _hand_kernel_calls(port, fn) -> Counter:
    """The hand-kernel calls of ``fn()`` on the live model, counted by module hooks."""
    from eovax_torch.nn.blocks import AttnBlock, Conv3x3, GroupNorm

    calls = Counter()
    kinds = {Conv3x3: "eovax.conv3x3.default", GroupNorm: "eovax.group_norm.default",
             AttnBlock: "eovax.flash_attention.default"}
    hooks = [m.register_forward_hook(lambda m, a, o, k=k: calls.update([k]))
             for m in port.core.modules() for cls, k in kinds.items() if type(m) is cls]
    fn()
    for h in hooks:
        h.remove()
    return calls


def test_graphs_reach_the_hand_kernels_as_custom_ops(models, artifact):
    """Each graph holds one ``eovax::*`` op per hand-kernel call of the live model
    (the attention block's norm is one of its GroupNorm calls)."""
    _, port, _ = models
    out, manifest = artifact
    x = _x(1)
    z = port.encode_spatial_normalized(x, WVS)
    live = {"reconstruct": lambda: port.reconstruct(x, WVS),
            "encode_spatial_normalized": lambda: port.encode_spatial_normalized(x, WVS),
            "decode_spatial_normalized": lambda: port.decode_spatial_normalized(z, WVS)}
    for name, fn in live.items():
        program = torch.export.load(os.path.join(out, f"{name}.S2RGB.pt2"))
        ops = Counter(str(n.target) for n in program.graph.nodes
                      if str(n.target).startswith("eovax."))
        assert ops == _hand_kernel_calls(port, fn), name
        assert ops["eovax.conv3x3.default"] > 0 and ops["eovax.group_norm.default"] > 0
        assert program.state_dict.keys() == {"wvs"}  # no weight of the model


def test_live_calls_through_the_custom_ops(models):
    """Inside ``ops.live()`` the live model's hand-kernel calls go through the
    ``eovax::`` ops (on the CPU their plain versions): the same output bit for
    bit, one op dispatch per hand-kernel call."""
    from torch.profiler import ProfilerActivity, profile

    from eovax_torch.kernels import ops

    _, port, _ = models
    x = _x(2, seed=9)
    ref = port.reconstruct(x, WVS)
    with ops.live(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = port.reconstruct(x, WVS)
    assert not ops.through_op()
    assert torch.equal(out, ref)
    calls = Counter({e.key: e.count for e in prof.key_averages() if e.key.startswith("eovax::")})
    want = _hand_kernel_calls(port, lambda: port.reconstruct(x, WVS))
    assert calls == Counter({k.removesuffix(".default").replace(".", "::"): v
                             for k, v in want.items()})


def test_compact_weights_export(models, served, tmp_path):
    """bf16 parameters (under 0.6 of the weights file) with fp32 BN statistics;
    the artifact still serves within bf16 rounding of the weights."""
    _, port, _ = models
    export_model(port, str(tmp_path), modalities=("S2RGB",), resolution=32,
                 functions=("reconstruct",), params_dtype=torch.bfloat16)
    assert (os.path.getsize(tmp_path / "params.pt")
            < 0.6 * os.path.getsize(os.path.join(served._dir, "params.pt")))
    compact = ServedModel.load(str(tmp_path), device="cpu")
    assert compact._manifest["params_dtype"] == "bfloat16"
    assert compact._state["bn.running_mean"].dtype == torch.float32
    assert compact._state["decoder.conv_in.weight"].dtype == torch.bfloat16
    x = _x(1, seed=4)
    y = compact.reconstruct(x, modality="S2RGB").numpy()
    ref = served.reconstruct(x, modality="S2RGB").numpy()
    rms = float(np.sqrt(np.mean((y - ref) ** 2)) / (np.std(ref) + 1e-8))
    assert np.isfinite(y).all() and 0 < rms < 0.05, rms


def test_export_cli(tmp_path, capsys):
    from eovax_torch.cli.export import main as export_main

    cfg = tmp_path / "model_config.yaml"
    cfg.write_text(yaml.safe_dump(_YAML))
    out = tmp_path / "artifact"
    export_main(["--config", str(cfg), "--output", str(out), "--modalities", "S2RGB",
                 "--resolution", "32", "--precision", "32-true", "--device", "cpu"])
    assert "exported 3 functions" in capsys.readouterr().out
    served = ServedModel.load(str(out), device="cpu")
    assert served._manifest["policy"] == "fp32"
    y = served.reconstruct(np.zeros((1, 3, 32, 32), np.float32), modality="S2RGB")
    assert y.shape == (1, 3, 32, 32) and torch.isfinite(y).all()
    # Calibration is for int8 artifacts only (tests/test_torch_serving_int8.py).
    with pytest.raises(SystemExit):
        export_main(["--config", str(cfg), "--output", str(tmp_path / "x"),
                     "--device", "cpu", "--calibrate-npz", "calib.npz"])
    assert "--calibrate-npz requires --precision int8" in capsys.readouterr().err


def test_int8_and_mesh_are_refused_with_their_roadmap_items(models, artifact, served, tmp_path,
                                                            capsys, monkeypatch):
    """What is still refused, as the JAX package refuses it: static ranges
    without an int8 policy, and a mesh of more than one axis (int8 serving is in
    ``tests/test_torch_serving_int8.py``, the mesh in
    ``tests/test_torch_serving_mesh.py``); ``serve --mesh`` itself runs."""
    from eovax_torch.cli.serve import main as serve_main
    from eovax_torch.parallel.mesh import DeviceMesh
    from eovax_torch.serving import server as server_mod

    with pytest.raises(ValueError, match="act_scales requires an int8-policy model"):
        export_model(models[1], str(tmp_path / "q"), modalities=("S2RGB",), resolution=32,
                     act_scales={"encoder.conv_in": 1.0})
    with pytest.raises(ValueError, match="1-D mesh"):
        served.with_mesh(DeviceMesh((torch.device("cpu"),) * 4, (2, 2), ("data", "model")))

    class _Stop(Exception):
        pass

    def stop(*_a, **_k):  # the server is made: stop before it serves
        raise _Stop

    monkeypatch.setattr(server_mod, "make_server", stop)
    with pytest.raises(_Stop):
        serve_main([artifact[0], "--mesh", "--device", "cpu", "--warmup", "3"])
    out = capsys.readouterr().out
    assert "data-parallel over 1 devices" in out and "ROADMAP" not in out


def test_entry_points_default_to_cuda_and_raise_without_it(artifact, monkeypatch, tmp_path):
    from eovax_torch.cli.export import main as export_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServedModel.load(artifact[0])
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(_YAML))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_main(["--config", str(tmp_path / "c.yaml"), "--output", str(tmp_path / "a")])


def test_a_jax_artifact_is_refused(models, artifact, tmp_path):
    bad = tmp_path / "jax"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({**artifact[1], "format": "eovax-serving-v1"}))
    with pytest.raises(ValueError, match="eovax-torch-serving-v1"):
        ServedModel.load(str(bad), device="cpu")


# ---------------------------------------------------------------------------
# The daemon and the CLIs
# ---------------------------------------------------------------------------


def _npy(x) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


class _Serving:
    """``make_server`` on a thread, shut down and closed on exit."""

    def __init__(self, served, **kw):
        from eovax_torch.serving.server import make_server

        self.httpd = make_server(served, port=0, **kw)
        self.port = self.httpd.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.thread.join(timeout=10)
        self.httpd.server_close()

    def post(self, path, body, timeout=120):
        req = urllib.request.Request(f"{self.base}{path}", data=body)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            assert r.headers["Content-Type"] == "application/x-npy"
            return np.load(io.BytesIO(r.read()), allow_pickle=False)

    def get(self, path):
        with urllib.request.urlopen(f"{self.base}{path}", timeout=30) as r:
            return json.load(r)


def test_http_server_round_trip(served):
    """healthz/manifest, the .npy round trip matching the direct call, 404 on
    an unknown function or modality, 400 on a malformed payload, a wrong
    per-sample shape or a bad seed, /metrics, and keep-alive after errors."""
    import http.client

    from eovax_torch.serving.server import warmup

    assert "reconstruct.S2RGB@2" in warmup(served, batch_sizes=(2,))
    x = _x(2, seed=2)
    body = _npy(x)
    ref = served.reconstruct(x, modality="S2RGB").numpy()
    with _Serving(served) as srv:
        assert srv.get("/healthz")["status"] == "ok"
        assert srv.get("/v1/manifest")["format"] == "eovax-torch-serving-v1"
        np.testing.assert_allclose(srv.post("/v1/reconstruct?modality=S2RGB", body), ref,
                                   atol=1e-6)
        for path, code in (("/v1/nope", 404), ("/v1/reconstruct?modality=S1RTC", 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                srv.post(path, body, timeout=30)
            assert ei.value.code == code
        with pytest.raises(urllib.error.HTTPError) as ei:
            srv.post("/v1/reconstruct?modality=S2RGB", b"not npy", timeout=30)
        assert ei.value.code == 400
        m = srv.get("/metrics")["reconstruct"]
        assert m["count"] == 2 and m["errors"] == 1 and m["p50_ms"] > 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            srv.post("/v1/reconstruct?modality=S2RGB", _npy(x[:, :, :16, :16]), timeout=30)
        assert ei.value.code == 400 and b"per-sample shape" in ei.value.read()

        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            conn.request("POST", "/v1/nope", body=body)
            r1 = conn.getresponse()
            assert r1.status == 404 and r1.read()
            conn.request("POST", "/v1/reconstruct?modality=S2RGB&seed=abc", body=body)
            r2 = conn.getresponse()
            assert r2.status == 400 and b"seed" in r2.read()
            conn.request("POST", "/v1/reconstruct?modality=S2RGB", body=body)
            r3 = conn.getresponse()
            assert r3.status == 200
            np.testing.assert_allclose(np.load(io.BytesIO(r3.read())), ref, atol=1e-6)
        finally:
            conn.close()


@pytest.mark.parametrize("max_batch", [0, 8])
def test_http_server_concurrent_requests(served, max_batch):
    """4 threads x 3 posts all succeed with the direct call's result, with and
    without micro-batching, and /metrics counts exactly 12."""
    x = _x(1, seed=5)
    body = _npy(x)
    ref = served.reconstruct(x, modality="S2RGB").numpy()
    errors = []
    with _Serving(served, max_batch=max_batch, batch_wait_ms=20.0) as srv:
        def client(n):
            try:
                for _ in range(n):
                    y = srv.post("/v1/reconstruct?modality=S2RGB", body)
                    np.testing.assert_allclose(y, ref, atol=1e-5)
            except Exception as e:  # propagate to the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(3,)) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not errors, errors
        m = srv.get("/metrics")
        assert m["reconstruct"]["count"] == 12 and m["reconstruct"]["errors"] == 0
        assert ("_batching" in m) == bool(max_batch)


def test_serve_cli_starts_answers_and_stops_on_sigterm(artifact, served):
    """``python -m eovax_torch.cli.serve`` as a process: it prints its address,
    answers /healthz and a request, and exits 0 on SIGTERM after shutting down."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "eovax_torch.cli.serve", artifact[0], "--port", "0",
         "--device", "cpu", "--max-batch", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    watchdog = threading.Timer(120, proc.kill)  # a server that never starts stops the read
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving "), (lines, proc.stderr.read())
        base = lines[-1].split(" on ")[1].split("/v1/")[0]
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        x = _x(1, seed=8)
        req = urllib.request.Request(f"{base}/v1/reconstruct?modality=S2RGB", data=_npy(x))
        with urllib.request.urlopen(req, timeout=120) as r:
            y = np.load(io.BytesIO(r.read()))
        ref = served.reconstruct(x, modality="S2RGB")
        np.testing.assert_allclose(y, ref.numpy(), atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "shut down" in rest
        assert any(line.startswith("warmed ") for line in lines)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_serve_cli_restores_the_sigterm_handler(artifact, capsys, monkeypatch):
    """In process: load → warmup → make_server → serve_forever, then the
    listening socket is closed and the SIGTERM handler restored."""
    from eovax_torch.cli.serve import main as serve_main
    from eovax_torch.serving import server as server_mod

    started = {}
    real_make_server = server_mod.make_server

    def capture_make_server(served, **kw):
        started["httpd"] = real_make_server(served, **kw)
        return started["httpd"]

    def serve_one_then_return(self):
        port = self.server_address[1]

        def probe():
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                started["health"] = json.load(r)["status"]

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        self.handle_request()
        t.join(timeout=10)

    prev_term = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(server_mod, "make_server", capture_make_server)
    monkeypatch.setattr("http.server.HTTPServer.serve_forever", serve_one_then_return)
    serve_main([artifact[0], "--port", "0", "--warmup", "1", "--device", "cpu"])
    monkeypatch.undo()
    out_text = capsys.readouterr().out
    assert "warmed" in out_text and "shut down" in out_text
    assert started["health"] == "ok"
    assert started["httpd"].socket.fileno() == -1
    assert signal.getsignal(signal.SIGTERM) is prev_term


def test_warmup_function_filter():
    """warmup(functions=...) restricts the warm calls to those functions."""
    from eovax_torch.serving.server import warmup

    class _Fake:
        _manifest = {"functions": {
            "reconstruct.S2L2A": {"input_shape": [1, 3, 8, 8], "modality": "S2L2A"},
            "super_resolve.S2RGB": {"input_shape": [1, 4, 16, 16], "modality": "S2RGB"},
        }}

        def __init__(self):
            self.calls = []

        def reconstruct(self, x, modality=None):
            self.calls.append(("reconstruct", int(x.shape[0])))

        def super_resolve(self, x, seed=0):
            self.calls.append(("super_resolve", int(x.shape[0])))

    f = _Fake()
    assert warmup(f, batch_sizes=(1, 2), functions={"reconstruct"}) == [
        "reconstruct.S2L2A@1", "reconstruct.S2L2A@2"]
    assert f.calls == [("reconstruct", 1), ("reconstruct", 2)]
    assert sorted(warmup(_Fake(), batch_sizes=(1,))) == [
        "reconstruct.S2L2A@1", "super_resolve.S2RGB@1"]


def test_npy_frame_bit_identical_to_np_save():
    """The zero-copy response framing is byte-identical to np.save, with the
    fp32 wire cast for bf16 tensors and non-contiguous inputs."""
    from eovax_torch.serving.server import _npy_frame

    g = np.random.default_rng(0)
    cases = [
        g.standard_normal((2, 3, 8, 8)).astype(np.float32),
        g.standard_normal((4, 5)).astype(np.float64),
        torch.from_numpy(g.standard_normal((2, 4, 4, 3)).astype(np.float32)).bfloat16(),
        np.transpose(g.standard_normal((2, 3, 4)).astype(np.float32), (2, 0, 1)),
        torch.arange(6, dtype=torch.int32).reshape(2, 3),
    ]
    for arr in cases:
        header, out = _npy_frame(arr)
        wire = header + bytes(out.data)
        ref_arr = arr.float().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        if ref_arr.dtype not in (np.float32, np.float64):
            ref_arr = ref_arr.astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, ref_arr)
        assert wire == buf.getvalue()


def test_npy_parse_zero_copy_and_rejections():
    from eovax_torch.serving.server import _npy_parse

    a = np.random.default_rng(1).standard_normal((3, 2, 5)).astype(np.float32)
    raw = _npy(a)
    x = _npy_parse(raw)
    np.testing.assert_array_equal(x, a)
    assert not x.flags.writeable and x.base is not None
    np.testing.assert_array_equal(_npy_parse(_npy(np.asfortranarray(a))), a)
    buf = io.BytesIO()
    np.save(buf, np.array([{"x": 1}], dtype=object), allow_pickle=True)
    with pytest.raises(ValueError):
        _npy_parse(buf.getvalue())
    with pytest.raises(ValueError):
        _npy_parse(raw[: len(raw) - 8])
    with pytest.raises(Exception):
        _npy_parse(b"not an npy at all")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _port_model(device, policy):
    """The tiny model with weights from a torch seed (no JAX), on ``device``."""
    from eovax_torch.core.precision import FULL_PRECISION

    cpu = EOFluxVAE(_cfg(tcfg), device="cpu", seed=3, policy=FULL_PRECISION)
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        for p in cpu.core.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return cpu, EOFluxVAE(_cfg(tcfg), cpu.core.state_dict(), device=device, policy=policy)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 1e-1)],
                         ids=["fp32", "bf16"])
def test_artifact_on_the_card(cuda_device, tmp_path, dtype, tol):
    """The tiny artifact exported and served on the card: bit-identical to the
    live model there, within ``tol`` of fp32 on the CPU (relative to max), and
    each call launches the hand kernels as often as the graph holds their ops;
    an artifact exported on the CPU loads onto the card."""
    from eovax_torch.core.precision import FULL_PRECISION, Policy
    from eovax_torch.kernels import attention, conv3x3, groupnorm

    FULL_PRECISION.activate()
    cpu, card = _port_model(cuda_device, Policy(compute_dtype=dtype))
    export_model(card, str(tmp_path / "card"), modalities=("S2RGB",), resolution=32)
    export_model(cpu, str(tmp_path / "cpu"), modalities=("S2RGB",), resolution=32,
                 functions=("reconstruct",))
    served = ServedModel.load(str(tmp_path / "card"))
    x = _x(3, seed=6)
    program = torch.export.load(str(tmp_path / "card" / "reconstruct.S2RGB.pt2"))
    ops = Counter(str(n.target) for n in program.graph.nodes)
    conv3x3.conv3x3.launches = groupnorm.group_norm.launches = 0
    attention.flash_attention.launches = 0
    y = served.reconstruct(x, modality="S2RGB")
    torch.cuda.synchronize()
    assert (conv3x3.conv3x3.launches, groupnorm.group_norm.launches,
            attention.flash_attention.launches) == (
        ops["eovax.conv3x3.default"], ops["eovax.group_norm.default"],
        ops["eovax.flash_attention.default"])
    assert torch.equal(y, card.reconstruct(x, WVS))
    assert _rel(y.float().cpu(), cpu.reconstruct(x, WVS)) <= tol
    moved = ServedModel.load(str(tmp_path / "cpu"))
    if dtype == torch.float32:
        assert torch.equal(moved.reconstruct(x, modality="S2RGB"), y)
