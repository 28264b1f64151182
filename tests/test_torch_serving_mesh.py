"""The port's data-parallel serving (``ServedModel.with_mesh``) on the CPU: an
8-entry mesh of the host against the JAX package's ``with_mesh`` on its 8 host
devices (same weights), each row block equal to the single-device call on it,
the undivided batch, the 1-D check, the SR pipeline's seeds split with the
rows, the micro-batcher's buckets against the JAX package's under a mesh, the
dynamic-int8 refusal with the per-shard range it would change, and
``serve --mesh`` as a process.

A mesh may repeat a device: ``make_device_mesh(["cpu"] * 8)`` splits a batch
into 8 row blocks that run one after another on the host, as the JAX tests'
8 host devices do. The tiny VAE and UNet are ``tests/test_torch_serving.py``'s
and ``tests/test_torch_serving_sr.py``'s, the 128-channel int8 model
``tests/test_torch_serving_int8.py``'s. JAX is imported inside the tests that
need it; the ``gpu`` case runs on the card without it:

    python -m pytest tests/test_torch_serving_mesh.py -m gpu --noconftest
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import test_torch_serving as ts
from eovax_torch.parallel.mesh import DeviceMesh, make_device_mesh
from eovax_torch.serving import MicroBatcher, ServedModel, export_model, export_sr_pipeline
from test_torch_serving import ROOT, TOL_JAX, WVS, _npy, _rel, _x

models = ts.models  # the module-scoped fixtures, shared by name
artifact = ts.artifact
served = ts.served


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh8():
    return make_device_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def sharded(served, mesh8):
    return served.with_mesh(mesh8)


def _blockwise(served, name: str, x: np.ndarray, n: int) -> torch.Tensor:
    """The single-device calls on each of ``n`` equal row blocks of ``x``."""
    rows = len(x) // n
    return torch.cat([getattr(served, name)(x[i * rows:(i + 1) * rows], modality="S2RGB")
                      for i in range(n)])


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_make_device_mesh_and_its_checks():
    """Every visible card by default (none here: it raises), or the given
    devices in order, repeats allowed; the shape must hold the devices."""
    mesh = make_device_mesh(["cpu", torch.device("cpu")], axis="batch")
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.size == 2
    assert mesh.shape == (2,) and mesh.axis_names == ("batch",)
    assert make_device_mesh(["cuda", "cuda:1"]).devices == (torch.device("cuda", 0),
                                                            torch.device("cuda", 1))
    with pytest.raises(ValueError, match="cannot take the shape"):
        DeviceMesh((torch.device("cpu"),) * 4, (2, 3), ("a", "b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_device_mesh()


def test_with_mesh_matches_the_jax_mesh(models, served, sharded, tmp_path):
    """The port's 8-entry mesh against the JAX package's ``with_mesh`` on its 8
    host devices, on artifacts of the same weights (≤ 1e-4 relative to max), at
    a batch the device count divides (8, 16) and at one it does not (3)."""
    import jax

    from eovax.parallel.mesh import DATA_AXIS, make_mesh
    from eovax.serving import ServedModel as JaxServed
    from eovax.serving import export_model as jax_export

    jax_export(models[0], str(tmp_path), modalities=("S2RGB",), resolution=32)
    mesh = make_mesh()
    assert mesh.shape[DATA_AXIS] == 8 == len(jax.devices())
    ref = JaxServed.load(str(tmp_path)).with_mesh(mesh)
    for b in (8, 16, 3):
        x = _x(b, seed=30 + b)
        for name in ("reconstruct", "encode_spatial_normalized"):
            got = getattr(sharded, name)(x, modality="S2RGB")
            assert got.shape[0] == b
            assert _rel(got, getattr(ref, name)(x, modality="S2RGB")) <= TOL_JAX, (name, b)
    z = np.asarray(ref.encode_spatial_normalized(_x(8, seed=40), modality="S2RGB"))
    got = sharded.decode_spatial_normalized(z, modality="S2RGB")
    assert _rel(got, ref.decode_spatial_normalized(z, modality="S2RGB")) <= TOL_JAX


@pytest.mark.parametrize("b", [8, 16])
def test_row_blocks_equal_the_single_device_calls(served, sharded, b):
    """Each device's rows are the single-device call on that block, bit for bit,
    for every function; the result is gathered on the mesh's first device."""
    x = _x(b, seed=b)
    for name in ("reconstruct", "encode_spatial_normalized"):
        got = getattr(sharded, name)(x, modality="S2RGB")
        assert got.device == torch.device("cpu")
        assert torch.equal(got, _blockwise(served, name, x, 8)), name
    z = served.encode_spatial_normalized(x, modality="S2RGB").numpy()
    assert torch.equal(sharded.decode_spatial_normalized(z, modality="S2RGB"),
                       _blockwise(served, "decode_spatial_normalized", z, 8))


def test_undivided_batch_runs_whole_on_the_first_device(served, sharded):
    """A batch the device count does not divide is the single-device call (the
    JAX package's replicated branch), not blocks of it."""
    for b in (1, 3, 12):
        x = _x(b, seed=50 + b)
        assert torch.equal(sharded.reconstruct(x, modality="S2RGB"),
                           served.reconstruct(x, modality="S2RGB")), b


def test_with_mesh_is_1d_any_axis_name_and_shares_what_it_can(served):
    """Any axis name; a 2-D mesh raises as the JAX package's does. A repeated
    device is served by the loaded model itself: one copy of the weights and
    one set of graphs, its own; a view of a view is a view of that model."""
    view = served.with_mesh(make_device_mesh(["cpu"] * 4, axis="batch"))
    assert view.reconstruct(np.zeros((4, 3, 32, 32), np.float32),
                            modality="S2RGB").shape == (4, 3, 32, 32)
    assert view._models == {torch.device("cpu"): served}
    assert view._state is served._state and view._fns is served._fns
    assert served._programs is None and "reconstruct.S2RGB" in served._fns
    assert view.with_mesh(make_device_mesh(["cpu"] * 2))._models == {torch.device("cpu"): served}
    assert view.modalities == served.modalities and view.input_shape("reconstruct", "S2RGB")
    with pytest.raises(ValueError, match="1-D mesh"):
        served.with_mesh(DeviceMesh((torch.device("cpu"),) * 8, (4, 2), ("a", "b")))
    with pytest.raises(KeyError, match="not in artifact"):
        view.reconstruct(np.zeros((4, 2, 32, 32), np.float32), modality="S1RTC")


def test_replicas_on_another_device_get_their_own_state_and_moved_graphs(artifact, served):
    """A mesh device other than the loaded model's gets a copy of the weights
    there and graphs moved there from programs loaded once for all such devices
    and copied before the move, which leaves them as loaded (here the meta
    device stands for a second card: the move and the copy, no compute)."""
    view = served.with_mesh(make_device_mesh(["cpu", "meta"]))
    meta = view._models[torch.device("meta")]
    assert meta is not served and meta._programs is not None
    assert all(t.device.type == "meta" for t in meta._state.values())
    fn = meta._fn("reconstruct", "S2RGB")
    assert fn is not served._fn("reconstruct", "S2RGB")
    assert all(b.device.type == "meta" for b in fn.buffers())
    assert all(b.device.type == "cpu" for b in served._fn("reconstruct", "S2RGB").buffers())
    loaded = meta._programs["reconstruct.S2RGB"]
    assert all(b.device.type == "cpu" for b in loaded.module().buffers())


# ---------------------------------------------------------------------------
# The SR pipeline: seeds split with the rows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sr_served(models, tmp_path_factory):
    """A DDIM-4 SR artifact of the tiny VAE and a tiny UNet (torch-seeded)."""
    from eovax_torch.models.sr_diffusion import RectifiedSchedule, SimpleDenoiser
    from eovax_torch.models.unet import UNet
    from test_torch_serving_sr import UNET_KW

    torch.manual_seed(7)
    unet = UNet(**UNET_KW).eval()
    out = tmp_path_factory.mktemp("sr")
    export_sr_pipeline(models[1], SimpleDenoiser(RectifiedSchedule()), unet, str(out),
                       resolution=32, steps=4, sampler="ddim", wvs=WVS)
    return ServedModel.load(str(out), device="cpu")


def test_sr_seeds_split_with_the_rows(sr_served):
    """Over a 4-entry mesh, row i of a B = 4 call is the B = 1 call with seed
    7 + i bit for bit, and a B = 8 call is the single-device calls on its row
    blocks with their seeds; an undivided batch is the single-device call."""
    view = sr_served.with_mesh(make_device_mesh(["cpu"] * 4))
    x = _x(8, seed=60)
    y4 = view.super_resolve(x[:4], seed=7)
    for i in range(4):
        assert torch.equal(y4[i:i + 1], sr_served.super_resolve(x[i:i + 1], seed=7 + i)), i
    seeds = [3, -5, 11, 2**31 - 1, 0, 9, 4, 8]
    y8 = view.super_resolve(x, seed=seeds)
    ref = torch.cat([sr_served.super_resolve(x[i:i + 2], seed=seeds[i:i + 2])
                     for i in range(0, 8, 2)])
    assert torch.equal(y8, ref)
    assert torch.equal(view.super_resolve(x[:3], seed=1), sr_served.super_resolve(x[:3], seed=1))
    with pytest.raises(ValueError, match="one seed per sample"):
        view.super_resolve(x[:4], seed=[1, 2])


# ---------------------------------------------------------------------------
# The micro-batcher under a mesh
# ---------------------------------------------------------------------------


def test_microbatcher_buckets_equal_the_jax_batchers_under_a_mesh(models, served, sharded,
                                                                  tmp_path):
    """Buckets rounded to device-count multiples exactly as the JAX package's
    ``MicroBatcher`` rounds them over its 8-device mesh (its oversize bucket
    too); a coalesced B = 1 request pads to the 8-row bucket, splits, and
    returns the direct call's rows."""
    from eovax.parallel.mesh import make_mesh
    from eovax.serving import MicroBatcher as JaxBatcher
    from eovax.serving import ServedModel as JaxServed
    from eovax.serving import export_model as jax_export

    jax_export(models[0], str(tmp_path), modalities=("S2RGB",), resolution=32,
               functions=("reconstruct",))
    jax_view = JaxServed.load(str(tmp_path)).with_mesh(make_mesh())
    for max_batch in (2, 8, 12, 16, 40):
        ours = MicroBatcher(sharded, threading.Lock(), max_batch=max_batch)
        ref = JaxBatcher(jax_view, threading.Lock(), max_batch=max_batch)
        try:
            assert ours.buckets == ref.buckets, max_batch
            assert [ours._bucket(n) for n in range(1, 50)] == [ref._bucket(n)
                                                               for n in range(1, 50)]
        finally:
            ours.close()
            ref.close()
    mb = MicroBatcher(sharded, threading.Lock(), max_batch=16, max_wait_ms=20.0)
    try:
        assert mb.buckets == [8, 16]
        x = _x(1, seed=70)
        y = mb.submit("reconstruct", "S2RGB", x)
        np.testing.assert_array_equal(y, served.reconstruct(x, modality="S2RGB").numpy())
        s = mb.stats()["reconstruct"]
        assert s["samples"] == 1 and s["pad_waste_pct"] == 87.5  # 1 of 8
    finally:
        mb.close()


# ---------------------------------------------------------------------------
# int8: calibrated artifacts split, dynamic ones are refused
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_artifacts(tmp_path_factory):
    """{"dynamic", "calibrated"}: int8 ``reconstruct`` artifacts of the
    128-channel model (torch-seeded), static ranges from two batches."""
    from eovax_torch.core import config as tcfg
    from eovax_torch.core.precision import INT8_POLICY
    from eovax_torch.models.eo_flux_vae import EOFluxVAE
    from eovax_torch.serving import calibrate_activations
    from test_torch_qconv import vae_cfg

    model = EOFluxVAE(vae_cfg(tcfg), policy=INT8_POLICY, device="cpu", seed=2)
    scales = calibrate_activations(model, [_x(2, seed=80), _x(2, seed=81)], modality="S2RGB")
    root = tmp_path_factory.mktemp("int8")
    for kind, extra in (("dynamic", {}), ("calibrated", {"act_scales": scales})):
        export_model(model, str(root / kind), modalities=("S2RGB",), resolution=32,
                     functions=("reconstruct",), **extra)
    return {k: ServedModel.load(str(root / k), device="cpu") for k in ("dynamic", "calibrated")}


def test_dynamic_int8_is_refused_and_its_range_is_per_batch(int8_artifacts):
    """A dynamic-range int8 artifact is refused over a mesh of more than one
    device (one device does not split), because a split would change the
    result: each block would take the activation range of its own rows, and the
    blocks' calls differ from the whole batch's (the JAX package's mesh takes
    the range over the whole sharded batch). A calibrated artifact's static
    ranges split exactly."""
    dyn, cal = int8_artifacts["dynamic"], int8_artifacts["calibrated"]
    with pytest.raises(ValueError, match="--calibrate-npz"):
        dyn.with_mesh(make_device_mesh(["cpu"] * 2))
    assert dyn.with_mesh(make_device_mesh(["cpu"]))._mesh.size == 1
    x = _x(2, seed=90)
    x[1] *= 3.0  # a second row with a wider range
    whole = dyn.reconstruct(x, modality="S2RGB")
    blocks = torch.cat([dyn.reconstruct(x[i:i + 1], modality="S2RGB") for i in range(2)])
    assert not torch.equal(whole, blocks)
    view = cal.with_mesh(make_device_mesh(["cpu"] * 2))
    got = view.reconstruct(x, modality="S2RGB")
    assert torch.equal(got, cal.reconstruct(x, modality="S2RGB"))
    assert torch.equal(got, torch.cat([cal.reconstruct(x[i:i + 1], modality="S2RGB")
                                       for i in range(2)]))


# ---------------------------------------------------------------------------
# serve --mesh
# ---------------------------------------------------------------------------


def test_serve_cli_mesh_as_a_process(artifact, served):
    """``serve --mesh --device cpu``: a one-device mesh of the host, announced
    and warmed at a multiple of its size; it answers a request with the direct
    call's result and exits 0 on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "eovax_torch.cli.serve", artifact[0], "--port", "0",
         "--device", "cpu", "--mesh", "--max-batch", "4"],
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
        assert "data-parallel over 1 devices\n" in lines
        base = lines[-1].split(" on ")[1].split("/v1/")[0]
        x = _x(1, seed=95)
        req = urllib.request.Request(f"{base}/v1/reconstruct?modality=S2RGB", data=_npy(x))
        with urllib.request.urlopen(req, timeout=120) as r:
            y = np.load(io.BytesIO(r.read()))
        np.testing.assert_array_equal(y, served.reconstruct(x, modality="S2RGB").numpy())
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            assert json.load(r)["reconstruct"]["count"] == 1
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "shut down" in rest
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mesh_of_the_card_repeated(cuda_device, tmp_path, dtype):
    """The tiny artifact over a mesh of the card twice: each row block equals the
    single-card call on it bit for bit, and the call launches each hand kernel
    as often as the blocks' calls do; over every visible card likewise."""
    from eovax_torch.core.precision import FULL_PRECISION, Policy
    from eovax_torch.kernels import attention, conv3x3, groupnorm

    FULL_PRECISION.activate()
    _, card = ts._port_model(cuda_device, Policy(compute_dtype=dtype))
    export_model(card, str(tmp_path), modalities=("S2RGB",), resolution=32)
    served = ServedModel.load(str(tmp_path))
    kernels = (conv3x3.conv3x3, groupnorm.group_norm, attention.flash_attention)

    def counted(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [k.launches for k in kernels]

    x = _x(4, seed=100)
    (y0, n0), (y1, n1) = (counted(lambda: served.reconstruct(x[i:i + 2], modality="S2RGB"))
                          for i in (0, 2))
    view = served.with_mesh(make_device_mesh([cuda_device] * 2))
    y, n = counted(lambda: view.reconstruct(x, modality="S2RGB"))
    assert n == [a + b for a, b in zip(n0, n1)] and min(n) > 0
    assert torch.equal(y, torch.cat([y0, y1]))
    cards = torch.cuda.device_count()
    x = _x(2 * cards, seed=101)
    y = served.with_mesh(make_device_mesh()).reconstruct(x, modality="S2RGB")
    assert y.device == cuda_device
    assert torch.equal(y, torch.cat([served.reconstruct(x[i:i + 2], modality="S2RGB")
                                     for i in range(0, 2 * cards, 2)]))
