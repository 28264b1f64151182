"""The port's MicroBatcher and daemon (``eovax_torch.serving``) held to what
``tests/test_batching.py`` holds the JAX package's to: a fake ServedModel
exercises the coalescing, bucketing, error isolation and lifecycle fast,
and an HTTP test runs a real exported artifact of a tiny model on the CPU.

Correctness contract: every concurrent client gets exactly the result a
direct ServedModel call on its own input would return, regardless of how
requests were coalesced, padded, or bucketed.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch

from eovax_torch.serving.batching import MicroBatcher, to_host


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _FakeServed:
    """Per-sample-deterministic stand-in: y[i] depends only on x[i], so
    any batching/padding that leaks across samples breaks the tests."""

    def __init__(self):
        self.calls = []  # (name, modality, batch_size)
        self._lock = threading.Lock()

    def reconstruct(self, x, modality="S2L2A"):
        if modality not in ("S2RGB", "S2L2A"):
            raise KeyError(f"modality {modality!r} not in artifact")
        with self._lock:
            self.calls.append(("reconstruct", modality, x.shape[0]))
        return x * 2.0 + (1.0 if modality == "S2RGB" else 0.0)

    def encode_spatial_normalized(self, x, modality="S2L2A"):
        with self._lock:
            self.calls.append(("encode", modality, x.shape[0]))
        return -x


def _batcher(served=None, **kw):
    served = served or _FakeServed()
    return served, MicroBatcher(served, threading.Lock(), **kw)


def test_coalesces_concurrent_requests_and_routes_results():
    served, mb = _batcher(max_batch=8, max_wait_ms=200.0)
    xs = [np.full((1, 3, 4, 4), float(i), np.float32) for i in range(6)]
    results = [None] * 6

    def client(i):
        results[i] = mb.submit("reconstruct", "S2RGB", xs[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(6):
        np.testing.assert_array_equal(results[i], xs[i] * 2.0 + 1.0)
    # All 6 should coalesce into far fewer device calls (the 200 ms
    # window is huge relative to thread startup); every dispatched batch
    # is a ladder bucket.
    assert len(served.calls) < 6
    assert all(b in (1, 2, 4, 8) for _, _, b in served.calls)
    s = mb.stats()["reconstruct"]
    assert s["requests"] == 6 and s["samples"] == 6
    assert s["max_samples_per_batch"] >= 2
    mb.close()


def test_pads_to_bucket_and_slices_result():
    served, mb = _batcher(max_batch=8, max_wait_ms=500.0)
    out = [None, None]
    barrier = threading.Barrier(3)

    def client(i, x):
        barrier.wait()
        out[i] = mb.submit("reconstruct", "S2L2A", x)

    x0 = np.ones((1, 2, 2, 2), np.float32)
    x1 = np.full((2, 2, 2, 2), 3.0, np.float32)
    t0 = threading.Thread(target=client, args=(0, x0))
    t1 = threading.Thread(target=client, args=(1, x1))
    t0.start(); t1.start(); barrier.wait()
    t0.join(timeout=60); t1.join(timeout=60)
    np.testing.assert_array_equal(out[0], x0 * 2.0)
    np.testing.assert_array_equal(out[1], x1 * 2.0)
    # 3 samples pad to the 4-bucket (when coalesced into one dispatch).
    assert all(b in (1, 2, 4) for _, _, b in served.calls)
    if len(served.calls) == 1:
        assert served.calls[0][2] == 4
        assert mb.stats()["reconstruct"]["pad_waste_pct"] == 25.0
    mb.close()


def test_oversize_request_passes_through_whole():
    served, mb = _batcher(max_batch=4, max_wait_ms=1.0)
    x = np.arange(7 * 2 * 2 * 2, dtype=np.float32).reshape(7, 2, 2, 2)
    y = mb.submit("reconstruct", "S2L2A", x)
    np.testing.assert_array_equal(y, x * 2.0)
    assert served.calls == [("reconstruct", "S2L2A", 7)]
    mb.close()


def test_keys_isolate_modalities_shapes_and_errors():
    served, mb = _batcher(max_batch=8, max_wait_ms=100.0)
    ok, errs = {}, {}

    def good(i, modality, shape):
        x = np.full(shape, float(i), np.float32)
        ok[i] = (mb.submit("reconstruct", modality, x),
                 x * 2.0 + (1.0 if modality == "S2RGB" else 0.0))

    def bad(i):
        try:
            mb.submit("reconstruct", "NOPE",
                      np.zeros((1, 3, 4, 4), np.float32))
        except KeyError as e:
            errs[i] = e

    threads = (
        [threading.Thread(target=good, args=(i, "S2RGB", (1, 3, 4, 4)))
         for i in range(2)]
        + [threading.Thread(target=good, args=(i, "S2L2A", (1, 3, 8, 8)))
           for i in range(2, 4)]
        + [threading.Thread(target=bad, args=(i,)) for i in range(2)]
    )
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # Bad-modality requests fail with KeyError; every good request is
    # untouched by them (separate key -> separate batch).
    assert len(errs) == 2
    for got, want in ok.values():
        np.testing.assert_array_equal(got, want)
    # No dispatched batch ever mixed modalities or shapes: per-call batch
    # sizes must be consistent with single-key coalescing only.
    assert all(m in ("S2RGB", "S2L2A", "NOPE") for _, m, _ in served.calls)
    mb.close()


def test_submit_rejects_empty_and_scalar():
    _, mb = _batcher(max_batch=4)
    with pytest.raises(ValueError):
        mb.submit("reconstruct", None, np.float32(3.0))
    with pytest.raises(ValueError):
        mb.submit("reconstruct", None, np.zeros((0, 3, 4, 4), np.float32))
    mb.close()


def test_default_modality_matches_method_default():
    served, mb = _batcher(max_batch=4, max_wait_ms=1.0)
    x = np.ones((1, 2, 2, 2), np.float32)
    y = mb.submit("reconstruct", None, x)
    np.testing.assert_array_equal(y, x * 2.0)  # S2L2A default: no +1
    assert served.calls[0][1] == "S2L2A"
    mb.close()


def test_close_drains_then_rejects():
    _, mb = _batcher(max_batch=4, max_wait_ms=1.0)
    x = np.ones((1, 2, 2, 2), np.float32)
    mb.submit("reconstruct", "S2L2A", x)  # spin up the key thread
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit("reconstruct", "S2L2A", x)


def test_mesh_rounds_buckets_to_device_multiples():
    """Under ServedModel.with_mesh, a batch not divisible by the device
    count replicates (1/N efficiency) — every bucket, including the
    oversize fallback, must be a device-count multiple."""
    served = _FakeServed()
    served._mesh = type("M", (), {"devices": np.zeros(8)})()
    mb = MicroBatcher(served, threading.Lock(), max_batch=16,
                      max_wait_ms=1.0)
    assert mb.buckets == [8, 16]
    assert mb._bucket(1) == 8 and mb._bucket(9) == 16
    assert mb._bucket(17) == 24  # oversize: next multiple of 8
    y = mb.submit("reconstruct", "S2L2A", np.ones((1, 2, 2, 2), np.float32))
    np.testing.assert_array_equal(y, np.ones((1, 2, 2, 2), np.float32) * 2.0)
    assert served.calls[0][2] == 8  # B=1 padded to the sharded bucket
    mb.close()


def test_pad_rows_sliced_off_before_host_fetch():
    """The dispatcher must slice pad rows off while the result is still
    a device array: D2H cost scales with real samples, not bucket size
    (fetching pad rows measurably erased the batching win on D2H-bound
    hosts — ARCHITECTURE.md round-4 serving notes)."""
    fetched_rows = []

    class _DeviceArray:  # records the batch size at host-fetch time
        def __init__(self, a):
            self._a = a

        def __getitem__(self, s):
            return _DeviceArray(self._a[s])

        def __array__(self, dtype=None, copy=None):
            fetched_rows.append(self._a.shape[0])
            return self._a

    class _DeviceServed:
        def reconstruct(self, x, modality="S2L2A"):
            return _DeviceArray(np.asarray(x) * 2.0)

    mb = MicroBatcher(_DeviceServed(), threading.Lock(), max_batch=8,
                      max_wait_ms=200.0)
    xs = [np.full((1, 2, 2), float(i), np.float32) for i in range(3)]
    out = [None] * 3
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(
            i, mb.submit("reconstruct", None, xs[i]))) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(3):
        np.testing.assert_array_equal(out[i], xs[i] * 2.0)
    # Every host fetch was <= the real sample count of its batch (3 when
    # fully coalesced), never the padded 4-bucket.
    assert fetched_rows and all(r <= 3 for r in fetched_rows), fetched_rows
    mb.close()


def test_dtype_isolates_batches_and_rejects_non_numeric():
    """dtype is part of the coalescing key: a float64 request must not
    promote (or poison) a concurrent float32 batch, and a non-numeric
    payload is rejected before it can fail a coalesced device call."""
    served, mb = _batcher(max_batch=8, max_wait_ms=200.0)
    out = {}

    def client(i, dtype):
        x = np.full((1, 2, 2), float(i), dtype)
        out[i] = mb.submit("reconstruct", "S2L2A", x)

    threads = [threading.Thread(target=client, args=(0, np.float32)),
               threading.Thread(target=client, args=(1, np.float64))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert out[0].dtype == np.float32  # not promoted by the f64 peer
    assert out[1].dtype == np.float64
    with pytest.raises(ValueError, match="numeric dtype"):
        mb.submit("reconstruct", "S2L2A", np.array([["a", "b"]]))
    mb.close()


def test_idle_keys_reclaimed_and_key_reusable():
    """Clients choose the coalescing key (shape/dtype are theirs), so idle
    dispatcher threads must be reclaimed — a long-lived daemon fuzzed with
    distinct shapes would otherwise grow threads without bound."""
    served, mb = _batcher(max_batch=4, max_wait_ms=1.0,
                          idle_key_ttl_s=0.05)
    for i in range(3):  # distinct shapes -> distinct keys
        x = np.ones((1, 2, 2 + i), np.float32)
        np.testing.assert_array_equal(
            mb.submit("reconstruct", "S2L2A", x), x * 2.0)
    deadline = time.monotonic() + 5.0
    while mb._threads and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not mb._threads and not mb._queues  # all keys retired
    # A retired key comes back transparently on the next request.
    x = np.ones((1, 2, 2), np.float32)
    np.testing.assert_array_equal(
        mb.submit("reconstruct", "S2L2A", x), x * 2.0)
    mb.close()


def test_window_runs_from_request_arrival_not_dispatcher_wakeup():
    """A request that queued during a device call has already waited out
    (part of) its window — the dispatcher must not restart the full
    max_wait_ms window when it wakes up."""
    release = threading.Event()
    dispatch_times = []

    class _Blocking:
        def __init__(self):
            self.first = True

        def reconstruct(self, x, modality="S2L2A"):
            dispatch_times.append(time.monotonic())
            if self.first:
                self.first = False
                release.wait(timeout=30)
            return x * 2.0

    mb = MicroBatcher(_Blocking(), threading.Lock(), max_batch=2,
                      max_wait_ms=600.0)
    out = [None, None]
    # Two concurrent B=1s fill max_batch -> dispatch immediately (call 1,
    # blocked on `release`).
    t0 = threading.Thread(target=lambda: out.__setitem__(
        0, mb.submit("reconstruct", None,
                     np.ones((1, 2, 2), np.float32))))
    t1 = threading.Thread(target=lambda: out.__setitem__(
        1, mb.submit("reconstruct", None,
                     np.ones((1, 2, 2), np.float32))))
    t0.start(); t1.start()
    while not dispatch_times:
        time.sleep(0.005)
    # Queue a third request while call 1 is in flight, let it age past
    # the 600 ms window, then release call 1.
    t2 = threading.Thread(target=lambda: mb.submit(
        "reconstruct", None, np.ones((1, 2, 2), np.float32)))
    t2.start()
    time.sleep(0.7)
    released_at = time.monotonic()
    release.set()
    for t in (t0, t1, t2):
        t.join(timeout=60)
    assert len(dispatch_times) == 2
    # Call 2 must start (nearly) immediately after call 1 returns — the
    # old bug re-armed a fresh 600 ms window here.
    assert dispatch_times[1] - released_at < 0.3, \
        f"window re-armed: {dispatch_times[1] - released_at:.3f}s"
    mb.close()


def test_timed_out_request_is_withdrawn_not_dispatched():
    """submit() timeout must pull the request back off the queue — the
    dispatcher should never pay a device call for a client that already
    got its TimeoutError."""
    release = threading.Event()
    calls = []

    class _Blocking:
        def reconstruct(self, x, modality="S2L2A"):
            calls.append(int(x.shape[0]))
            if len(calls) == 1:
                release.wait(timeout=30)
            return x * 2.0

    mb = MicroBatcher(_Blocking(), threading.Lock(), max_batch=2,
                      max_wait_ms=1.0)
    # Fill call 1 (blocked) with a whole-batch request.
    t0 = threading.Thread(target=lambda: mb.submit(
        "reconstruct", None, np.ones((2, 2, 2), np.float32)))
    t0.start()
    while not calls:
        time.sleep(0.005)
    # This one queues behind the blocked call and times out first.
    with pytest.raises(TimeoutError):
        mb.submit("reconstruct", None, np.ones((1, 2, 2), np.float32),
                  timeout_s=0.15)
    release.set()
    t0.join(timeout=60)
    time.sleep(0.3)  # grace: a zombie dispatch would land here
    assert calls == [2], f"withdrawn request was dispatched: {calls}"
    mb.close()


def _post(port, path, arr):
    """POST an array as .npy; return (status, body bytes)."""
    import urllib.error
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=buf.getvalue(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_maps_client_input_errors_to_400():
    """Validation failures raised by the batched path (empty batch,
    non-numeric dtype) are the CLIENT's fault and must surface as 400,
    not 500 — monitoring counts 5xx as server faults."""
    from eovax_torch.serving.server import make_server

    httpd = make_server(_FakeServed(), port=0, max_batch=4)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        for bad in (np.zeros((0, 3, 4, 4), np.float32),  # empty batch
                    np.array([["a", "b"]])):             # non-numeric
            code, _ = _post(port, "/v1/reconstruct", bad)
            assert code == 400
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()


def test_out_of_int32_seed_is_400_not_500():
    """A seed past int32 bounds would overflow the int32 seed vector
    INSIDE the dispatch -> 500; it is a client
    mistake and must be rejected as 400 at parse time (same fault-class
    contract as the other pre-dispatch validations)."""
    from eovax_torch.serving.server import make_server

    class _SR:
        def super_resolve(self, x, seed=0):
            raise AssertionError("dispatch must not be reached")

    httpd = make_server(_SR(), port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        x = np.ones((1, 4, 8, 8), np.float32)
        for seed in (2**31, -(2**31) - 1, 10**19):
            code, body = _post(port, f"/v1/super_resolve?seed={seed}", x)
            assert code == 400, (seed, body)
            assert b"int32" in body
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()


def test_default_and_explicit_modality_coalesce_to_one_key():
    """Requests that spell out the served default modality and requests
    that omit it are identical work — they must share ONE batcher key
    (one dispatcher, one padded device call per window), not split into
    two half-full batches. The daemon resolves DEFAULT_MODALITY once in
    do_POST before keying."""
    from eovax_torch.serving.server import make_server

    class _WithDefault(_FakeServed):
        DEFAULT_MODALITY = "S2L2A"

    httpd = make_server(_WithDefault(), port=0, max_batch=4)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        x = np.ones((1, 3, 4, 4), np.float32)
        code, _ = _post(port, "/v1/reconstruct?modality=S2L2A", x)
        assert code == 200
        code, _ = _post(port, "/v1/reconstruct", x)
        assert code == 200
        keys = list(httpd.batcher._queues)
        assert len(keys) == 1 and keys[0][:2] == ("reconstruct", "S2L2A"), keys
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()


def test_bool_payload_contract_independent_of_batching():
    """Accepted input dtypes must not depend on the --max-batch tuning
    flag: a bool mask the UNBATCHED path accepts (ServedModel casts
    it to float32) must get the same 200 from a batched server
    — redeploying with --max-batch must not silently change the API."""
    from eovax_torch.serving.server import make_server

    for max_batch in (0, 4):
        httpd = make_server(_FakeServed(), port=0, max_batch=max_batch)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            code, body = _post(port, "/v1/reconstruct",
                               np.ones((1, 2, 2), bool))
            assert code == 200, (max_batch, body)
        finally:
            httpd.shutdown()
            t.join(timeout=10)
            httpd.server_close()


def test_server_side_valueerror_is_500_not_400():
    """A ValueError raised by the dispatch itself (a server fault — e.g. a
    graph traced for another device, or a state-dict mismatch) must surface
    as 500 so 5xx monitoring sees the outage — NOT be misreported as a
    client-input 400."""
    from eovax_torch.serving.server import make_server

    class _Broken:
        def reconstruct(self, x, modality="S2L2A"):
            raise ValueError(
                "graph traced on cuda:0 was given tensors on cpu")

    for max_batch in (0, 4):
        httpd = make_server(_Broken(), port=0, max_batch=max_batch)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            code, body = _post(port, "/v1/reconstruct",
                               np.ones((1, 2, 2), np.float32))
            assert code == 500, (max_batch, body)
            assert b"graph traced on cuda:0" in body
        finally:
            httpd.shutdown()
            t.join(timeout=10)
            httpd.server_close()


def test_dispatch_serializes_with_external_lock():
    """Batched device calls must hold the shared lock — the daemon relies
    on this to serialize with unbatched (super_resolve) dispatch."""
    lock = threading.Lock()
    seen = []

    class _LockProbe:
        def reconstruct(self, x, modality="S2L2A"):
            seen.append(lock.locked())
            return x

    mb = MicroBatcher(_LockProbe(), lock, max_batch=4, max_wait_ms=1.0)
    mb.submit("reconstruct", None, np.ones((1, 2), np.float32))
    assert seen == [True]
    mb.close()


def _tiny_artifact(out):
    from eovax_torch import EOFluxVAE
    from eovax_torch.core.config import DecoderConfig, EncoderConfig, StemConfig, VAEConfig
    from eovax_torch.serving import export_model

    stem = StemConfig(num_layers=1, wv_planes=64)
    kw = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              use_dynamic_ops=True, stem=stem)
    cfg = VAEConfig(encoder=EncoderConfig(in_channels=3, **kw),
                    decoder=DecoderConfig(out_ch=3, **kw))
    model = EOFluxVAE(cfg, device="cpu", seed=0)
    export_model(model, out, modalities=("S2RGB",), resolution=32,
                 functions=("reconstruct",))


def test_http_microbatching_end_to_end(tmp_path):
    """Full daemon with --max-batch semantics on a real artifact of a tiny
    model on the CPU: concurrent B=1 clients get the results of direct
    per-request calls, /metrics reports the coalescing, and closing the
    server stops the batching threads."""
    import json
    import urllib.request

    from eovax_torch.serving import ServedModel
    from eovax_torch.serving.server import make_server, warmup

    out = str(tmp_path / "artifact")
    _tiny_artifact(out)
    served = ServedModel.load(out, device="cpu")
    warmup(served, batch_sizes=(1, 2, 4, 8))  # the bucket ladder

    httpd = make_server(served, port=0, max_batch=8, batch_wait_ms=250.0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        rng = np.random.default_rng(7)
        xs = [rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
              for _ in range(6)]
        refs = [served.reconstruct(x, modality="S2RGB").numpy() for x in xs]
        results, errors = [None] * 6, []

        def client(i):
            try:
                buf = io.BytesIO()
                np.save(buf, xs[i])
                req = urllib.request.Request(
                    f"{base}/v1/reconstruct?modality=S2RGB",
                    data=buf.getvalue())
                with urllib.request.urlopen(req, timeout=300) as r:
                    results[i] = np.load(io.BytesIO(r.read()),
                                         allow_pickle=False)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert not errors, errors
        for i in range(6):
            # Same graph, same weights; padding/bucketing must not perturb
            # per-sample results beyond batch-tiling noise.
            np.testing.assert_allclose(results[i], refs[i],
                                       atol=1e-5, rtol=1e-5)

        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            m = json.load(r)
        assert m["reconstruct"]["count"] == 6
        b = m["_batching"]["reconstruct"]
        assert b["requests"] == 6 and b["samples"] == 6
        assert b["batches"] < 6  # coalescing actually happened
        assert b["max_samples_per_batch"] >= 2
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()  # also stops the batching threads
    assert httpd.batcher._threads and not any(
        th.is_alive() for th in httpd.batcher._threads.values())


def test_tensor_results_are_fetched_after_the_pad_slice():
    """A served object that returns tensors (the port's ServedModel does):
    the pad rows are sliced off the tensor before ``to_host`` fetches it, and
    a bf16 result reaches the client as fp32 (numpy has no bf16)."""
    fetched = []

    class _Rows(torch.Tensor):  # records the rows when fetched to the host
        def cpu(self, *args, **kwargs):
            fetched.append(self.shape[0])
            return super().cpu(*args, **kwargs)

    class _TensorServed:
        def reconstruct(self, x, modality="S2L2A"):
            return (torch.as_tensor(np.asarray(x)) * 2.0).bfloat16().as_subclass(_Rows)

    mb = MicroBatcher(_TensorServed(), threading.Lock(), max_batch=8,
                      max_wait_ms=200.0)
    xs = [np.full((1, 2, 2), float(i), np.float32) for i in range(3)]
    out = [None] * 3
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(
            i, mb.submit("reconstruct", None, xs[i]))) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(3):
        assert out[i].dtype == np.float32
        np.testing.assert_array_equal(out[i], xs[i] * 2.0)
    assert fetched and all(r <= 3 for r in fetched), fetched
    assert to_host(torch.ones(2, dtype=torch.bfloat16)).dtype == np.float32
    mb.close()


class _SeedFakeServed:
    """super_resolve stand-in: y[i] = x[i] + seed[i], so any extras
    misalignment (wrong concat order, pad leakage, dropped or reordered
    seeds) shows up per-sample."""

    def __init__(self):
        self.calls = []  # (batch_size, seeds tuple)
        self._lock = threading.Lock()

    def super_resolve(self, x, seed):
        seed = np.asarray(seed)
        assert seed.shape[0] == x.shape[0]
        with self._lock:
            self.calls.append((int(x.shape[0]),
                               tuple(int(s) for s in seed)))
        return x + seed.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype)


def test_extras_ride_with_their_samples():
    """Per-sample extras (super_resolve's seed vector) concatenate and
    zero-pad exactly alongside the payload: every request keeps ITS seeds
    after coalescing — the property that makes SR batching safe at all."""
    # 3 samples never fill the 4-bucket, so this test always sleeps the
    # FULL window before dispatch (the pad-row property under test needs
    # the partial bucket) — 1 s is enough barrier-released-enqueue margin
    # without doubling the sleep.
    served, mb = _batcher(_SeedFakeServed(), max_batch=8, max_wait_ms=1000.0)
    out = [None, None]
    barrier = threading.Barrier(3)

    def client(i, x, seeds):
        barrier.wait()
        out[i] = mb.submit("super_resolve", None, x,
                           extras={"seed": seeds})

    x0 = np.ones((1, 2, 2), np.float32)
    x1 = np.full((2, 2, 2), 10.0, np.float32)
    t0 = threading.Thread(target=client,
                          args=(0, x0, np.array([3], np.int32)))
    t1 = threading.Thread(target=client,
                          args=(1, x1, np.array([5, 7], np.int32)))
    t0.start(); t1.start(); barrier.wait()
    t0.join(timeout=60); t1.join(timeout=60)
    np.testing.assert_array_equal(out[0], x0 + 3.0)
    np.testing.assert_array_equal(out[1][0], x1[0] + 5.0)
    np.testing.assert_array_equal(out[1][1], x1[1] + 7.0)
    # The 1 s window with a barrier-released enqueue guarantees coalescing
    # short of a pathological scheduler stall — assert it, so the pad-row
    # and seed-routing properties below always actually execute.
    assert len(served.calls) == 1, served.calls
    b, seeds = served.calls[0]
    assert b == 4  # coalesced: 3 samples -> the 4-bucket
    # pad row carries seed 0 and was sliced off before the split
    assert seeds[3] == 0 and set(seeds[:3]) == {3, 5, 7}
    mb.close()


def test_extras_validated_and_keyed():
    """Extras must lead with the batch dim; requests whose extras
    signature differs (here: present vs absent) never share a batch, so a
    seedless submit's TypeError cannot poison seeded traffic."""
    served, mb = _batcher(_SeedFakeServed(), max_batch=8, max_wait_ms=300.0)
    with pytest.raises(ValueError, match="lead with the batch dim"):
        mb.submit("super_resolve", None, np.ones((2, 2, 2), np.float32),
                  extras={"seed": np.array([1, 2, 3], np.int32)})
    with pytest.raises(ValueError, match="lead with the batch dim"):
        mb.submit("super_resolve", None, np.ones((1, 2, 2), np.float32),
                  extras={"seed": np.int32(1)})
    with pytest.raises(ValueError, match="numeric dtype"):
        # same pre-enqueue contract as the payload: an object-dtype extra
        # must fail at submit, not inside the coalesced device call
        mb.submit("super_resolve", None, np.ones((1, 2, 2), np.float32),
                  extras={"seed": np.array(["x"], dtype=object)})

    res = {}
    barrier = threading.Barrier(3)

    def good():
        barrier.wait()
        res["good"] = mb.submit(
            "super_resolve", None, np.ones((1, 2, 2), np.float32),
            extras={"seed": np.array([4], np.int32)})

    def seedless():
        barrier.wait()
        try:
            mb.submit("super_resolve", None,
                      np.ones((1, 2, 2), np.float32))
        except TypeError as e:  # fake requires seed — stays in ITS batch
            res["bad"] = e

    tg = threading.Thread(target=good)
    tb = threading.Thread(target=seedless)
    tg.start(); tb.start(); barrier.wait()
    tg.join(timeout=60); tb.join(timeout=60)
    assert isinstance(res.get("bad"), TypeError)
    np.testing.assert_array_equal(res["good"],
                                  np.full((1, 2, 2), 5.0, np.float32))
    # the seeded dispatch was exactly (1, (4,)) — never mixed with the
    # seedless request
    assert (1, (4,)) in served.calls
    mb.close()
