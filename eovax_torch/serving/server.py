"""HTTP inference server over an exported artifact.

Port of ``eovax/serving/server.py``: a stdlib-only (http.server) daemon that
loads a :class:`ServedModel` and exposes its functions over HTTP with
``.npy`` payloads.

    served = ServedModel.load("artifact/")
    httpd = make_server(served, port=8000)
    httpd.serve_forever()            # or: python -m eovax_torch.cli.serve artifact/

Protocol (v1):
    GET  /healthz                  -> {"status": "ok"} (liveness; run
                                      warmup() before serve_forever so
                                      live also means warmed — the CLI
                                      does)
    GET  /v1/manifest              -> the artifact manifest JSON
    GET  /metrics                  -> per-function counts + latency p50/p99
    POST /v1/<function>?modality=M -> body:  .npy (NCHW float32)
                                      reply: .npy (NCHW float32)
    POST /v1/super_resolve?seed=N  -> SR-pipeline artifacts only; on
                                      per-sample-seed artifacts sample i
                                      draws with seed N+i (≡ the B=1
                                      call with seed N+i, batched or not).
                                      N+i wraps at int32 (seed INT32_MAX
                                      with B>1 yields negative seeds) —
                                      consistent between batched and
                                      unbatched paths, which share the
                                      per_sample_seeds derivation.

Design notes:
- ``ThreadingHTTPServer`` so a slow client can't starve health checks;
  device dispatches from concurrent handlers are serialized by a lock —
  the card's one CUDA stream gains nothing from interleaved dispatch, and
  the lock keeps per-request latency predictable instead of fair-share
  degraded.
- Payloads are raw ``.npy`` (``np.save``/``np.load(allow_pickle=False)``):
  zero-copy-ish, dtype/shape carried in-band, no pickle execution risk.
- ``warmup()`` calls each function at the given batch sizes so the first
  real request doesn't pay for the first call: loading the graph, building
  the kernels (``nvcc``, once per checkout) and cuDNN's choice of
  algorithms for each new batch size.
- Results are fetched from the card after the call (``.cpu()``), inside
  the request's timed span.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from eovax_torch.serving._window import LatencyWindow
from eovax_torch.serving.batching import NON_BATCHABLE, to_host

#: request path segment -> ServedModel method (all take (x, modality=...)
#: except super_resolve, which takes (x, seed=...)).
_ROUTES = (
    "reconstruct",
    "encode_spatial_normalized",
    "decode_spatial_normalized",
    "super_resolve",
)

#: Routes dispatched as ``(x, seed)`` with a BARE manifest key — every
#: other route takes ``(x, modality=...)`` and is manifest-keyed
#: ``<name>.<modality>``. This is a dispatch-signature property, distinct
#: from batching.NON_BATCHABLE (a coalescing-safety property): the two
#: sets cover the same name today, but a future per-modality non-batchable
#: export must change only NON_BATCHABLE, not the key format.
_SEED_ROUTES = frozenset({"super_resolve"})

_MAX_BODY = 1 << 30  # 1 GiB — refuse absurd payloads before allocating

#: the int32 seed vector cannot hold a seed past these bounds — that
#: is a client mistake and must be a 400 at parse time, not a 500 from
#: inside the dispatch.
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class _Metrics:
    """Per-function request counters + latency window (last 512 samples)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, dict] = {}

    def record(self, name: str, ms: float, error: bool = False) -> None:
        with self._lock:
            d = self._data.setdefault(
                name, {"count": 0, "errors": 0, "lat": LatencyWindow()})
            d["count"] += 1
            if error:
                d["errors"] += 1
            else:
                d["lat"].add(ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "count": d["count"],
                    "errors": d["errors"],
                    **d["lat"].snapshot(mean=True),
                }
                for name, d in self._data.items()
            }


def _npy_parse(raw: bytes) -> np.ndarray:
    """Parse a request .npy body as a zero-copy view over the received
    bytes (the request-side mirror of _npy_frame): ``np.load`` always
    copies the body into a fresh array, a pure waste here because every
    consumer copies again anyway (device put, or the batcher's concat).
    Read-only view semantics are safe for the same reason. Falls back to
    ``np.load`` for the rare formats a view can't represent (Fortran
    order, version-3 headers); rejects object dtypes exactly like
    ``allow_pickle=False``. Raises on malformed input (caller maps any
    raise to a 400)."""
    f = io.BytesIO(raw)
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        return np.load(io.BytesIO(raw), allow_pickle=False)
    if dtype.hasobject:
        raise ValueError("object arrays cannot be loaded (pickle disabled)")
    if fortran:
        return np.load(io.BytesIO(raw), allow_pickle=False)
    count = int(np.prod(shape, dtype=np.int64))
    if count < 0 or count * dtype.itemsize > len(raw) - f.tell():
        # count < 0 guards int64 overflow of absurd header shapes — a
        # negative count would make frombuffer read "the whole buffer".
        raise ValueError(
            f"npy header shape {shape} inconsistent with body size")
    return np.frombuffer(
        raw, dtype=dtype, count=count, offset=f.tell()
    ).reshape(shape)


def _npy_frame(arr) -> tuple[bytes, np.ndarray]:
    """(.npy header bytes, contiguous wire-dtype array) — the response
    body WITHOUT materializing it: a full ``np.save`` into BytesIO costs
    two extra body-size copies (the BytesIO accumulation + getvalue),
    on a host where one core serializes every response. The
    handler streams the header then the array's own buffer straight to
    ``sendall`` (http.server's _SocketWriter is unbuffered and takes the
    buffer protocol — zero user-space copies beyond the fetch from the
    card and the f32 wire cast). np.load reads the result bit-identically."""
    arr = to_host(arr)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    arr = np.ascontiguousarray(arr)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    return buf.getvalue(), arr


class _Handler(BaseHTTPRequestHandler):
    # set per-server via type(); see make_server
    served = None
    lock: threading.Lock = None
    metrics: _Metrics = None
    batcher = None  # MicroBatcher when dynamic batching is enabled
    quiet = True

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # default: silent (tests, prod logs)
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_npy(self, header: bytes, arr: np.ndarray) -> None:
        """200 with header + the array's own buffer (see _npy_frame)."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(header) + arr.nbytes))
        self.end_headers()
        self.wfile.write(header)
        self.wfile.write(arr.data)

    def _json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 (http.server API)
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"status": "ok"})
        elif path == "/v1/manifest":
            self._json(200, self.served._manifest)
        elif path == "/metrics":
            snap = self.metrics.snapshot()
            if self.batcher is not None:
                # leading underscore: can never collide with a function name
                snap["_batching"] = self.batcher.stats()
            self._json(200, snap)
        else:
            self._json(404, {"error": f"unknown path {path!r}"})

    def _validate(self, name: str, modality, x) -> tuple | None:
        """Pre-dispatch client-input checks → (status, message) or None.

        Everything rejected here is the CLIENT's fault (400/404). Once
        validation passes, any failure inside the device dispatch is a
        server fault (500): a blanket ValueError→400 around the dispatch
        would also reclassify server-side errors (a graph that fails on this
        device, a state-dict mismatch) as client errors and hide a
        100%-failing service from 5xx monitoring.
        """
        if x.ndim < 1 or x.shape[0] == 0:
            return 400, (f"payload needs a non-empty leading batch dim, "
                         f"got shape {x.shape}")
        if x.dtype.kind not in "fiub":
            return 400, f"payload needs a numeric dtype, got {x.dtype}"
        get_shape = getattr(self.served, "input_shape", None)
        if get_shape is None:
            return None  # served object without a manifest (test fakes)
        # manifest key format follows the dispatch signature (_SEED_ROUTES),
        # not the batching-safety set; modality was already resolved to the
        # served default in do_POST.
        mod = None if name in _SEED_ROUTES else modality
        try:
            expect = get_shape(name, mod)
        except KeyError as e:
            # e.args[0], not str(e): KeyError's str() adds a second layer
            # of quotes around the message
            return 404, str(e.args[0]) if e.args else str(e)
        if tuple(x.shape[1:]) != expect:
            return 400, (f"per-sample shape {tuple(x.shape[1:])} does not "
                         f"match the artifact's {expect} for {name!r}")
        return None

    def do_POST(self):  # noqa: N802
        # Read (drain) the body FIRST: with HTTP/1.1 keep-alive, replying
        # without consuming the body leaves its bytes in the socket to be
        # parsed as the next request line, desyncing the connection.
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if not 0 < length <= _MAX_BODY:
            # can't safely drain an absent/absurd body — close instead
            self.close_connection = True
            self._json(400, {"error": f"bad Content-Length "
                             f"{self.headers.get('Content-Length')!r}"})
            return
        raw = self.rfile.read(length)

        url = urlparse(self.path)
        name = url.path.removeprefix("/v1/")
        if url.path == name or name not in _ROUTES:
            self._json(404, {"error": f"unknown function {url.path!r}",
                             "functions": list(_ROUTES)})
            return
        try:
            x = _npy_parse(raw)
        except Exception as e:  # malformed .npy
            self._json(400, {"error": f"payload is not a valid .npy: {e}"})
            return
        # Client-input validation (a bad query param is a 400, not a 500).
        q = parse_qs(url.query)
        try:
            seed = int(q.get("seed", ["0"])[0])
        except ValueError:
            self._json(400, {"error": f"seed must be an int, got "
                             f"{q['seed'][0]!r}"})
            return
        if not _INT32_MIN <= seed <= _INT32_MAX:
            # the int32 seed vector inside the dispatch would overflow
            # -> 500; an oversize seed is the client's fault
            self._json(400, {"error": f"seed must fit in int32, got {seed}"})
            return
        modality = q["modality"][0] if "modality" in q else None
        if name not in _SEED_ROUTES and modality is None:
            # Resolve the served default ONCE so validation, the batcher
            # key, and the dispatch all agree — requests that spell out the
            # default and requests that omit it coalesce into one batch
            # instead of two half-full padded device calls per window.
            modality = getattr(self.served, "DEFAULT_MODALITY", None)
        bad = self._validate(name, modality, x)
        if bad is not None:
            self.metrics.record(name, 0.0, error=True)
            self._json(bad[0], {"error": bad[1]})
            return
        import time

        t0 = time.perf_counter()
        try:
            # Batchability is per-artifact: super_resolve coalesces when
            # the export takes a per-sample seed vector (each request's
            # seeds ride along as an extra), and never without one —
            # ServedModel.batchable decides;
            # manifest-less test fakes fall back to the static set.
            can_batch = getattr(self.served, "batchable", None)
            batchable = (can_batch(name) if can_batch is not None
                         else name not in NON_BATCHABLE)
            if self.batcher is not None and batchable:
                extras = None
                if name in _SEED_ROUTES:
                    # THE scalar→vector derivation (per_sample_seeds) —
                    # shared with the unbatched ServedModel path, so the
                    # same request draws the same per-sample noise with
                    # and without --max-batch.
                    from eovax_torch.serving.export import per_sample_seeds

                    extras = {"seed": per_sample_seeds(seed, x.shape[0])}
                y = self.batcher.submit(
                    name, None if name in _SEED_ROUTES else modality, x,
                    extras=extras)
                header, out = _npy_frame(y)
            else:
                with self.lock:
                    if name in _SEED_ROUTES:
                        y = self.served.super_resolve(x, seed=seed)
                    else:
                        kw = {}
                        if modality is not None:
                            kw["modality"] = modality
                        y = getattr(self.served, name)(x, **kw)
                    # device fetch (+ wire cast) — count as latency
                    header, out = _npy_frame(y)
        except KeyError as e:
            # function/modality not in this artifact (served objects
            # without a manifest skip the _validate lookup, so this can
            # still fire from the call itself)
            self.metrics.record(name, 0.0, error=True)
            self._json(404, {"error": str(e.args[0]) if e.args else str(e)})
            return
        except TimeoutError as e:
            self.metrics.record(name, 0.0, error=True)
            self._json(504, {"error": str(e)})
            return
        except Exception as e:
            self.metrics.record(name, 0.0, error=True)
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self.metrics.record(name, (time.perf_counter() - t0) * 1e3)
        try:
            self._reply_npy(header, out)
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-reply; the request itself succeeded —
            # don't re-count it or write a 500 into the dead socket
            self.close_connection = True


class _Server(ThreadingHTTPServer):
    batcher = None

    def server_close(self):
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def make_server(served, host: str = "127.0.0.1", port: int = 8000,
                quiet: bool = True, max_batch: int = 0,
                batch_wait_ms: float = 3.0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server for a :class:`ServedModel`.

    ``port=0`` binds an ephemeral port — read it back from
    ``server.server_address[1]``. Call ``serve_forever()`` (blocking) or
    run it on a thread; ``shutdown()`` stops it (then ``server_close()``
    releases the port and the batching threads).

    ``max_batch >= 2`` enables dynamic micro-batching: concurrent requests
    for the same (function, modality, shape) coalesce into one device call
    within a ``batch_wait_ms`` window (see eovax_torch/serving/batching.py).
    """
    lock = threading.Lock()
    batcher = None
    if max_batch >= 2:
        from eovax_torch.serving.batching import MicroBatcher

        batcher = MicroBatcher(served, lock, max_batch=max_batch,
                               max_wait_ms=batch_wait_ms)
    handler = type("Handler", (_Handler,), {
        "served": served, "lock": lock, "metrics": _Metrics(),
        "batcher": batcher, "quiet": quiet,
    })
    server = _Server((host, port), handler)
    server.batcher = batcher
    return server


def warmup(served, batch_sizes=(1,), seed: int = 0,
           functions=None) -> list[str]:
    """Call every function in the artifact once at each of the given batch
    sizes (loading its graph, building the kernels, letting cuDNN choose its
    algorithms for the size).

    Returns the list of warmed "function.modality@B" keys. Uses the
    manifest's input shapes, so it works for both VAE-surface and
    SR-pipeline artifacts. ``functions`` restricts warming to those
    function names (e.g. only the batchable ones for bucket warmup —
    a super_resolve without per-sample seeds never dispatches at bucket
    sizes, while a per-sample-seed one batches like any other function).
    """
    warmed = []
    for key, entry in served._manifest["functions"].items():
        name = key.split(".")[0]
        if functions is not None and name not in functions:
            continue
        shape = entry["input_shape"]
        for b in batch_sizes:
            x = np.zeros([b] + shape[1:], np.float32)
            if name == "super_resolve":
                served.super_resolve(x, seed=seed)
            else:
                getattr(served, name)(x, modality=entry["modality"])
            warmed.append(f"{key}@{b}")
    return warmed
