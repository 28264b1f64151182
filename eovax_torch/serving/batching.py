"""Dynamic micro-batching for the serving daemon.

Port of ``eovax/serving/batching.py``. Concurrent clients typically send
small (often B=1) requests. Dispatching each as its own device call wastes
the card: sixteen serialized B=1 calls launch sixteen times the kernels of
one B=16 call, each too small to fill the card. This module coalesces
concurrent requests for the SAME (function, modality, per-sample shape) into
one device call, padded up to a power-of-two bucket so the batch sizes the
kernels and cuDNN see stay few (the exported graphs take any batch).

Design:
- One dispatcher thread per key, created on first use. A request arrives,
  the dispatcher opens a window of ``max_wait_ms`` (or until ``max_batch``
  samples are pending), concatenates everything that arrived, pads to the
  next bucket, runs ONE device call under the server's dispatch lock, and
  splits the result back per request.
- Keys isolate failures: a request with a bad modality, an odd shape, or
  an odd dtype can only ever share a batch with identically-keyed
  requests, so its error (404/500) never poisons well-formed traffic.
  Idle keys are reclaimed after ``idle_key_ttl_s`` (clients choose the
  key, so per-key threads must not accumulate without bound).
- ``super_resolve`` coalesces only when the artifact takes a PER-SAMPLE
  seed vector (``ServedModel.batchable``): each request's seeds ride along
  as a per-sample extra and concatenate/pad exactly like the payload, so
  coalescing cannot change any request's noise draw. Artifacts without one
  are never batched (the static ``NON_BATCHABLE`` fallback).
- A result on the card is sliced to its real rows there and then fetched to
  the host with ``.cpu()`` (:func:`to_host`).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from eovax_torch.serving._window import LatencyWindow

#: Bucket ladder — the padded batch sizes of the device calls.
_LADDER = (1, 2, 4, 8, 16, 32, 64, 128)

#: Exported functions the daemon must never coalesce UNLESS the artifact
#: declares them safe: a super_resolve without a per-sample seed vector
#: would draw one noise for the whole call, so batching requests with
#: different seeds would change results. ``ServedModel.batchable(name)`` is
#: the per-artifact answer (a per-sample-seed artifact relaxes this); this
#: frozenset is its static fallback (and the rule for manifest-less
#: served objects). The HTTP dispatch guard (server.py) and the serve
#: CLI's bucket warm-up exclusion both go through ``batchable``.
NON_BATCHABLE = frozenset({"super_resolve"})


def to_host(y) -> np.ndarray:
    """A result as a numpy array: a tensor is fetched from its device with
    ``.cpu()`` (bf16 as fp32, which numpy lacks); anything else through
    ``np.asarray``."""
    if torch.is_tensor(y):
        y = y.detach()
        return (y.float() if y.dtype == torch.bfloat16 else y).cpu().numpy()
    return np.asarray(y)


class _Request:
    __slots__ = ("x", "extras", "n", "event", "result", "error", "t0")

    def __init__(self, x: np.ndarray, extras: dict | None = None):
        self.x = x
        self.extras = extras or {}
        self.n = int(x.shape[0])
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.t0 = time.monotonic()


class _KeyQueue:
    __slots__ = ("cv", "pending", "closed")

    def __init__(self):
        self.cv = threading.Condition()
        self.pending: list[_Request] = []
        self.closed = False


class MicroBatcher:
    """Coalesce concurrent ServedModel calls into bucketed device batches.

    ``lock`` must be the same lock the HTTP handlers use for unbatched
    dispatch (super_resolve), so batched and unbatched device calls stay
    serialized on the single device stream.
    """

    def __init__(self, served, lock: threading.Lock,
                 max_batch: int = 16, max_wait_ms: float = 3.0,
                 idle_key_ttl_s: float = 60.0):
        if max_batch < 2:
            raise ValueError(f"max_batch must be >= 2, got {max_batch}")
        self._served = served
        self._lock = lock
        self._max_batch = int(max_batch)
        self._wait_s = float(max_wait_ms) / 1e3
        # Dispatcher threads are created per unique key; clients choose the
        # key (shape/dtype are theirs), so an idle TTL reclaims threads and
        # queues or a shape-fuzzing client grows them without bound.
        self._idle_ttl = float(idle_key_ttl_s)
        ladder = [b for b in _LADDER if b < max_batch] + [int(max_batch)]
        # Mesh-sharded serving (a served object with a ``_mesh``, as the JAX
        # package's ServedModel.with_mesh gives; ROADMAP item 8c here): a
        # batch not divisible by the device count would replicate — round
        # each bucket up to a device-count multiple so every coalesced
        # dispatch shards.
        mesh = getattr(served, "_mesh", None)
        self._round = int(mesh.devices.size) if mesh is not None else 1
        if self._round > 1:
            n = self._round
            ladder = [max(n, -(-b // n) * n) for b in ladder]
        self.buckets = sorted(set(ladder))
        self._queues: dict[tuple, _KeyQueue] = {}
        self._queues_lock = threading.Lock()
        self._threads: dict[tuple, threading.Thread] = {}
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats: dict[str, dict] = {}

    # ---- client side ----------------------------------------------------

    def submit(self, name: str, modality: str | None, x: np.ndarray,
               extras: dict | None = None, timeout_s: float = 600.0):
        """Block until the coalesced device call for ``x`` completes.

        Raises whatever the underlying ServedModel call raised (KeyError
        for a function/modality not in the artifact, etc.). ``modality``
        None means "use the method's default" — identical semantics to
        calling the ServedModel method without the kwarg.

        ``extras``: optional per-sample side arrays passed as keyword
        arguments of the served call (super_resolve's seed vector). Each
        must lead with the same batch dim as ``x``; they concatenate and
        zero-pad alongside it (pad rows are sliced off before the fetch,
        so their extra values never reach a client).
        """
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError(
                f"batchable request needs a non-empty leading batch dim, "
                f"got shape {x.shape}")
        if x.dtype.kind not in "fiub":
            # Reject before enqueueing: a non-numeric payload would fail
            # inside the coalesced device call. bool is accepted because
            # the UNBATCHED path accepts it (ServedModel casts it to
            # float32) — the dtype contract must not
            # depend on whether --max-batch is set.
            raise ValueError(
                f"batchable request needs a numeric dtype, got {x.dtype}")
        extras = {k: np.asarray(v) for k, v in (extras or {}).items()}
        for k, v in extras.items():
            if v.ndim < 1 or v.shape[0] != x.shape[0]:
                raise ValueError(
                    f"extra {k!r} must lead with the batch dim "
                    f"({x.shape[0]}), got shape {v.shape}")
            if v.dtype.kind not in "fiub":
                # Same contract as x: reject before enqueueing rather than
                # failing inside the coalesced device call.
                raise ValueError(
                    f"extra {k!r} needs a numeric dtype, got {v.dtype}")
        # dtype is part of the key: a stray f64 (or otherwise odd-typed)
        # request must neither promote a whole coalesced f32 batch nor
        # share its failure with well-typed peers. Extras signatures are
        # too — a request missing an extra (or typing it oddly) can only
        # share a batch with identically-shaped peers.
        key = (name, modality, tuple(x.shape[1:]), x.dtype.str,
               tuple(sorted((k, v.dtype.str, v.shape[1:])
                            for k, v in extras.items())))
        req = _Request(x, extras)
        q = None
        while True:
            q = self._queue_for(key)
            with q.cv:
                if not q.closed:
                    q.pending.append(req)
                    q.cv.notify_all()
                    break
            # queue retired (idle TTL) between lookup and append — retry;
            # a closed *batcher* raises RuntimeError from _queue_for.
        if not req.event.wait(timeout=timeout_s):
            with q.cv:
                if req in q.pending:
                    # never dispatched — withdraw so the dispatcher doesn't
                    # pay a device call for a client that already errored
                    q.pending.remove(req)
            raise TimeoutError(f"batched call {key} timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # ---- dispatcher side ------------------------------------------------

    def _queue_for(self, key: tuple) -> _KeyQueue:
        with self._queues_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _KeyQueue()
                t = threading.Thread(
                    target=self._loop, args=(key, q), daemon=True,
                    name=f"microbatch-{key[0]}")
                self._threads[key] = t
                t.start()
            return q

    def _retire(self, key: tuple, q: _KeyQueue) -> bool:
        """Idle-TTL reclamation: drop this key's queue + thread if still
        idle. Lock order is _queues_lock -> q.cv (same as close())."""
        with self._queues_lock:
            with q.cv:
                if q.pending:
                    return False  # traffic raced in — keep serving
                q.closed = True  # racing submit()s see this and retry
                if self._queues.get(key) is q:
                    del self._queues[key]
                    self._threads.pop(key, None)
                return True

    def _loop(self, key: tuple, q: _KeyQueue) -> None:
        while True:
            with q.cv:
                idle_deadline = time.monotonic() + self._idle_ttl
                while not q.pending and not q.closed:
                    left = idle_deadline - time.monotonic()
                    if left <= 0:
                        break
                    q.cv.wait(timeout=left)
                if q.closed and not q.pending:
                    return
                idle = not q.pending
            if idle:
                if self._retire(key, q):
                    return
                continue
            with q.cv:
                if not q.pending:
                    continue  # a timed-out submit withdrew the request
                # Batching window: up to max_wait_ms from the FIRST pending
                # request's arrival (not from this wake-up — requests that
                # queued during the previous device call have already
                # waited; don't add a fresh window on top).
                deadline = q.pending[0].t0 + self._wait_s
                while (sum(r.n for r in q.pending) < self._max_batch
                       and not q.closed):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    q.cv.wait(timeout=left)
                take: list[_Request] = []
                total = 0
                while q.pending:
                    nxt = q.pending[0]
                    # Always take the head (an oversize single request
                    # passes through whole); stop before overflowing.
                    if take and total + nxt.n > self._max_batch:
                        break
                    take.append(q.pending.pop(0))
                    total += nxt.n
            if take:
                self._execute(key, take, total)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        # Oversize request: dispatch at its own size (rounded up to a
        # device-count multiple under mesh serving so it still shards).
        return -(-n // self._round) * self._round

    def _execute(self, key: tuple, take: list[_Request], total: int) -> None:
        name, modality = key[0], key[1]
        wait_ms = (time.monotonic() - take[0].t0) * 1e3
        try:
            xs = (np.concatenate([r.x for r in take], axis=0)
                  if len(take) > 1 else take[0].x)
            bucket = self._bucket(total)
            if bucket > total:
                pad = np.zeros((bucket - total,) + xs.shape[1:], xs.dtype)
                xs = np.concatenate([xs, pad], axis=0)
            kw = {} if modality is None else {"modality": modality}
            # Per-sample extras (seed vectors) ride with the payload: same
            # concat order, zero pad rows (sliced off before the fetch).
            # The key guarantees every request here has the same extras.
            for en in take[0].extras:
                ev = (np.concatenate([r.extras[en] for r in take], axis=0)
                      if len(take) > 1 else take[0].extras[en])
                if bucket > total:
                    epad = np.zeros((bucket - total,) + ev.shape[1:],
                                    ev.dtype)
                    ev = np.concatenate([ev, epad], axis=0)
                kw[en] = ev
            with self._lock:
                y = getattr(self._served, name)(xs, **kw)
                if bucket > total:
                    # Slice the pad rows off ON DEVICE before the host
                    # fetch: the copy to the host then moves `total` rows,
                    # not `bucket`.
                    y = y[:total]
                y = to_host(y)
        except BaseException as e:  # propagate to every waiter, keep serving
            for r in take:
                r.error = e
                r.event.set()
            return
        off = 0
        for r in take:
            r.result = y[off:off + r.n]
            off += r.n
            r.event.set()
        self._record(name, len(take), total, bucket - total, wait_ms)

    # ---- stats / lifecycle ------------------------------------------------

    def _record(self, name: str, n_reqs: int, samples: int, padded: int,
                wait_ms: float) -> None:
        with self._stats_lock:
            d = self._stats.setdefault(name, {
                "batches": 0, "requests": 0, "samples": 0, "padded": 0,
                "max_samples": 0, "waits": LatencyWindow()})
            d["batches"] += 1
            d["requests"] += n_reqs
            d["samples"] += samples
            d["padded"] += padded
            d["max_samples"] = max(d["max_samples"], samples)
            d["waits"].add(wait_ms)

    def stats(self) -> dict:
        with self._stats_lock:
            out = {}
            for name, d in self._stats.items():
                dispatched = d["samples"] + d["padded"]
                out[name] = {
                    "batches": d["batches"],
                    "requests": d["requests"],
                    "samples": d["samples"],
                    "mean_samples_per_batch": round(
                        d["samples"] / d["batches"], 2),
                    "max_samples_per_batch": d["max_samples"],
                    "pad_waste_pct": round(100.0 * d["padded"] / dispatched, 1),
                    **d["waits"].snapshot(prefix="queue_wait_"),
                }
            return out

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Stop every dispatcher thread once its queue drains."""
        with self._queues_lock:
            self._closed = True
            queues = list(self._queues.values())
            threads = list(self._threads.values())
        for q in queues:
            with q.cv:
                q.closed = True
                q.cv.notify_all()
        for t in threads:
            t.join(timeout=join_timeout_s)
