"""TerraMesh streaming input pipeline (tar shards of zip-zarr tiles).

A numpy copy of ``eovax/data/terramesh.py``, itself a re-design of the
reference's ``eo_vae/datasets/terramesh.py``: the reference streams
WebDataset tar shards inside torch DataLoader worker *processes*; here a
thread-pool reader streams tar members, groups them into samples, decodes
the zip-zarr chunks through native C++ (eovax_torch.native), and emits NHWC
numpy batches for the trainer to copy to the device — no Python pickling
between processes, decompression releases the GIL.

Parity pieces (line numbers of the reference's terramesh.py):
- shard tables per split (terramesh.py:41-57) and global band statistics
  (terramesh.py:59-132)
- S2L2A +1000 harmonization for frames on/after 2022-01-24
  (S2L2A_BASELINE_CUTOFF_NS, terramesh.py:38, 239-253)
- shard split across hosts/workers (wds.split_by_node/split_by_worker,
  terramesh.py:384-385) → process_index × reader-thread assignment
- corrupt-shard resilience (handler=warn_and_continue, terramesh.py:383)
- sample shuffle buffer (1000) + in-pipeline batching (terramesh.py:417-419)
- majortom/ssl4eos12 random mix probs [0.8, 0.2] (terramesh.py:553-557)
- multimodal per-key merging of per-modality tar shards
  (multi_tarfile_samples, terramesh.py:601-657 adapted from apple/ml-4m)
"""

from __future__ import annotations

import os
import random
import re
import tarfile
import threading
import warnings
from queue import Empty, Full, Queue
from typing import Any, Callable, Iterator

import numpy as np

from eovax_torch.data.zarrzip import decode_zarr_zip_bands

# January 24, 2022 — Sentinel-2 L2A processing-baseline change (ns since epoch).
S2L2A_BASELINE_CUTOFF_NS = 1_642_982_400_000_000_000

SPLIT_FILES = {
    "ssl4eos12": {
        "train": ["ssl4eos12_shard_{000794..000889}.tar"],
        "val": ["ssl4eos12_shard_000009.tar"],
    },
    "majortom": {
        "train": ["majortom_shard_{000001..000793}.tar"],
        "val": ["majortom_shard_{000001..000008}.tar"],
    },
    "combined": {
        "train": [
            "majortom_shard_{000001..000793}.tar",
            "ssl4eos12_shard_{000794..000889}.tar",
        ],
        "val": ["majortom_shard_{000001..000008}.tar", "ssl4eos12_shard_000009.tar"],
    },
}

#: Global TerraMesh band statistics (terramesh.py:59-132).
STATISTICS = {
    "mean": {
        "S2L1C": [2357.090, 2137.398, 2018.799, 2082.998, 2295.663, 2854.548,
                  3122.860, 3040.571, 3306.491, 1473.849, 506.072, 2472.840,
                  1838.943],
        "S2L2A": [1390.461, 1503.332, 1718.211, 1853.926, 2199.116, 2779.989,
                  2987.025, 3083.248, 3132.235, 3162.989, 2424.902, 1857.665],
        "S2RGB": [110.349, 99.507, 75.843],
        "S1GRD": [-12.577, -20.265],
        "S1RTC": [-10.93, -17.329],
        "NDVI": [0.327],
        "DEM": [651.663],
    },
    "std": {
        "S2L1C": [1673.639, 1722.641, 1602.205, 1873.138, 1866.055, 1779.839,
                  1776.496, 1724.114, 1771.041, 1079.786, 512.404, 1340.879,
                  1172.435],
        "S2L2A": [2131.157, 2163.666, 2059.311, 2152.477, 2105.179, 1912.773,
                  1842.326, 1893.568, 1775.656, 1814.907, 1436.282, 1336.155],
        "S2RGB": [69.905, 53.708, 53.378],
        "S1GRD": [5.179, 5.872],
        "S1RTC": [4.391, 4.459],
        "NDVI": [0.322],
        "DEM": [928.168],
    },
}

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_braces(pattern: str) -> list[str]:
    """Expand one `{000001..000793}` numeric range (webdataset-style)."""
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(
            expand_braces(pattern[: m.start()] + f"{i:0{width}d}" + pattern[m.end():])
        )
    return out


def shard_urls(path: str, modality: str, split: str) -> list[str]:
    """Shard file list for (modality, split) — S1GRD lives only in
    ssl4eos12, S1RTC only in majortom (terramesh.py:358-368)."""
    if modality == "S1GRD":
        files = SPLIT_FILES["ssl4eos12"][split]
    elif modality == "S1RTC":
        files = SPLIT_FILES["majortom"][split]
    else:
        files = SPLIT_FILES["combined"][split]
    urls: list[str] = []
    for f in files:
        urls.extend(
            os.path.join(path, split, modality, g) for g in expand_braces(f)
        )
    return urls


def split_shards(
    shards: list[str],
    *,
    process_index: int = 0,
    process_count: int = 1,
    worker_id: int = 0,
    num_workers: int = 1,
) -> list[str]:
    """Host-level then worker-level round-robin shard assignment."""
    per_host = shards[process_index::process_count]
    return per_host[worker_id::num_workers]


# ---------------------------------------------------------------------------
# Tar streaming
# ---------------------------------------------------------------------------


def _split_member_name(name: str) -> tuple[str, str]:
    """'key.S2L2A.zarr.zip' → ('key', 'S2L2A.zarr.zip'); 'key.zarr.zip' →
    ('key', 'zarr.zip') (webdataset key/extension convention)."""
    base = os.path.basename(name)
    parts = base.split(".")
    return parts[0], ".".join(parts[1:])


def iter_tar_samples(shard_path: str) -> Iterator[dict[str, Any]]:
    """Stream one tar shard into grouped {'__key__', ext: bytes} samples.
    Corrupt shards are skipped with a warning (warn_and_continue parity)."""
    try:
        with tarfile.open(shard_path, mode="r|*") as tf:
            current_key = None
            sample: dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                key, ext = _split_member_name(member.name)
                if key != current_key:
                    if sample:
                        yield sample
                    current_key = key
                    sample = {"__key__": key}
                sample[ext] = tf.extractfile(member).read()
            if sample:
                yield sample
    except (tarfile.TarError, OSError) as e:
        warnings.warn(f"Skipping corrupt shard {shard_path}: {e}")


def iter_multi_tar_samples(shard_paths: list[str]) -> Iterator[dict[str, Any]]:
    """Merge per-modality tar shards by sample key: shard i contributes its
    member under '{MOD}.zarr.zip' (multi_tarfile_samples parity,
    terramesh.py:601-657).

    On a key mismatch (a modality shard missing a sample), lagging
    iterators are advanced toward the max key — keys are stored sorted
    within TerraMesh shards — skipping the incomplete samples with a
    warning instead of abandoning the rest of the shard (the reference
    raises and its warn_and_continue handler drops the whole shard)."""
    iters = [iter_tar_samples(p) for p in shard_paths]
    mods = [_modality_from_path(p) for p in shard_paths]
    samples = [next(it, None) for it in iters]
    while True:
        if any(s is None for s in samples):
            return
        keys = [s["__key__"] for s in samples]
        if len(set(keys)) != 1:
            target = max(keys)
            warnings.warn(
                f"Sample-key mismatch across modalities: {sorted(set(keys))} — "
                f"resyncing to {target!r}"
            )
            for i, (it, s) in enumerate(zip(iters, samples)):
                # Strictly advances at least one iterator (some key < max),
                # so the loop always progresses or drains to None.
                while s is not None and s["__key__"] < target:
                    s = next(it, None)
                samples[i] = s
            continue
        merged: dict[str, Any] = {"__key__": samples[0]["__key__"]}
        for mod, s in zip(mods, samples):
            for ext, v in s.items():
                if ext == "__key__":
                    continue
                merged[f"{mod}.{ext}" if mod else ext] = v
        yield merged
        samples = [next(it, None) for it in iters]


def _modality_from_path(path: str) -> str | None:
    parts = os.path.normpath(path).split(os.sep)
    return parts[-2] if len(parts) >= 2 else None


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def decode_sample(
    sample: dict[str, Any], *, harmonize_s2l2a: bool = False,
    return_metadata: bool = False, dtype: np.dtype | None = np.float32,
) -> dict[str, Any]:
    """zip-zarr members → fp32 HWC arrays (``dtype=None`` preserves the
    stored dtype for the device_prep path); squeezes the time dim
    (drop_time_dim, terramesh.py:319-337). Single-modality samples get the
    'image' key (rename parity, terramesh.py:410). With return_metadata,
    attaches center_lon/center_lat/cloud_mask/time like
    zarr_metadata_decoding (terramesh.py:256-311)."""
    from eovax_torch.data.zarrzip import ZarrZipGroup

    out: dict[str, Any] = {"__key__": sample.get("__key__")}
    for ext, value in sample.items():
        if ext == "__key__":
            continue
        if ext == "zarr.zip" or ext.endswith(".zarr.zip"):
            is_s2l2a = "S2L2A" in ext or ext == "zarr.zip"
            if return_metadata:
                group = ZarrZipGroup(value)
                bands = (
                    np.asarray(group["bands"])
                    if dtype is None
                    else np.asarray(group["bands"], dtype)
                )
                timestamp = int(np.asarray(group.get("time", 0)).reshape(-1)[0])
                if harmonize_s2l2a and is_s2l2a and timestamp >= S2L2A_BASELINE_CUTOFF_NS:
                    bands = np.asarray(bands, np.float32) + 1000.0
                if "center_lon" not in out and "center_lon" in group:
                    out["center_lon"] = np.asarray(group["center_lon"]).reshape(-1)[0]
                    out["center_lat"] = np.asarray(group["center_lat"]).reshape(-1)[0]
                if "cloud_mask" in group and "cloud_mask" not in out:
                    out["cloud_mask"] = np.asarray(group["cloud_mask"])
                if timestamp > 1e6:  # DEM has no valid timestamp (value 0)
                    tkey = "time" if ext == "zarr.zip" else "time_" + ext[: -len(".zarr.zip")]
                    out[tkey] = timestamp
            else:
                bands = decode_zarr_zip_bands(
                    value, harmonize_s2l2a=harmonize_s2l2a and is_s2l2a,
                    dtype=dtype,
                )
            if bands.ndim == 4 and bands.shape[0] == 1:
                bands = bands[0]  # drop time dim
            bands = np.transpose(bands, (1, 2, 0))  # CHW → HWC (the collates' layout)
            name = "image" if ext == "zarr.zip" else ext[: -len(".zarr.zip")]
            out[name] = bands
        else:
            out[ext] = value
    return out


# ---------------------------------------------------------------------------
# Pipeline assembly
# ---------------------------------------------------------------------------


def _shuffled(iterator: Iterator, bufsize: int, rng: random.Random) -> Iterator:
    buf: list[Any] = []
    for item in iterator:
        buf.append(item)
        if len(buf) >= bufsize:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def _batched(iterator: Iterator[dict], batch_size: int, partial: bool) -> Iterator[dict]:
    batch: list[dict] = []
    for s in iterator:
        batch.append(s)
        if len(batch) == batch_size:
            yield _collate_stack(batch)
            batch = []
    if batch and partial:
        yield _collate_stack(batch)


def _collate_stack(samples: list[dict]) -> dict:
    out: dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


def _prefetch(iterator_factory: Callable[[], Iterator], depth: int) -> Iterator:
    """Background-thread prefetch: keeps the device fed while the host
    decodes the next shard (replaces DataLoader worker processes).

    Closable: when the consumer generator is closed (explicit ``.close()``
    or GC after an early-stopped fit — preemption, max_steps) the producer
    thread is told to stop and unblocked if it was waiting on a full
    queue. Without this, every abandoned iterator leaked a live thread
    pinning ``depth`` decoded batches of memory for the process lifetime.

    Error-propagating: a producer exception (shard open failure, decode
    bug, OOM in the stack) is re-raised in the CONSUMER — the sentinel
    alone would read as a clean end-of-stream and a 100k-step fit would
    quietly "finish" at whatever step the data died. Corrupt
    *samples* are still skipped upstream (zarr handler=warn semantics);
    only errors that escape the pipeline itself land here."""
    q: Queue = Queue(maxsize=depth)
    _SENTINEL = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def producer():
        try:
            it = iterator_factory()
            while not stop.is_set():
                item = next(it, _SENTINEL)
                if item is _SENTINEL:
                    break
                # Bounded put so a closed consumer can't strand us on a
                # full queue; the 100 ms poll only spins while idle-full.
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except Full:
                        continue
        except BaseException as e:  # recorded BEFORE the sentinel lands
            err.append(e)
        finally:
            # The sentinel MUST arrive (a silently dropped one would hang
            # the consumer on q.get() forever after a producer exception);
            # bounded retries so a closed consumer can't strand us.
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting on put()
            try:
                q.get_nowait()
            except Empty:
                break


def _random_mix(
    iterators: list[Iterator], probs: list[float], rng: random.Random
) -> Iterator:
    """Sample interleaving with given probabilities (wds.RandomMix parity,
    terramesh.py:553-557). Stops when all sources are exhausted."""
    live = list(iterators)
    weights = list(probs)
    while live:
        i = rng.choices(range(len(live)), weights=weights)[0]
        item = next(live[i], None)
        if item is None:
            live.pop(i)
            weights.pop(i)
            continue
        yield item


#: Batch interleaving probabilities per TerraMesh subset
#: (wds.RandomMix probs=[0.8, 0.2], terramesh.py:553-557).
SUBSET_MIX_PROBS = {"majortom": 0.8, "ssl4eos12": 0.2}


def build_terramesh_dataset(
    path: str,
    modalities: list[str] | str,
    split: str = "val",
    *,
    urls: list[str] | None = None,
    batch_size: int | None = 8,
    shuffle: bool = False,
    shuffle_buffer: int = 1000,
    seed: int | None = None,
    harmonize_s2l2a: bool = False,
    partial: bool = False,
    process_index: int = 0,
    process_count: int = 1,
    num_reader_threads: int = 1,
    prefetch_depth: int = 4,
    repeat: bool = False,
    decode_dtype: np.dtype | None = np.float32,
) -> Iterator[dict]:
    """Streaming TerraMesh reader → iterator of raw sample batches.

    Single modality: batches carry 'image' [B,H,W,C]. Multi-modality:
    batches carry one [B,H,W,C] array per modality name (for the
    random-modality collate, eovax_torch.data.collate).

    When the shard list spans both TerraMesh subsets (no explicit
    ``urls``), one batched stream is built per subset — with the subset's
    unavailable S1 modality filtered (build_multimodal_dataset,
    terramesh.py:499-513) — and **batches** are interleaved with probs
    [majortom 0.8, ssl4eos12 0.2] (wds.RandomMix parity, 553-557; the
    reference mixes batches, never samples, so subset batches stay pure).
    """
    mods = [modalities] if isinstance(modalities, str) else list(modalities)
    rng = random.Random(seed if seed is not None else 17)

    def make_batched(source_urls: list[str], source_mods: list[str]) -> Iterator[dict]:
        single = len(source_mods) == 1

        # Static per-process assignment — computed once so an empty
        # assignment (subset with fewer shards than processes) terminates
        # the stream instead of busy-spinning the `while True` repeat loop
        # forever without yielding (which would hang _random_mix/_prefetch).
        assigned = split_shards(
            list(source_urls),
            process_index=process_index, process_count=process_count,
        )

        def sample_stream() -> Iterator[dict]:
            if not assigned:
                warnings.warn(
                    f"No shards assigned to process {process_index}/"
                    f"{process_count} for a source with {len(source_urls)} "
                    "shards; this source yields nothing on this host."
                )
                return
            while True:
                shards = list(assigned)
                if shuffle:
                    rng.shuffle(shards)
                if single:
                    streams = (iter_tar_samples(s) for s in shards)
                else:
                    # Per-sample-key aligned shards across modalities: same
                    # shard filename under each modality directory.
                    streams = (
                        iter_multi_tar_samples(
                            [
                                s.replace(f"/{source_mods[0]}/", f"/{m}/")
                                for m in source_mods
                            ]
                        )
                        for s in shards
                    )

                def decoded():
                    def _decode(raw):
                        try:
                            return decode_sample(
                                raw, harmonize_s2l2a=harmonize_s2l2a,
                                dtype=decode_dtype,
                            )
                        except Exception as e:  # warn_and_continue parity
                            warnings.warn(f"Skipping corrupt sample: {e}")
                            return None

                    if num_reader_threads <= 1:
                        for stream in streams:
                            for raw in stream:
                                s = _decode(raw)
                                if s is not None:
                                    yield s
                    else:
                        # Decode samples in a thread pool (native blosc +
                        # zlib release the GIL) while the tar stream feeds it.
                        from concurrent.futures import ThreadPoolExecutor

                        with ThreadPoolExecutor(num_reader_threads) as pool:
                            for stream in streams:
                                for s in pool.map(_decode, stream, chunksize=1):
                                    if s is not None:
                                        yield s

                it = decoded()
                if shuffle:
                    it = _shuffled(it, shuffle_buffer, rng)
                yield from it
                if not repeat:
                    return

        it = sample_stream()
        if batch_size is not None:
            it = _batched(it, batch_size, partial)
        return it

    if urls is not None:
        return _prefetch(lambda: make_batched(list(urls), mods), prefetch_depth)

    # Subset resolution (shard_urls semantics): S1GRD only in ssl4eos12,
    # S1RTC only in majortom; everything else spans both.
    if mods == ["S1GRD"]:
        subsets = ("ssl4eos12",)
    elif mods == ["S1RTC"]:
        subsets = ("majortom",)
    else:
        subsets = ("majortom", "ssl4eos12")

    sources: list[tuple[list[str], list[str]]] = []
    probs: list[float] = []
    for subset in subsets:
        missing = "S1GRD" if subset == "majortom" else "S1RTC"
        smods = [m for m in mods if m != missing]
        if not smods:
            continue
        surls = [
            os.path.join(path, split, smods[0], g)
            for f in SPLIT_FILES[subset][split]
            for g in expand_braces(f)
        ]
        sources.append((surls, smods))
        probs.append(SUBSET_MIX_PROBS[subset])

    if len(sources) == 1:
        (surls, smods), = sources
        return _prefetch(lambda: make_batched(surls, smods), prefetch_depth)

    return _prefetch(
        lambda: _random_mix(
            [make_batched(u, m) for u, m in sources], probs, rng
        ),
        prefetch_depth,
    )


class TerraMeshPipeline:
    """DataModule equivalent (terramesh_datamodule.py:585-817): pairs the
    streaming reader with the modality collates and exposes train/val
    batch iterators ready for the Stage-2 trainer."""

    def __init__(
        self,
        data_path: str,
        modalities: list[str],
        *,
        batch_size: int = 8,
        eval_batch_size: int = 32,
        train_collate_mode: str = "random",
        val_collate_mode: str = "S2L2A",
        normalize: bool = True,
        norm_scheme: str = "legacy",
        target_size: tuple[int, int] | None = (256, 256),
        seed: int | None = None,
        num_workers: int = 4,  # reader/decoder threads (reference default)
        process_index: int = 0,
        process_count: int = 1,
        device_prep: bool = False,  # normalize+D4 on device (data/device_prep)
    ):
        from eovax_torch.data.collate import (
            deterministic_modality_collate,
            single_modality_collate,
        )

        self.data_path = data_path
        self.modalities = list(modalities)
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.process = dict(process_index=process_index, process_count=process_count)
        harmonize = norm_scheme == "custom" and "S2L2A" in self.modalities
        self._harmonize = harmonize

        if train_collate_mode == "random":
            self.train_collate = single_modality_collate(
                self.modalities, normalize=normalize, norm_scheme=norm_scheme,
                target_size=target_size, mode="train", seed=seed,
                device_prep=device_prep,
            )
        else:
            self.train_collate = deterministic_modality_collate(
                train_collate_mode, normalize=normalize, norm_scheme=norm_scheme,
                target_size=target_size, mode="train", seed=seed,
                device_prep=device_prep,
            )
        self.val_collate = deterministic_modality_collate(
            val_collate_mode, normalize=normalize, norm_scheme=norm_scheme,
            target_size=target_size, mode="eval", device_prep=device_prep,
        )

    def train_batches(self) -> Iterator[dict]:
        raw = build_terramesh_dataset(
            self.data_path, self.modalities, "train",
            batch_size=self.batch_size, shuffle=True, seed=self.seed,
            harmonize_s2l2a=self._harmonize, repeat=True,
            num_reader_threads=self.num_workers,
            # Stored dtype end-to-end (half the queue bytes for int16, no
            # per-sample cast): device_prep ships it raw to the device; the
            # host normalizer fuses the fp32 cast into its subtract.
            decode_dtype=None, **self.process,
        )
        return (self.train_collate(b) for b in raw)

    def val_batches(self) -> Iterator[dict]:
        raw = build_terramesh_dataset(
            self.data_path, self.modalities, "val",
            batch_size=self.eval_batch_size, shuffle=False,
            harmonize_s2l2a=self._harmonize,
            num_reader_threads=self.num_workers,
            decode_dtype=None, **self.process,
        )
        return (self.val_collate(b) for b in raw)
