"""The port's TerraMesh data path against the JAX package's.

The same shards (written with ``tests/_zarr_helpers.py``) and the same seeds
go through ``eovax`` and ``eovax_torch``: the native blosc decoder, the
zip-zarr reader, the streaming reader with its shuffle, subset mix, resync,
corrupt-shard handling and prefetch thread, the collates in both
``device_prep`` modes, ``device_prepare`` and the trainer's placement, and
the train CLI on shards. Every comparison is exact: the reader and the
collates copy numpy code, and ``device_prepare`` does the host normalizer's
fp32 operations one by one (no fused multiply-add), so equal inputs give
equal bits.

JAX and ``eovax`` are imported inside the tests that need them, so that the
``gpu``-marked tests run on a card's machine without JAX
(``python -m pytest tests/test_torch_data.py -m gpu --noconftest``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch
import yaml

from _zarr_helpers import (
    blosc_frame,
    lz4_literal_encode,
    shuffle_bytes,
    write_terramesh_shard,
    write_zarr_zip,
)

CUTOFF_NS = 1_642_982_400_000_000_000  # S2L2A_BASELINE_CUTOFF_NS of both packages
CHANNELS = {"S2L2A": 12, "S1RTC": 2, "S2RGB": 3}

# The split tables name hundreds of shards and the trees here hold a few: the
# readers warn for each missing one. The tests that count these warnings
# record them themselves.
pytestmark = pytest.mark.filterwarnings("ignore:Skipping corrupt shard")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models run fastest on one thread, and one thread does not
    oversubscribe the cores that the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same(got, ref, where="batch"):
    """Equal structure, keys in the same order, arrays of equal dtype, shape and bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), (where, list(got), list(ref))
        for k in ref:
            assert_same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert (got.dtype, got.shape) == (ref.dtype, ref.shape), where
        assert np.array_equal(got, ref), where
    else:
        assert type(got) is type(ref) and got == ref, (where, got, ref)


def _samples(modality, n, g, size=32):
    """TerraMesh-like samples: S2L2A int16 in 0-10000 with samples 2-3 of every
    4 stamped after the harmonization cutoff (so that an unshuffled batch of 2
    keeps int16 or is promoted to fp32 whole), S1RTC float32 dB, S2RGB uint8
    at ``size + 4`` (so that the collate resizes it)."""
    c = CHANNELS[modality]
    out = []
    for i in range(n):
        if modality == "S2L2A":
            bands = g.integers(0, 10001, (1, c, size, size)).astype("<i2")
            stamp = CUTOFF_NS + i if i % 4 >= 2 else CUTOFF_NS - 1 - i
        elif modality == "S1RTC":
            bands, stamp = g.normal(-14.0, 4.0, (1, c, size, size)).astype("<f4"), CUTOFF_NS
        else:
            bands, stamp = g.integers(0, 256, (1, c, size + 4, size + 4)).astype("u1"), CUTOFF_NS
        out.append({"bands": bands, "time": stamp})
    return out


def write_tree(root, n_train=(8, 4), n_val=(4, 4), size=32, seed=5):
    """A TerraMesh tree with one present shard per (subset, split, modality),
    named as in ``SPLIT_FILES``: majortom holds S2L2A, S1RTC and S2RGB,
    ssl4eos12 S2L2A and S2RGB. The other names of the split tables are
    missing, and the readers skip them with a warning."""
    g = np.random.default_rng(seed)
    layout = [("train", "majortom_shard_000001.tar", n_train[0], CHANNELS),
              ("train", "ssl4eos12_shard_000794.tar", n_train[1], ("S2L2A", "S2RGB")),
              ("val", "majortom_shard_000001.tar", n_val[0], CHANNELS),
              ("val", "ssl4eos12_shard_000009.tar", n_val[1], ("S2L2A", "S2RGB"))]
    for split, name, n, mods in layout:
        for mod in mods:
            d = root / split / mod
            d.mkdir(parents=True, exist_ok=True)
            write_terramesh_shard(str(d / name), _samples(mod, n, g, size))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("terramesh"))


def _quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with the readers' warnings recorded; returns both."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(w.message) for w in caught]


# -- the native blosc decoder ----------------------------------------------------------------

_FRAMES = {
    "lz4-typesize1": dict(codec="lz4", typesize=1),
    "lz4-typesize4": dict(codec="lz4", typesize=4),
    "blosclz-typesize1": dict(codec="blosclz", typesize=1),
    "blosclz-typesize4": dict(codec="blosclz", typesize=4),
    "memcpy-typesize1": dict(codec="memcpy", typesize=1, shuffle=False),
    "memcpy-typesize4": dict(codec="memcpy", typesize=4, shuffle=False),
    "lz4-unshuffled": dict(codec="lz4", typesize=4, shuffle=False),
    "lz4-multiblock": dict(codec="lz4", typesize=4, blocksize=4096),
    "blosclz-multiblock-typesize2": dict(codec="blosclz", typesize=2, blocksize=1024),
}


@pytest.mark.parametrize("kind", list(_FRAMES))
def test_native_blosc_equals_eovax(kind):
    """Every frame kind of tests/test_terramesh.py (split and unsplit streams,
    shuffled or not, several blocks with a short last one): byte-equal."""
    from eovax import native as jnative
    from eovax_torch import native

    data = np.random.default_rng(1).integers(0, 255, 10_000, dtype=np.uint8).tobytes()
    frame = blosc_frame(data, **_FRAMES[kind])
    assert native.blosc_decompress(frame) == jnative.blosc_decompress(frame) == data
    assert native.blosc_header(frame) == jnative.blosc_header(frame)


def test_native_lz4_and_unshuffle_equal_eovax():
    from eovax import native as jnative
    from eovax_torch import native

    data = np.random.default_rng(3).integers(0, 255, 403, dtype=np.uint8).tobytes()
    comp = lz4_literal_encode(data)
    assert native.lz4_decompress(comp, len(data)) == jnative.lz4_decompress(comp, len(data)) == data
    for typesize in (2, 4):  # 403 bytes: a tail that no typesize divides
        shuffled = shuffle_bytes(data, typesize)
        assert native.unshuffle(typesize, shuffled) == jnative.unshuffle(typesize, shuffled) == data


def test_native_unhandled_codec_and_failed_build(tmp_path, monkeypatch):
    """A zlib-coded frame is NotImplementedError (the zip-zarr reader then decodes
    it in Python); a source that does not compile raises NativeBuildError."""
    from eovax_torch import native

    frame = blosc_frame(b"x" * 4096, typesize=4, codec="zlib")
    with pytest.raises(NotImplementedError, match="codec id 3"):
        native.blosc_decompress(frame)
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(native.NativeBuildError, match="native build failed"):
        native.blosc_decompress(frame)


# -- the zip-zarr reader ----------------------------------------------------------------------


@pytest.mark.parametrize("compressor", ["lz4", "blosclz", "memcpy", "zlib", "blosc-zlib", None])
def test_zarrzip_group_equals_eovax(compressor):
    from eovax.data.zarrzip import ZarrZipGroup as JaxGroup
    from eovax_torch.data.zarrzip import ZarrZipGroup

    g = np.random.default_rng(4)
    arrays = {"bands": g.integers(-500, 10000, (1, 12, 8, 8)).astype("<i2"),
              "time": np.asarray([CUTOFF_NS], "<i8"),
              "cloud_mask": g.normal(size=(1, 1, 8, 8)).astype("<f4")}
    blob = write_zarr_zip(arrays, compressor)
    ours, ref = ZarrZipGroup(blob), JaxGroup(blob)
    assert sorted(ours.keys()) == sorted(ref.keys()) == sorted(arrays)
    for name in arrays:
        assert_same(ours[name], ref[name], name)
        assert_same(ours[name], arrays[name], name)
    assert ours.get("absent", 7) == 7


@pytest.mark.parametrize("dtype", [None, np.float32])
@pytest.mark.parametrize("offset", [-1, 0])
def test_harmonization_equals_eovax(dtype, offset):
    """+1000 from the cutoff on, promoting the stored int16 to fp32; before it
    the stored dtype stays (``dtype=None``)."""
    from eovax.data.zarrzip import decode_zarr_zip_bands as jax_decode
    from eovax_torch.data.zarrzip import decode_zarr_zip_bands

    bands = np.random.default_rng(6).integers(0, 10000, (1, 12, 4, 4)).astype("<i2")
    blob = write_zarr_zip({"bands": bands, "time": np.asarray([CUTOFF_NS + offset], "<i8")})
    for harmonize in (False, True):
        ours = decode_zarr_zip_bands(blob, harmonize_s2l2a=harmonize, dtype=dtype)
        assert_same(ours, jax_decode(blob, harmonize_s2l2a=harmonize, dtype=dtype))
    assert ours.dtype == (np.float32 if offset == 0 or dtype else np.int16)
    assert ours.min() >= (1000 if offset == 0 else 0)


# -- the streaming reader ---------------------------------------------------------------------


def _both(fn_name, *args, **kw):
    """``fn_name`` of both packages' terramesh modules on the same arguments,
    each drained to a list with its warnings."""
    import eovax.data.terramesh as jtm
    import eovax_torch.data.terramesh as ttm

    return [_quiet(lambda m=m: list(getattr(m, fn_name)(*args, **kw))) for m in (ttm, jtm)]


_READER_CASES = {
    "single-modality": dict(modalities="S2RGB", batch_size=3, partial=True),
    "single-modality-fp32": dict(modalities="S2L2A", batch_size=2, decode_dtype=np.float32,
                                 harmonize_s2l2a=True),
    "multimodal": dict(modalities=["S2L2A", "S1RTC", "S2RGB"], batch_size=2,
                       harmonize_s2l2a=True),
    "shuffled-seed": dict(modalities=["S2L2A", "S2RGB"], batch_size=2, shuffle=True,
                          shuffle_buffer=3, seed=11),
    "two-reader-threads": dict(modalities=["S2L2A", "S1RTC"], batch_size=2,
                               num_reader_threads=2, shuffle=True, seed=2),
    "unbatched": dict(modalities="S2RGB", batch_size=None),
}


@pytest.mark.parametrize("case", list(_READER_CASES))
def test_reader_on_shard_urls_equals_eovax(tree, case):
    """One shard list, given as urls: the same batches (keys, arrays, dtypes)."""
    kw = {"decode_dtype": None, **_READER_CASES[case]}
    mods = kw.pop("modalities")
    first = mods if isinstance(mods, str) else mods[0]
    urls = [os.path.join(tree, "train", first, "majortom_shard_000001.tar")]
    (ours, _), (ref, _) = _both("build_terramesh_dataset", tree, mods, "train", urls=urls, **kw)
    assert ours and len(ours) == len(ref)
    assert_same(ours, ref)


@pytest.mark.parametrize("split,mods", [("train", ["S2L2A", "S1RTC", "S2RGB"]),
                                        ("val", ["S2L2A", "S2RGB"]), ("val", ["S1RTC"])])
def test_reader_over_the_split_tables_equals_eovax(tree, split, mods):
    """Without urls: the SPLIT_FILES names of both subsets (missing ones skipped
    with a warning), S1RTC only from majortom, batches mixed [0.8, 0.2] by a
    seeded draw and drained to the end of both subsets."""
    (ours, warned), (ref, _) = _both("build_terramesh_dataset", tree, mods, split,
                                     batch_size=2, seed=3, harmonize_s2l2a=True,
                                     decode_dtype=None, num_reader_threads=2)
    assert_same(ours, ref)
    present = 2 if "S2L2A" in mods else 1
    per_subset = ([8, 4] if split == "train" else [4, 4])[:present]
    assert sum(len(b["__key__"]) for b in ours) == sum(per_subset)
    assert any("Skipping corrupt shard" in w for w in warned)


def test_reader_subset_mix_repeats_equal_eovax(tree):
    """``repeat=True`` with shuffle, as the train pipeline reads: the first 30
    batches (several passes over both subsets) are equal."""
    import eovax.data.terramesh as jtm
    import eovax_torch.data.terramesh as ttm

    def take(m):
        it = m.build_terramesh_dataset(tree, ["S2L2A", "S2RGB"], "train", batch_size=2,
                                       shuffle=True, seed=9, repeat=True, decode_dtype=None)
        out = list(itertools.islice(it, 30))
        it.close()
        return out

    (ours, _), (ref, _) = _quiet(take, ttm), _quiet(take, jtm)
    assert_same(ours, ref)


def test_multimodal_resync_on_a_missing_sample_equals_eovax(tmp_path):
    g = np.random.default_rng(0)
    keys = {"S2RGB": ["sample_0000", "sample_0001", "sample_0002", "sample_0003"],
            "S1RTC": ["sample_0000", "sample_0002", "sample_0003"]}
    for mod, names in keys.items():
        d = tmp_path / "train" / mod
        d.mkdir(parents=True)
        write_terramesh_shard(str(d / "majortom_shard_000001.tar"),
                              _samples(mod, len(names), g, 8), keys=names)
    urls = [str(tmp_path / "train" / "S2RGB" / "majortom_shard_000001.tar")]
    (ours, warned), (ref, _) = _both("build_terramesh_dataset", str(tmp_path),
                                     ["S2RGB", "S1RTC"], "train", urls=urls, batch_size=None)
    assert_same(ours, ref)
    assert [s["__key__"] for s in ours] == ["sample_0000", "sample_0002", "sample_0003"]
    assert any("resyncing" in w for w in warned)


def test_corrupt_shard_and_sample_are_skipped_as_in_eovax(tmp_path):
    """A shard that is not a tar and a member that is not a zip are skipped with
    a warning; the good samples around them come through."""
    import io
    import tarfile

    g = np.random.default_rng(8)
    d = tmp_path / "train" / "S2RGB"
    d.mkdir(parents=True)
    (d / "majortom_shard_000001.tar").write_bytes(b"not a tar archive" * 50)
    good = d / "majortom_shard_000002.tar"
    write_terramesh_shard(str(good), _samples("S2RGB", 3, g, 8))
    with tarfile.open(good, "a") as tf:
        info = tarfile.TarInfo("zz_bad.zarr.zip")
        info.size = 9
        tf.addfile(info, io.BytesIO(b"not a zip"))
    urls = [str(d / "majortom_shard_000001.tar"), str(good)]
    (ours, warned), (ref, _) = _both("build_terramesh_dataset", str(tmp_path), "S2RGB", "train",
                                     urls=urls, batch_size=2, partial=True)
    assert_same(ours, ref)
    assert sum(len(b["__key__"]) for b in ours) == 3
    assert any("Skipping corrupt shard" in w for w in warned)
    assert any("Skipping corrupt sample" in w for w in warned)


def test_empty_assignment_ends_as_in_eovax(tree):
    urls = [os.path.join(tree, "train", "S2RGB", "majortom_shard_000001.tar")]
    (ours, warned), (ref, _) = _both("build_terramesh_dataset", tree, "S2RGB", "train",
                                     urls=urls, repeat=True, process_index=3, process_count=4)
    assert ours == ref == []
    assert any("No shards assigned" in w for w in warned)
    # Two processes split the shard list round-robin, as in eovax.
    from eovax.data.terramesh import split_shards as jax_split
    from eovax_torch.data.terramesh import SPLIT_FILES, expand_braces, split_shards

    names = expand_braces(SPLIT_FILES["majortom"]["train"][0])
    assert len(names) == 793
    for p in range(2):
        assert split_shards(names, process_index=p, process_count=2) == jax_split(
            names, process_index=p, process_count=2)


def test_prefetch_close_stops_the_producer(tree):
    """Closing an abandoned reader (an early-stopped fit) ends its producer
    thread, which would otherwise stay blocked on the full queue."""
    from eovax_torch.data.terramesh import build_terramesh_dataset

    before = set(threading.enumerate())
    urls = [os.path.join(tree, "train", "S2RGB", "majortom_shard_000001.tar")]
    it = build_terramesh_dataset(tree, "S2RGB", urls=urls, batch_size=2, repeat=True,
                                 prefetch_depth=2)
    next(it)
    spawned = [t for t in threading.enumerate() if t not in before]
    assert spawned
    it.close()
    deadline = time.time() + 10.0
    while any(t.is_alive() for t in spawned) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in spawned)


def test_prefetch_raises_the_producers_error_as_eovax_does():
    from eovax.data.terramesh import _prefetch as jax_prefetch
    from eovax_torch.data.terramesh import _prefetch

    def exploding():
        yield 1
        yield 2
        raise RuntimeError("shard 37 unreadable")

    def broken_factory():
        raise OSError("no shards match pattern")

    for prefetch in (_prefetch, jax_prefetch):
        it = prefetch(exploding, depth=2)
        assert [next(it), next(it)] == [1, 2]
        with pytest.raises(RuntimeError, match="shard 37 unreadable"):
            next(it)
        with pytest.raises(OSError, match="no shards"):
            next(prefetch(broken_factory, depth=2))


def test_tables_equal_eovax():
    import eovax.data.terramesh as jtm
    import eovax_torch.data.terramesh as ttm

    assert ttm.SPLIT_FILES == jtm.SPLIT_FILES and ttm.STATISTICS == jtm.STATISTICS
    assert ttm.SUBSET_MIX_PROBS == jtm.SUBSET_MIX_PROBS
    assert ttm.S2L2A_BASELINE_CUTOFF_NS == jtm.S2L2A_BASELINE_CUTOFF_NS == CUTOFF_NS
    for mod in ("S1GRD", "S1RTC", "S2L2A"):
        for split in ("train", "val"):
            assert ttm.shard_urls("/d", mod, split) == jtm.shard_urls("/d", mod, split)


# -- the collates -----------------------------------------------------------------------------


def _raw_batches(n, g):
    """Raw decoded multimodal batches of 4: S2L2A int16 (every other batch fp32
    after harmonization), S1RTC fp32 at 32², S2RGB uint8 at 36²."""
    out = []
    for i in range(n):
        s2 = g.integers(0, 12000, (4, 32, 32, 12)).astype(np.int16)
        out.append({"S2L2A": s2.astype(np.float32) + 1000.0 if i % 2 else s2,
                    "S1RTC": g.normal(-14.0, 4.0, (4, 32, 32, 2)).astype(np.float32),
                    "S2RGB": g.integers(0, 256, (4, 36, 36, 3)).astype(np.uint8)})
    return out


_COLLATES = [(kind, mode, dp) for kind in ("single", "S2L2A", "S2RGB", "nonsquare")
             for mode in ("train", "eval") for dp in (False, True)]


@pytest.mark.parametrize("kind,mode,device_prep", _COLLATES,
                         ids=[f"{k}-{m}-{'device_prep' if d else 'host'}" for k, m, d in _COLLATES])
def test_collates_equal_eovax(kind, mode, device_prep):
    """single_modality_collate over three modalities and deterministic_modality_collate
    on S2L2A, on S2RGB (the resize branch) and on a non-square S2L2A batch with no
    resize (device_prep folds odd rotations), in both schemes: equal outputs."""
    import eovax.data.collate as jcol
    import eovax_torch.data.collate as tcol

    raws = _raw_batches(6, np.random.default_rng(12))
    for scheme in ("legacy", "custom"):
        outs = []
        for m in (tcol, jcol):
            kw = dict(normalize=True, norm_scheme=scheme, mode=mode, seed=4,
                      device_prep=device_prep, target_size=(32, 32))
            if kind == "single":
                collate = m.single_modality_collate(list(CHANNELS), **kw)
            elif kind == "nonsquare":
                collate = m.deterministic_modality_collate("S2L2A", **{**kw, "target_size": None})
            else:
                collate = m.deterministic_modality_collate(kind, **kw)
            batches = raws if kind != "nonsquare" else [
                {"S2L2A": r["S2L2A"][:, :, :24]} for r in raws]
            outs.append([collate(dict(b)) for b in batches])
        assert_same(outs[0], outs[1])
    if device_prep and mode == "train":
        assert all("d4" in b for b in outs[0])
        if kind == "nonsquare":
            assert all(b["d4"][0, 2] in (0, 2) for b in outs[0])


@pytest.mark.parametrize("kind", ["single", "S2L2A", "S2RGB"])
def test_device_prepare_of_a_device_prep_batch_equals_the_host_collate(kind):
    """The two collate modes from one seed: ``device_prepare`` of the raw batch
    and its descriptors is bit for bit the host-collated batch."""
    from eovax_torch.data import collate as tcol
    from eovax_torch.data.device_prep import device_prepare

    raws = _raw_batches(6, np.random.default_rng(13))
    for mode in ("train", "eval"):
        pair = []
        for dp in (True, False):
            kw = dict(norm_scheme="custom", mode=mode, seed=4, device_prep=dp,
                      target_size=(32, 32))
            collate = (tcol.single_modality_collate(list(CHANNELS), **kw) if kind == "single"
                       else tcol.deterministic_modality_collate(kind, **kw))
            pair.append([collate(dict(b)) for b in raws])
        for dp_batch, host in zip(*pair):
            leaves = [torch.from_numpy(dp_batch[k]) for k in
                      ("image", "norm_mean", "norm_std", "norm_clip")]
            d4 = torch.from_numpy(dp_batch["d4"]) if "d4" in dp_batch else None
            assert torch.equal(device_prepare(*leaves, d4), torch.from_numpy(host["image"]))
            assert dp_batch["modality"] == host["modality"]


# -- device_prepare against the JAX function -------------------------------------------------


def _prep_inputs(b, h, w, c, dtype, scheme, per_sample_desc, seed=0):
    from eovax_torch.data.normalize import make_normalizer

    g = np.random.default_rng(seed)
    image = g.integers(-200, 12000, (b, h, w, c))
    image = image.astype(np.int16) if dtype == "int16" else (image + 0.25).astype(np.float32)
    n = make_normalizer("S2L2A", scheme)
    mean, std = n.mean[:c], (n.std + n.eps)[:c]
    clip = np.asarray(n.clip if n.clip is not None else (-np.inf, np.inf), np.float32)
    if per_sample_desc:
        mean, std, clip = (np.tile(v, (b, 1)) for v in (mean, std, clip))
    return image, np.asarray(mean, np.float32), np.asarray(std, np.float32), clip


def _both_prepare(image, mean, std, clip, d4):
    import jax.numpy as jnp

    from eovax.data.device_prep import device_prepare as jax_prepare
    from eovax_torch.data.device_prep import device_prepare

    t = [torch.from_numpy(v) for v in (image, mean, std, clip)]
    ours = device_prepare(*t, None if d4 is None else torch.from_numpy(d4)).numpy()
    ref = np.asarray(jax_prepare(*(jnp.asarray(v) for v in (image, mean, std, clip)),
                                 None if d4 is None else jnp.asarray(d4)))
    return ours, ref


@pytest.mark.parametrize("case", range(16), ids=[f"fh{c >> 3}-fv{(c >> 2) & 1}-k{c & 3}"
                                                  for c in range(16)])
def test_device_prepare_equals_jax_on_every_d4_case(case):
    """Each (flip_h, flip_v, rot_k) as a [3] draw and as [B,3] rows, square and
    non-square (where odd k does not rotate): np.array_equal."""
    d4 = np.asarray([case >> 3, (case >> 2) & 1, case & 3], np.int32)
    for h, w, scheme, per_sample in ((8, 8, "custom", True), (6, 10, "legacy", False)):
        inputs = _prep_inputs(3, h, w, 4, "int16", scheme, per_sample, seed=case)
        for leaf in (d4, np.tile(d4, (3, 1))):
            ours, ref = _both_prepare(*inputs, leaf)
            assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
            assert np.array_equal(ours, ref), (h, w, leaf.shape)


_PREP = [(dtype, scheme, per_sample, square) for dtype in ("int16", "fp32")
         for scheme in ("legacy", "custom") for per_sample in (False, True)
         for square in (True, False)]


@pytest.mark.parametrize("dtype,scheme,per_sample,square", _PREP,
                         ids=[f"{d}-{s}-{'BC' if p else 'C'}-{'square' if q else 'nonsquare'}"
                              for d, s, p, q in _PREP])
def test_device_prepare_equals_jax(dtype, scheme, per_sample, square):
    """[C] and [B,C] descriptors, legacy (no clip) and custom ([0, 10000]) clips,
    int16 and fp32 input, per-sample d4 rows that differ and no d4 (eval):
    np.array_equal (the subtract and the multiply are separate roundings on
    both sides; XLA on the CPU does not contract them)."""
    b = 5
    inputs = _prep_inputs(b, 8, 8 if square else 12, 3, dtype, scheme, per_sample)
    rows = np.asarray([[0, 0, 0], [1, 0, 1], [0, 1, 2], [1, 1, 3], [1, 0, 2]], np.int32)
    for d4 in (rows, None):
        ours, ref = _both_prepare(*inputs, d4)
        assert np.array_equal(ours, ref), d4 is None


# -- the pipeline and the trainer -------------------------------------------------------------


def _pipelines(tree, device_prep, **kw):
    import eovax.data.terramesh as jtm
    import eovax_torch.data.terramesh as ttm

    args = dict(batch_size=2, eval_batch_size=2, norm_scheme="custom", target_size=(32, 32),
                seed=1, num_workers=2, device_prep=device_prep, **kw)
    return [m.TerraMeshPipeline(tree, list(CHANNELS), **args) for m in (ttm, jtm)]


def _take(factory, n):
    it = factory()
    out = list(itertools.islice(it, n))
    it.close()
    return out


@pytest.mark.parametrize("device_prep", [False, True])
def test_pipeline_batches_equal_eovax(tree, device_prep):
    """TerraMeshPipeline.train_batches (shuffled, repeated, the random-modality
    collate) and val_batches (S2L2A, eval): equal batches from both packages."""
    ours, ref = _pipelines(tree, device_prep)
    train = [_quiet(_take, p.train_batches, 8)[0] for p in (ours, ref)]
    val = [_quiet(_take, p.val_batches, 10)[0] for p in (ours, ref)]
    assert_same(train[0], train[1])
    assert_same(val[0], val[1])
    assert len(train[0]) == 8 and len(val[0]) == 4
    assert all("d4" not in b for b in val[0])
    if device_prep:
        dtypes = {b["image"].dtype for b in train[0] + val[0] if b["modality"] == "S2L2A"}
        assert dtypes == {np.dtype(np.int16), np.dtype(np.float32)}  # stored, and harmonised


def _tiny_cfg():
    from eovax_torch.core import config as tcfg

    stem = tcfg.StemConfig(num_layers=1, wv_planes=32, use_adain=True)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    return tcfg.VAEConfig(encoder=tcfg.EncoderConfig(in_channels=4, **kw),
                          decoder=tcfg.DecoderConfig(out_ch=4, **kw), base_lr=1e-4,
                          final_lr=1e-5, warmup_epochs=0, decay_end_epoch=1, clip_grad=1.0)


def _trainer(variables, **kw):
    from eovax_torch import EOFluxVAE
    from eovax_torch.losses import EOConsistencyLoss
    from eovax_torch.train import stage2

    cfg = _tiny_cfg()
    model = EOFluxVAE(cfg, variables, device=kw.pop("device", "cpu"))
    loss = EOConsistencyLoss(rec_loss_type="char", msssim_weight=0.0)
    return stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, log_every=0, **kw)


def test_fit_on_device_prep_batches_equals_fit_on_host_batches(tree):
    """Three steps of the tiny model on the CPU from the same shards, collated
    with and without device_prep: the final state dicts are torch.equal; each
    prepared tensor equals the host batch and what eovax's ``_resolve_image``
    makes of the same batch; validation logs the same means and image grid."""
    import jax.numpy as jnp

    from eovax.train.stage2 import _resolve_image
    from eovax_torch import EOFluxVAE

    variables = EOFluxVAE(_tiny_cfg(), device="cpu", seed=0).core.state_dict()
    batches, vals, states, grids, means = {}, {}, {}, {}, {}
    for dp in (True, False):
        pipe = _pipelines(tree, dp)[0]
        batches[dp] = _quiet(_take, pipe.train_batches, 3)[0]
        vals[dp] = _quiet(_take, pipe.val_batches, 2)[0]
        logged = []
        logger = types.SimpleNamespace(log=lambda *a, logged=logged, **k: logged.append(a[:2]))
        trainer = _trainer(variables, max_steps=3, image_logger=logger)
        state = trainer.fit(iter(batches[dp]))
        assert state.step == 3
        means[dp] = trainer.validate(state, iter(vals[dp]), max_batches=2)
        states[dp], grids[dp] = trainer.core.state_dict(), logged
    assert [b["modality"] for b in batches[True]] == [b["modality"] for b in batches[False]]
    for name, value in states[True].items():
        assert torch.equal(value, states[False][name]), name
    assert means[True] == means[False]
    assert_same(grids[True], grids[False])

    trainer = _trainer(variables)
    for dp_batch, host in zip(batches[True] + vals[True], batches[False] + vals[False]):
        image, wvs = trainer._place(dp_batch)
        assert image.is_contiguous() and image.dtype == torch.float32
        host_image, host_wvs = trainer._place(host)
        assert torch.equal(image, host_image) and torch.equal(wvs, host_wvs)
        leaves = tuple(jnp.asarray(dp_batch[k]) for k in ("image", "norm_mean", "norm_std",
                                                           "norm_clip", "d4") if k in dp_batch)
        ref = np.asarray(_resolve_image(leaves)).transpose(0, 3, 1, 2)
        assert np.array_equal(image.numpy(), ref)
    assert set(trainer._wvs_cache) == {b["modality"] for b in batches[True] + vals[True]}


def test_device_prep_placement_refuses_several_processes(monkeypatch):
    from eovax_torch.data.collate import deterministic_modality_collate
    from eovax_torch.train import stage2

    trainer = _trainer(None)
    batch = deterministic_modality_collate("S2L2A", mode="eval", target_size=None,
                                           device_prep=True)(
        {"S2L2A": np.zeros((1, 8, 8, 12), np.int16)})
    monkeypatch.setattr(stage2, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 3d"):
        trainer._place(batch)


def _tiny_yaml(tmp_path, data_path, device_prep):
    stem = {"num_layers": 1, "wv_planes": 32, "use_adain": True}
    part = {"z_channels": 8, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "use_dynamic_ops": True, "dynamic_conv_kwargs": stem}
    raw = {
        "experiment": {"experiment_name": "tiny", "exp_dir": str(tmp_path / "exps")},
        "wandb": {"mode": "disabled"},
        "model": {"base_lr": 1e-4, "final_lr": 1e-5, "warmup_epochs": 0, "decay_end_epoch": 1,
                  "clip_grad": 1.0,
                  "loss_fn": {"_target_": "eo_vae.models.modules.consistency_loss."
                                          "EOConsistencyLoss", "rec_loss_type": "char"},
                  "encoder": {**part, "in_channels": 4}, "decoder": {**part, "out_ch": 4}},
        "datamodule": {"data_path": data_path, "modalities": ["S2L2A", "S1RTC", "S2RGB"],
                       "batch_size": 2, "eval_batch_size": 2, "train_collate_mode": "random",
                       "val_collate_mode": "S2L2A", "normalize": True, "norm_scheme": "custom",
                       "target_size": [32, 32], "num_workers": 2, "device_prep": device_prep},
        "trainer": {"max_epochs": 1, "limit_train_batches": 1, "limit_val_batches": 1,
                    "log_every_n_steps": 1},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("device_prep", [True, False])
def test_train_cli_trains_from_shards(tmp_path, tree, device_prep):
    """``eovax_torch.cli.train`` without --synthetic-data: 2 steps from the shards,
    validating and saving after each, then the final and best models; its reader
    threads are stopped when it returns."""
    from eovax_torch.cli import train
    from eovax_torch.utils.checkpoint import TrainCheckpointer

    config = _tiny_yaml(tmp_path, tree, device_prep)
    before = set(threading.enumerate())
    _quiet(train.main, ["--config", config, "--device", "cpu", "--precision", "32-true",
                        "--max-steps", "2"])
    (exp,) = (tmp_path / "exps").iterdir()
    for name in ("config.yaml", "metrics.csv", "eo-vae-final.pt", "eo-vae-best.pt"):
        assert (exp / name).exists(), name
    assert TrainCheckpointer(str(exp / "checkpoints")).all_steps() == [1, 2]
    assert len(list((exp / "image_log" / "val").glob("*.png"))) == 2
    rows = (exp / "metrics.csv").read_text().splitlines()
    head = rows[0].split(",")
    losses = [float(v) for row in rows[1:] for k, v in zip(head, row.split(","))
              if k in ("train/loss_total", "val/loss_total") and v]
    assert len(losses) == 4 and np.isfinite(losses).all()
    deadline = time.time() + 10.0
    while any(t.is_alive() for t in set(threading.enumerate()) - before):
        assert time.time() < deadline, "the reader's threads outlived the CLI"
        time.sleep(0.02)


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_prepare_on_card_equals_cpu(cuda_device):
    """All 16 D4 cases as [3] and [B,3], per-sample rows that differ, and no d4,
    square and non-square, int16 and fp32: torch.equal to the CPU."""
    from eovax_torch.data.device_prep import device_prepare

    rows = torch.tensor([[0, 0, 0], [1, 0, 1], [0, 1, 2], [1, 1, 3]], dtype=torch.int32)
    cases = [torch.tensor([c >> 3, (c >> 2) & 1, c & 3], dtype=torch.int32) for c in range(16)]
    for dtype, scheme, w in (("int16", "custom", 16), ("fp32", "legacy", 16), ("int16", "legacy", 24)):
        inputs = [torch.from_numpy(v) for v in _prep_inputs(4, 16, w, 12, dtype, scheme, True)]
        on_card = [v.to(cuda_device) for v in inputs]
        for d4 in cases + [c.expand(4, 3).contiguous() for c in cases] + [rows, None]:
            ref = device_prepare(*inputs, d4)
            got = device_prepare(*on_card, None if d4 is None else d4.to(cuda_device))
            assert got.device.type == "cuda" and torch.equal(got.cpu(), ref), (dtype, w, d4)


@pytest.mark.gpu
def test_trainer_placement_on_card_equals_cpu(cuda_device, tmp_path):
    """The trainer's placement of device_prep batches from shards on the card is
    torch.equal to the host-collated batch placed on the CPU."""
    import eovax_torch.data.terramesh as ttm

    root = write_tree(tmp_path)
    card, cpu = _trainer(None, device=cuda_device), _trainer(None)
    for factory in ("train_batches", "val_batches"):
        pair = []
        for dp in (True, False):
            pipe = ttm.TerraMeshPipeline(root, list(CHANNELS), batch_size=2, eval_batch_size=2,
                                         norm_scheme="custom", target_size=(32, 32), seed=1,
                                         num_workers=2, device_prep=dp)
            pair.append(_quiet(_take, getattr(pipe, factory), 4)[0])
        for dp_batch, host in zip(*pair):
            image, wvs = card._place(dp_batch)
            ref, ref_wvs = cpu._place(host)
            assert image.device.type == "cuda" and image.is_contiguous()
            assert torch.equal(image.cpu(), ref) and torch.equal(wvs.cpu(), ref_wvs)
