"""The port's host utilities on the CPU against the JAX package's: slope-method
timing (as ``tests/test_slopetime.py`` pins the JAX version's contract), the
streaming histogram, the ``compute_stats`` and ``inspect_terramesh`` CLIs on a
shard tree written by ``tests/_zarr_helpers.py``, SeasoNet's numpy parts (a
stand-in ``torchgeo`` module, which neither machine has), and the profiling
helpers.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from eovax_torch.utils.slopetime import (
    chained_ms,
    random_variables,
    scalar_chained_ms,
    slope_ms,
)
from test_torch_data import write_tree

# The split tables name hundreds of shards and the tree here holds a few: the
# readers warn for each missing one.
pytestmark = pytest.mark.filterwarnings("ignore:Skipping corrupt shard")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Slope-method timing
# ---------------------------------------------------------------------------


def test_slope_ms_call_protocol_and_slope():
    """Each length warmed twice, then timed twice, lo before hi, as the JAX
    package's; the result is a per-iteration slope in ms."""
    calls = []

    def loop(x0, n):
        calls.append(n)
        return torch.zeros(()) + x0 * n

    ms = slope_ms(loop, 1.0, lo=3, hi=9)
    assert calls == [3, 3, 9, 9, 3, 3, 9, 9]
    assert isinstance(ms, float)


def test_slope_ms_reads_the_chain():
    """A chain whose iteration sleeps 5 ms reads about 5 ms an iteration: the
    constant call overhead cancels in the difference."""
    import time

    def loop(x0, n):
        for _ in range(n):
            time.sleep(0.005)
        return x0

    assert 4.0 < slope_ms(loop, torch.zeros(()), lo=2, hi=6) < 15.0


def test_chained_ms_runs_fn_n_times(monkeypatch):
    """The chain applies fn exactly n times (2^n proves it), consts passed
    through as the JAX package's."""
    from eovax_torch.utils import slopetime as st

    out = {}

    def probe(loop, x0, lo, hi):
        out["val"] = float(loop(x0, 5))
        return 0.0

    monkeypatch.setattr(st, "slope_ms", probe)
    chained_ms(lambda c, x: x * c, torch.tensor(1.0), consts=torch.tensor(2.0), lo=5, hi=15)
    assert out["val"] == 32.0  # 2^5


def test_scalar_chained_ms_scalar_contract(monkeypatch):
    """The carry starts as an fp32 zero scalar on the consts' device."""
    from eovax_torch.utils import slopetime as st

    out = {}

    def probe(loop, x0, lo, hi):
        assert x0.shape == () and x0.dtype == torch.float32 and x0.device.type == "cpu"
        out["val"] = float(loop(x0, 4))
        return 0.0

    monkeypatch.setattr(st, "slope_ms", probe)
    scalar_chained_ms(lambda c, s: s + c, consts=torch.tensor(1.0), lo=4, hi=12)
    assert out["val"] == 4.0


def test_random_variables_shapes_and_bn_reset():
    """N(0, 0.02) for every parameter, BatchNorm's running statistics reset to
    identity and its step count to 0; the dict loads strictly."""
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with torch.no_grad():
        m[1].running_mean.fill_(3.0)
        m[1].running_var.fill_(5.0)
    sd = random_variables(m)
    assert sd["0.weight"].shape == (4, 3) and sd["0.weight"].dtype == torch.float32
    assert 0 < float(sd["0.weight"].abs().max()) < 0.2
    assert torch.equal(sd["1.running_mean"], torch.zeros(4))
    assert torch.equal(sd["1.running_var"], torch.ones(4))
    assert sd["1.num_batches_tracked"].dtype == torch.long and int(sd["1.num_batches_tracked"]) == 0
    m.load_state_dict(sd, strict=True)
    again = random_variables(m, np.random.default_rng(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ---------------------------------------------------------------------------
# The streaming histogram
# ---------------------------------------------------------------------------


def test_histogram_counts_equal_the_jax_packages(tmp_path):
    """The same NHWC and [C, ...] updates give the JAX package's counts and
    quantiles exactly; ``plot`` writes a PNG (matplotlib imported there)."""
    from eovax.utils.histogram import StreamingHistogram as JaxHistogram
    from eovax_torch.utils.histogram import StreamingHistogram

    g = np.random.default_rng(3)
    ours, ref = StreamingHistogram(3, bins=400), JaxHistogram(3, bins=400)
    for x in (g.normal(0, 400, (2, 8, 8, 3)), g.normal(-999, 50, (3, 16, 4)),
              g.integers(-1500, 1500, (1, 4, 4, 3))):
        ours.update(x)
        ref.update(x)
    np.testing.assert_array_equal(ours.hist_counts, ref.hist_counts)
    np.testing.assert_array_equal(ours.bin_centers, ref.bin_centers)
    for q in (0.02, 0.5, 0.98):
        np.testing.assert_array_equal(ours.quantile(q), ref.quantile(q))
    pytest.importorskip("matplotlib")
    path = ours.plot(str(tmp_path / "hist.png"), channel_names=["a", "b", "c"])
    assert (tmp_path / "hist.png").stat().st_size > 0 and path.endswith("hist.png")


# ---------------------------------------------------------------------------
# compute_stats and inspect_terramesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("terramesh"))


@pytest.mark.parametrize("argv", [
    ["--modality", "S2L2A", "--split", "val", "--harmonize"],
    ["--modality", "S1RTC", "--split", "train", "--batch-size", "3"],
    ["--modality", "S2RGB", "--split", "train", "--max-batches", "1", "--batch-size", "2"],
], ids=["S2L2A-harmonized", "S1RTC", "S2RGB-one-batch"])
def test_compute_stats_equals_the_jax_cli(tree, tmp_path, capsys, argv):
    """The Welford pass over the tree's shards: the JSON equals the JAX CLI's."""
    from eovax.cli.compute_stats import main as jax_main
    from eovax_torch.cli.compute_stats import main

    main(["--data-path", tree, *argv, "--output", str(tmp_path / "ours.json")])
    printed = json.loads(capsys.readouterr().out)
    jax_main(["--data-path", tree, *argv, "--output", str(tmp_path / "ref.json")])
    capsys.readouterr()
    ours, ref = (json.loads((tmp_path / f).read_text()) for f in ("ours.json", "ref.json"))
    assert ours == ref == printed
    assert ours["samples"] > 0 and len(ours[argv[1]]["mean"]) == {"S2L2A": 12, "S1RTC": 2,
                                                                   "S2RGB": 3}[argv[1]]


def test_compute_stats_without_data_exits(tmp_path):
    from eovax_torch.cli.compute_stats import main

    with pytest.raises(SystemExit, match="No data found"):
        main(["--data-path", str(tmp_path), "--modality", "S2L2A"])


@pytest.mark.parametrize("shard", ["val/S2L2A/majortom_shard_000001.tar",
                                   "train/S2RGB/ssl4eos12_shard_000794.tar"])
def test_inspect_terramesh_equals_the_jax_cli(tree, tmp_path, capsys, shard):
    """``inspect_shard`` and the CLI's JSON equal the JAX package's; with
    ``--histogram`` both accumulate the same counts and write a PNG."""
    from eovax.cli.inspect_terramesh import inspect_shard as jax_inspect
    from eovax.cli.inspect_terramesh import main as jax_main
    from eovax_torch.cli.inspect_terramesh import inspect_shard, main

    path = f"{tree}/{shard}"
    assert inspect_shard(path, 3) == jax_inspect(path, 3)
    pytest.importorskip("matplotlib")
    for fn, png in ((main, "ours.png"), (jax_main, "ref.png")):
        fn(["--shard", path, "--max-samples", "2", "--histogram", str(tmp_path / png)])
    ours, ref = capsys.readouterr().out.split("Histogram saved to")[:2]
    ours_json = ours[:ours.rindex("]") + 1]
    ref_json = ref[ref.index("["):ref.rindex("]") + 1]
    assert json.loads(ours_json) == json.loads(ref_json) and len(json.loads(ours_json)) == 2
    assert (tmp_path / "ours.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# SeasoNet
# ---------------------------------------------------------------------------


class _SeasoNet:
    """A stand-in for ``torchgeo.datasets.SeasoNet``: CHW samples from a seed."""

    def __init__(self, root, bands=None, n=5, hw=20):
        c = 3 if bands == ["10m_RGB"] else 12
        g = np.random.default_rng(len(root))
        self._images = [g.integers(0, 6000, (c, hw, hw)).astype(np.int16) for _ in range(n)]

    def __len__(self):
        return len(self._images)

    def __getitem__(self, i):
        return {"image": self._images[i], "mask": np.zeros((20, 20), np.int64)}


@pytest.fixture
def torchgeo(monkeypatch):
    datasets = types.ModuleType("torchgeo.datasets")
    datasets.SeasoNet = _SeasoNet
    monkeypatch.setitem(sys.modules, "torchgeo", types.ModuleType("torchgeo"))
    monkeypatch.setitem(sys.modules, "torchgeo.datasets", datasets)


def test_seasonet_constants_equal_the_jax_packages():
    import eovax.data.seasonet as jsn
    import eovax_torch.data.seasonet as sn

    for name in ("SEASONET_WVS", "SEASONET_MEANS", "SEASONET_STDS"):
        got, ref = getattr(sn, name), getattr(jsn, name)
        assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref), name
    for bands in (None, ["10m_RGB"]):
        for got, ref in zip(sn.seasonet_stats(bands), jsn.seasonet_stats(bands), strict=True):
            np.testing.assert_array_equal(got, ref)
    assert sn.seasonet_stats(["10m_RGB"])[0].shape == (3,)


@pytest.mark.parametrize("split,bands", [("train", None), ("val", ["10m_RGB"])])
def test_seasonet_batches_equal_the_jax_packages(torchgeo, split, bands):
    """On the stand-in dataset: /3000 scaling, the bilinear resize to ``size``,
    the per-sample flips of the train split from ``seed``, the wavelengths:
    the port's batches equal the JAX package's (1e-6; the resize sums in other
    orders)."""
    from eovax.data.seasonet import make_seasonet_datamodule as jax_make
    from eovax_torch.data.seasonet import SEASONET_WVS, make_seasonet_datamodule

    kw = dict(batch_size=2, size=16, split=split, seed=4, bands=bands)
    got, ref = list(make_seasonet_datamodule("root", **kw)()), list(jax_make("root", **kw)())
    assert len(got) == len(ref) == 2  # 5 samples: two whole batches
    for a, b in zip(got, ref):
        assert a["modality"] == b["modality"] == "SeasoNet"
        assert a["image"].shape == (2, 16, 16, 3 if bands else 12)
        assert isinstance(a["image"], np.ndarray) and a["image"].flags.c_contiguous
        np.testing.assert_allclose(a["image"], np.asarray(b["image"]), atol=1e-6)
        np.testing.assert_array_equal(a["wvs"], SEASONET_WVS[:3] if bands else SEASONET_WVS)


def test_seasonet_needs_torchgeo(monkeypatch):
    from eovax_torch.data.seasonet import make_seasonet_datamodule

    monkeypatch.setitem(sys.modules, "torchgeo", None)
    with pytest.raises(ImportError, match="needs torchgeo"):
        make_seasonet_datamodule("root")


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` writes ``trace.json`` with the host's operators in it (the
    card's kernels too where there is one)."""
    from eovax_torch.utils.profiling import trace

    with trace(str(tmp_path / "t")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert prof is not None
    with trace(str(tmp_path / "quiet"), host_tracer_level=1):
        torch.ones(3).sum()
    assert (tmp_path / "quiet" / "trace.json").stat().st_size > 0


@pytest.mark.filterwarnings("ignore:Error detected in SqrtBackward0")
def test_profiling_barrier_nan_checks_memory_and_stopwatch(capsys):
    from eovax_torch.utils.profiling import (
        device_barrier,
        enable_nan_checks,
        memory_stats,
        stopwatch,
    )

    assert device_barrier(torch.arange(3.0) + 2) == 2.0
    assert device_barrier(np.ones((2, 2))) == 1.0
    try:
        enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    if not torch.cuda.is_available():
        assert memory_stats() == {}
    with stopwatch("step") as box:
        pass
    assert box["seconds"] >= 0 and "[step]" in capsys.readouterr().out
