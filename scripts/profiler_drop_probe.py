"""Why ``torch.profiler`` drops the kernel records of short traces, on one CUDA card.

``chip_smoke.py`` reads kernel rows from ``torch.profiler`` traces of a few
short calls, and such traces have come back with part of their records or
none. The profiler keeps a device record only where it lies inside the
trace's window on the host's clock, so a kernel time that reads earlier (or
later) than the host's drops the records near the window's edges first, and
all of a short trace's once the error exceeds the trace's length.

Every ``--every`` seconds for ``--seconds`` seconds (large matrix products
keep the card busy in between) this script takes four traces of 20 calls of
the hand GroupNorm forward's warp plan ([8,64,16,16] bf16 with a [B, C] FiLM,
rows named ``gn_fwd_*``, ~3 µs each):

- ``device``: the device only, as ``chip_smoke.py`` took them;
- ``device+pads``: the same, with ``--pad`` ms of sleep after the trace
  starts and again after the synchronisation, before it stops, as
  ``chip_smoke.py`` takes them;
- ``host+device`` and ``host+device+pads``: the host's calls traced as well,
  so that each lost record is named by its call (0 the first), and each kept
  kernel's start is offset from the start of the host call that launched it
  (matched by correlation id). The first call follows a synchronisation, so
  its offset is the launch latency, a few µs, where both clocks agree; a
  negative offset is a kernel time that reads before its launch.

Prints one line per sample: seconds since the start, the records each trace
kept of 20 (and which calls lost theirs), and the least and the median offset
of the unpadded host+device trace in µs; then the records each way lost in
all, with the card's name and power limit.

    python3 scripts/profiler_drop_probe.py [--seconds 200] [--every 3] [--pad 50]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CALLS = 20
TAG = "gn_fwd_"


def take(fn, way: str, pad_s: float):
    """Records of ``TAG`` kept of CALLS, the calls whose records were lost (by their
    order, 0 the first; where the host is traced), and the kept kernels' start
    offsets from their launches in µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host = way.startswith("host+device")
    pad = way.endswith("+pads")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
                 ) as prof:
        if pad:
            time.sleep(pad_s)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad_s)
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id(): e for e in events if TAG in e.name()}
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.name().startswith("cudaLaunch"))
    lost = [i for i, (_, cid) in enumerate(launches) if cid not in kernels]
    offsets = [(kernels[cid].start_ns() - t) / 1e3 for t, cid in launches if cid in kernels]
    return len(kernels), lost, offsets


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_drop_probe: needs a CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--seconds", type=float, default=200.0)
    parser.add_argument("--every", type=float, default=3.0)
    parser.add_argument("--pad", type=float, default=50.0, help="ms")
    args = parser.parse_args()
    from eovax_torch.kernels.groupnorm import group_norm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, c = 8, 64
    x = torch.randn(b, c, 16, 16, generator=g, device=dev).bfloat16()
    w, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    scale, shift = torch.ones(b, c, device=dev), torch.zeros(b, c, device=dev)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)

    def fn():
        group_norm(x, w, bias, ada_scale=scale, ada_shift=shift, swish=True)

    ways = ("device", "device+pads", "host+device", "host+device+pads")
    t_start = time.perf_counter()
    lost = dict.fromkeys(ways, 0)
    samples = 0
    with torch.inference_mode():
        fn()
        while time.perf_counter() - t_start < args.seconds:
            parts = []
            for way in ways:
                kept, which, offsets = take(fn, way, args.pad / 1e3)
                lost[way] += CALLS - kept
                span = f" (calls {which[0]}-{which[-1]} lost)" if which else ""
                parts.append(f"{way} {kept}{span}")
                if way == "host+device" and offsets:
                    parts.append(f"offset min {min(offsets):.1f} median "
                                 f"{statistics.median(offsets):.1f} µs")
            samples += 1
            print(f"{time.perf_counter() - t_start:7.1f} s: kept of {CALLS}: "
                  + ", ".join(parts), flush=True)
            t_next = time.perf_counter() + args.every
            while time.perf_counter() < t_next:
                a = (a @ a) * (1.0 / 8192)
                torch.cuda.synchronize()
    print(f"records lost over {samples} samples of {CALLS}: {lost} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
