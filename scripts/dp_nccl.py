"""Data parallel across the cards of one host: N NCCL ranks against one process.

On a host with N cards (one process each):

    python -m torch.distributed.run --nproc_per_node N scripts/dp_nccl.py

and its rehearsal on the CPU, 4 gloo processes on a tiny model:

    python -m torch.distributed.run --nproc_per_node 4 scripts/dp_nccl.py --tiny

The step and its comparison are ``chip_smoke.py``'s phase 13 (b) ones
(``dp_step``, ``tree_rel``, ``ranks_equal``), on N ranks instead of 2:

1. Before the group exists, every rank takes, alone on its card, one stage-2
   step of the full-width model on the whole [16,12,256,256] bf16 batch of
   phase 13 (b), with exact hand-kernel launches: the one-process reference.
   It also times ``Stage2Trainer`` at B=16 (``trainer_step_ms``).
2. The ranks join the group (NCCL on the cards, gloo on the CPU) and take
   the same step on their 16/N rows each, with exact launches a rank: the
   averaged, clipped gradients and the parameters against the reference
   (‖diff‖/‖ref‖ ≤ 1e-1, phase 13's bf16 limit), the ranks' parameters
   bit-identical.
3. Times under the group: ``Stage2Trainer`` at B=16 a rank (a global batch of
   16·N) beside the one-card step of 1, the weak-scaling efficiency
   t(1 card) / t(N cards); ``average_gradients`` of the step's 95.5M fp32
   gradients, the bare ``all_reduce`` of their 382 MB buffer, with the bus
   bandwidth 2·(N − 1)/N · bytes / time, and one ``all_reduce`` per gradient
   tensor; CUDA events on every rank, rank 0 printing the slowest rank's,
   beside the card's name and power limit.

The rehearsal takes phase 13's fp32 step (Charbonnier alone) of the tests'
tiny model on 16 rows of 32², and times nothing on a device.

Exits 1 when a check fails. The last line of standard output on rank 0 is a
JSON object of the readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from eovax_torch import EOFluxVAE  # noqa: E402
from eovax_torch.core import config as tcfg  # noqa: E402
from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION  # noqa: E402
from eovax_torch.data.synthetic import synthetic_terramesh_batches  # noqa: E402
from eovax_torch.losses import EOConsistencyLoss  # noqa: E402
from eovax_torch.parallel.mesh import (  # noqa: E402
    average_gradients,
    destroy_distributed,
    init_distributed,
)
from eovax_torch.train import stage2  # noqa: E402

GLOBAL_ROWS = cs.DP_SHAPES["bf16"][0]


def tiny_config(bands: int):
    stem = tcfg.StemConfig(num_layers=1, wv_planes=32, use_adain=True)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    cfg = tcfg.VAEConfig(encoder=tcfg.EncoderConfig(in_channels=bands, **kw),
                         decoder=tcfg.DecoderConfig(out_ch=bands, **kw))
    return dataclasses.replace(cfg, base_lr=1e-4, final_lr=None, clip_grad=1.0,
                               sample_posterior=False)


def trainer_ms(cfg, sd, batches, device) -> float:
    """``Stage2Trainer``'s ms/step at ``batches``' size (``cs.trainer_step_ms``);
    on the CPU the steps alone, untimed (nan)."""
    model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=device)
    on_card = device.type == "cuda"
    # Charbonnier alone on the CPU's 32² (MS-SSIM needs more than 64 pixels).
    loss = cs.train_loss() if on_card else EOConsistencyLoss(rec_loss_type="char")
    trainer = stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, log_every=0)
    if on_card:
        return cs.trainer_step_ms(trainer, stage2.TrainState(), batches)
    for batch in batches:
        trainer.train_on_batch(stage2.TrainState(), batch)
    return float("nan")


def ms(fn, iters: int, device) -> float:
    """Mean ms of ``fn()``: CUDA events on the card; the host's clock on the CPU
    (a rehearsal's number, no device time)."""
    if device.type == "cuda":
        return cs.cuda_ms(fn, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def slowest(value: float, device) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiny", action="store_true",
                        help="the tests' tiny model at 32² on the CPU, gloo (a rehearsal)")
    args = parser.parse_args()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if args.tiny:
        torch.set_num_threads(1)
        device, card = torch.device("cpu"), "cpu (rehearsal: no device time)"
        cfg, size, label = tiny_config(12), 32, "fp32"
        x = torch.randn(GLOBAL_ROWS, 12, size, size,
                        generator=torch.Generator().manual_seed(cs.DP_SEED))
    else:
        if not torch.cuda.is_available():
            print("dp_nccl: no CUDA card; --tiny rehearses on the CPU", file=sys.stderr)
            return 1
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        card = cs.card_line()
        cfg, size, label = cs.train_config(12), 256, "bf16"
        x = cs.dp_batch(label)
        FULL_PRECISION.activate()
    model = EOFluxVAE(cfg, policy=DEFAULT_POLICY, device=device, seed=0)
    sd = cs.bench_state_dict(model, seed=0)
    del model
    batches = list(synthetic_terramesh_batches(batch_size=GLOBAL_ROWS, target_size=(size, size),
                                               modalities=("S2L2A",), seed=0, num_batches=2))

    # 1. One process on the whole batch, before the group exists.
    ref = cs.dp_step(label, x, device, cfg)
    one_ms = trainer_ms(cfg, sd, batches, device)

    # 2. The same step on this rank's rows, in the group.
    created = init_distributed(device, backend="gloo" if args.tiny else "nccl")
    if not created or (dist.get_world_size(), dist.get_rank()) != (world, rank):
        raise RuntimeError(f"the group is not the launch's: world {world}, rank {rank}")
    readings, failed = {}, False
    try:
        b = GLOBAL_ROWS // world
        got = cs.dp_step(label, x[rank * b:(rank + 1) * b], device, cfg)
        grad_rel = cs.tree_rel(got["grads"], ref["grads"])
        param_rel = cs.tree_rel(got["params"], ref["params"])
        equal, tol = cs.ranks_equal(got["params"]), cs.DP_TOL[label]
        failed = not (equal and grad_rel <= tol and param_rel <= tol)
        readings.update(world=world, grad_rel=grad_rel, param_rel=param_rel, ranks_equal=equal,
                        loss=got["loss"], loss_one_process=ref["loss"], launches=got["launches"])
        if rank == 0:
            print(f"{world} ranks x {b} rows against one process on [{GLOBAL_ROWS},12,{size},"
                  f"{size}] {label}, one step: gradients (averaged, clipped) |diff|/|ref| "
                  f"{grad_rel:.3e}, parameters {param_rel:.3e} (tol {tol:g}); loss "
                  f"{got['loss']:.6f} (rank 0's rows) vs {ref['loss']:.6f}; ranks "
                  f"bit-identical {equal} {'FAIL' if failed else 'ok'} [{card}]")
        del got, ref

        # 3. Times under the group.
        dp_ms = slowest(trainer_ms(cfg, sd, batches, device), device)
        one_ms = slowest(one_ms, device)
        model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=device)
        grads = [torch.randn_like(p) for p in model.core.parameters()]
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        flat = torch.cat([g.reshape(-1) for g in grads])
        avg_ms = slowest(ms(lambda: average_gradients(grads), 10, device), device)
        bare_ms = slowest(ms(lambda: dist.all_reduce(flat), 10, device), device)
        per_tensor_ms = slowest(ms(lambda: [dist.all_reduce(g) for g in grads], 10, device),
                                device)
        bus_gbs = 2 * (world - 1) / world * nbytes / (bare_ms * 1e-3) / 1e9
        readings.update(trainer_ms=dp_ms, one_card_trainer_ms=one_ms,
                        weak_scaling=one_ms / dp_ms, average_gradients_ms=avg_ms,
                        all_reduce_ms=bare_ms, all_reduce_bytes=nbytes, bus_gb_per_s=bus_gbs,
                        per_tensor_all_reduce_ms=per_tensor_ms, tensors=len(grads))
        if rank == 0:
            print(f"time trainer step: {dp_ms:.3f} ms/step at B={GLOBAL_ROWS} a rank on {world} "
                  f"ranks ({world * GLOBAL_ROWS * 1e3 / dp_ms:.2f} imgs/s) against "
                  f"{one_ms:.3f} ms/step on one card alone ({GLOBAL_ROWS * 1e3 / one_ms:.2f} "
                  f"imgs/s): weak scaling {one_ms / dp_ms:.3f} (slowest rank) [{card}]")
            print(f"time gradient all-reduce over {world} ranks: average_gradients "
                  f"{avg_ms:.3f} ms, bare all_reduce of {nbytes / 1e6:.1f} MB {bare_ms:.3f} ms "
                  f"(bus {bus_gbs:.1f} GB/s), one all_reduce per tensor ({len(grads)} calls) "
                  f"{per_tensor_ms:.3f} ms (slowest rank) [{card}]")
            print(card)
            print(json.dumps(readings))
    finally:
        destroy_distributed(created)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
