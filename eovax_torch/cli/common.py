"""Shared CLI plumbing: experiment directories, config snapshots and the
process group of a data-parallel launch.

A copy of ``eovax/cli/common.py`` without ``enable_compile_cache``: the port
compiles nothing at run time but its kernels, which ``nvcc`` builds once
into ``build/eovax_torch``.
"""

from __future__ import annotations

import os
import shutil
import time


def create_experiment_dir(base_dir: str, experiment_name: str) -> str:
    """Timestamped experiment directory: rank 0's, on every rank of a
    process group."""
    from eovax_torch.core.device import process_index
    from eovax_torch.parallel.mesh import broadcast_object

    path = None
    if process_index() == 0:
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(base_dir, f"{experiment_name}_{stamp}")
        os.makedirs(path, exist_ok=True)
    return broadcast_object(path)


def snapshot_config(config_path: str, exp_dir: str) -> None:
    """Copy the run config into the experiment directory."""
    shutil.copy(config_path, os.path.join(exp_dir, "config.yaml"))


def add_distributed_args(parser) -> None:
    """``--dist-url``: the process group's ``init_method``."""
    parser.add_argument(
        "--dist-url", default=None,
        help="init_method of the process group (e.g. file:///path/store) with WORLD_SIZE and "
             "RANK in the environment; without it a torchrun launch (WORLD_SIZE > 1) uses env://")


def start_distributed(args) -> bool:
    """Initialise the process group of the launch on ``args.device`` (NCCL for
    CUDA, gloo for the CPU); a no-op for one process. Returns whether it did."""
    from eovax_torch.parallel.mesh import init_distributed

    kwargs = {}
    if args.dist_url:
        kwargs = dict(init_method=args.dist_url, world_size=int(os.environ.get("WORLD_SIZE", 1)),
                      rank=int(os.environ.get("RANK", 0)))
    return init_distributed(args.device, **kwargs)
