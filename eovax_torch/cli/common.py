"""Shared CLI plumbing: experiment directories and config snapshots.

A copy of ``eovax/cli/common.py`` without ``enable_compile_cache``: the port
compiles nothing at run time but its kernels, which ``nvcc`` builds once
into ``build/eovax_torch``.
"""

from __future__ import annotations

import os
import shutil
import time


def create_experiment_dir(base_dir: str, experiment_name: str) -> str:
    """Timestamped experiment directory."""
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(base_dir, f"{experiment_name}_{stamp}")
    os.makedirs(path, exist_ok=True)
    return path


def snapshot_config(config_path: str, exp_dir: str) -> None:
    """Copy the run config into the experiment directory."""
    shutil.copy(config_path, os.path.join(exp_dir, "config.yaml"))
