"""Learning-rate schedules.

Port of ``eovax/train/schedule.py``: the reference's
``get_cosine_schedule_with_warmup``, with no clamp past ``total_steps`` (the
cosine goes on, as in the reference's LambdaLR); and optax's
``cosine_decay_schedule``, which stage-1 distillation uses. Both compute in
Python floats (float64), as the reference's ``LambdaLR`` does.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_schedule(base_lr: float, final_lr: float, warmup_steps: int, total_steps: int,
                           num_cycles: float = 0.5) -> Callable[[int], float]:
    """Linear warmup, then cosine decay from ``base_lr`` to ``final_lr``; step t from 0."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return step / max(1, warmup_steps) * base_lr
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        cosine_decay = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return (base_lr - final_lr) * cosine_decay + final_lr

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: a half cosine from ``init_value`` to
    ``alpha·init_value`` over ``decay_steps``, then flat; step t from 0."""

    def schedule(step: int) -> float:
        progress = min(float(step), decay_steps) / decay_steps
        cosine_decay = 0.5 * (1.0 + math.cos(math.pi * progress))
        return init_value * ((1.0 - alpha) * cosine_decay + alpha)

    return schedule


#: The reference hard-codes the steps per epoch when it turns epoch-based
#: settings into steps (stage 2 and stage-3 SR).
STAGE2_STEPS_PER_EPOCH = 2000
SR_STEPS_PER_EPOCH = 152
