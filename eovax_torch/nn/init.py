"""Parameter initialization from an explicit ``torch.Generator``.

:func:`init_parameters` gives every Conv2d and Linear a LeCun-normal weight
and a zero bias and every GroupNorm and LayerNorm unit scale and zero shift,
as the JAX package's flax defaults do. Modules whose reference init differs
(the hypernetwork generators, the AdaIN projection) define
``init_special(generator)``, which runs after the generic pass.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if hasattr(m, "init_special"):
            m.init_special(generator)
