"""The plain reference: the same semantics as the served path, written
from the configuration alone in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
walks the fitted trees themselves (not the mapped tables), and replays the
register file from the packets the benchmark generated. ``Precision``
holds the one knob the control turns: the reference in bfloat16.
"""

from __future__ import annotations

import torch


class Precision:
    """Rounds a tensor to the reference's working precision: float32 as
    the configuration states it, or bfloat16 for the control."""

    def __init__(self, control: bool = False):
        self.control = control

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not self.control:
            return t
        return t.to(torch.bfloat16).to(t.dtype)


EXACT = Precision(False)
