"""Fixed-point quantization — the paper's "action data bits" knob (§7.7, Fig 9).

Table payloads on a switch are carried in metadata of a configured bit width.
We model this as symmetric fixed point: ``q = round(v * scale)`` stored in
``bits``-wide signed integers, with one shared scale per table so summation
across tables stays exact in the integer domain (what a switch ALU does).
(Port of ``repro/core/quantize.py``; the arithmetic is the same numpy.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import mean


@dataclasses.dataclass
class FixedPoint:
    q: torch.Tensor        # int32 payload (values fit in `bits` signed bits)
    scale: torch.Tensor    # scalar float32
    bits: int = 16

    def to(self, device, copy: bool = False) -> "FixedPoint":
        return FixedPoint(q=self.q.to(device, copy=copy),
                          scale=self.scale.to(device, copy=copy),
                          bits=self.bits)


def quantize_fixed(v, bits: int) -> FixedPoint:
    """Quantize array ``v`` to signed fixed point with ``bits`` total bits."""
    v = np.asarray(v, np.float32)
    max_abs = float(np.max(np.abs(v))) if v.size else 1.0
    max_abs = max(max_abs, 1e-12)
    qmax = float(2 ** (bits - 1) - 1)
    scale = qmax / max_abs
    # symmetric clip: the code -qmax-1 exists in two's complement but
    # dequantizes past max_abs, breaking the symmetric contract above
    q = np.clip(np.round(v * scale), -qmax, qmax).astype(np.int32)
    return FixedPoint(q=torch.from_numpy(q),
                      scale=torch.tensor(scale, dtype=torch.float32),
                      bits=bits)


def dequantize(fp: FixedPoint) -> torch.Tensor:
    return fp.q.to(torch.float32) / fp.scale


def relative_error(fp: FixedPoint, v) -> float:
    """Mean relative calc error of the quantized representation (Fig 9)."""
    d = dequantize(fp)
    v = torch.as_tensor(np.asarray(v, np.float32), device=d.device)
    denom = torch.clamp(torch.abs(v), min=1e-9)
    return float(mean(torch.abs(d - v) / denom))
