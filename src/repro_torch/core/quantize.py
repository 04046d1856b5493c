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


# ---------------------------------------------------------------------------
# fp8 block scaling (the served weights of DeepSeek-V3: e4m3 codes, one
# float32 scale a block x block tile of the (out, in) weight, tech report
# §3.3)
# ---------------------------------------------------------------------------

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0                     # e4m3fn's largest finite value


def _block_view(w: torch.Tensor, block: int):
    """w (..., N, K) zero-padded to whole blocks and viewed as (..., N/b, b,
    K/b, b)."""
    n, k = w.shape[-2:]
    pn, pk = -n % block, -k % block
    if pn or pk:
        w = torch.nn.functional.pad(w, (0, pk, 0, pn))
    lead = w.shape[:-2]
    return w.reshape(*lead, (n + pn) // block, block, (k + pk) // block,
                     block)


def quantize_blocks(w: torch.Tensor, block: int):
    """w (..., N, K) float32 -> (codes (..., N, K) e4m3, scales (...,
    ceil(N/b), ceil(K/b)) float32): each block's scale is its largest
    magnitude over 448 (1 for a block of zeros), its codes w / scale
    rounded to e4m3."""
    n, k = w.shape[-2:]
    v = _block_view(w.to(torch.float32), block)
    amax = v.abs().amax(dim=(-3, -1))
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (v / scale[..., :, None, :, None]).to(FP8)
    q = q.reshape(*q.shape[:-4], q.shape[-4] * block, q.shape[-2] * block)
    return q[..., :n, :k].contiguous(), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, block: int,
                      dtype=torch.float32) -> torch.Tensor:
    """codes (..., N, K) e4m3 and their block scales -> (..., N, K) in
    ``dtype``: each code times its block's scale, in float32 (exact: an
    e4m3 code has 4 significant bits), then rounded once to ``dtype``."""
    n, k = q.shape[-2:]
    s = scale.repeat_interleave(block, dim=-2)[..., :n, :]
    s = s.repeat_interleave(block, dim=-1)[..., :k]
    return (q.to(torch.float32) * s).to(dtype)
