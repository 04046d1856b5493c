"""Masked register reset (the eviction sweep's scatter): CUDA kernel + wrapper.

Replaces the Pallas TPU kernel of ``repro/kernels/evict.py``:
``_evict_fill_kernel`` (:27), reached from ``evict_fill_pallas`` (:34) and
``ops.evict_fill``, which the aging sweeps (``netsim.stream.age_out`` and
``approx_lru_sweep``) call. The CUDA source is ``csrc/evict.cu``.

    out[r, n] = mask[n] ? fills[r] : regs[r, n]      regs (R, N), mask (N,)

The aging sweep recycles idle flow buckets by writing each register's init
identity back over the evicted columns. One thread per column reads the
mask once and writes the column's R registers; the ragged last block is
masked, so N needs no padding.

Bound: memory (regs and mask read once, out written once: ~532 KB at R=8,
N=8192, 0.16 us at 3.35 TB/s). PERF.md holds the measured time.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``evict_fill_ref``. A select, so the two agree bit for bit. ``LAUNCHES``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build

BLOCK = 256             # threads per CUDA block

LAUNCHES = {"evict_fill": 0}


def reset_launches() -> None:
    LAUNCHES["evict_fill"] = 0


def evict_fill_ref(regs, mask, fills) -> torch.Tensor:
    """Plain version: evicted columns take their fill, the rest pass."""
    return torch.where(mask[None, :], fills[:, None], regs)


def evict_fill(regs: torch.Tensor, mask: torch.Tensor,
               fills: torch.Tensor) -> torch.Tensor:
    """regs (R, N) f32, mask (N,) bool (True = evict), fills (R,) f32
    -> a new (R, N) tensor with the evicted columns reset.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and raises on operands it does not take."""
    if not on_kernel_path(regs):
        return evict_fill_ref(regs, mask, fills)
    for name, a, dtype in (("regs", regs, torch.float32),
                           ("mask", mask, torch.bool),
                           ("fills", fills, torch.float32)):
        if a.device != regs.device:
            raise ValueError(f"{name} is on {a.device}, regs on {regs.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (regs.dim() != 2 or mask.shape != (regs.shape[1],)
            or fills.shape != (regs.shape[0],)):
        raise ValueError(f"shapes do not match: regs {tuple(regs.shape)}, "
                         f"mask {tuple(mask.shape)}, fills "
                         f"{tuple(fills.shape)}")
    out = torch.empty_like(regs)
    if out.numel() == 0:
        return out
    _build.launch("evict", regs.device,
                  (regs.data_ptr(), mask.data_ptr(), fills.data_ptr(),
                   out.data_ptr()),
                  (regs.shape[0], regs.shape[1], BLOCK))
    LAUNCHES["evict_fill"] += 1
    return out
