"""Masked register reset and the timeout sweep: CUDA kernels + wrappers.

Replaces the Pallas TPU kernel of ``repro/kernels/evict.py``:
``_evict_fill_kernel`` (:27), reached from ``evict_fill_pallas`` (:34) and
``ops.evict_fill``, which the aging sweeps (``netsim.stream.age_out`` and
``approx_lru_sweep``) call. The CUDA source is ``csrc/evict.cu``, with two
entries of one kernel template:

* ``evict_fill`` (out of place), the TPU kernel's counterpart:

      out[r, n] = mask[n] ? fills[r] : regs[r, n]      regs (R, N), mask (N,)

* ``timeout_sweep`` (in place on a CUDA tensor), the whole timeout sweep of
  one window: the cutoff (``evict_cutoff``), the mask from rows 0 and 3,
  the fill of the evicted columns and their count, in one launch. Under
  ``jax.jit`` the reference got those folded into one program by XLA; on
  this card each was a launch of its own (14 a step with eviction). Its
  plain version, ``timeout_sweep_ref``, is that composition.

The aging sweep recycles idle flow buckets by writing each register's init
identity back over the evicted columns. A thread owns four consecutive
columns (16-byte row accesses where the rows allow), and the grid is sized
for the card's SMs (``fill_plan``, ``sweep_plan``).

Bound: memory. ``evict_fill`` reads regs and the mask once and writes out
once (~532 KB at R=8, N=8192: 0.16 us at 3.35 TB/s); ``timeout_sweep``
reads rows 0 and 3 and the window and writes the evicted columns (~70 KB at
N=8192, W=1024). Both sit at a launch's floor. PERF.md holds the measured
times.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version. Selects and compares, so the two agree bit for bit.
``LAUNCHES["evict_fill"]`` counts the launches of either entry and nothing
else.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build

N_REGS = 8              # EV_R in the CUDA source: the register file's rows
COLS = 4                # EV_COLS: consecutive columns a thread owns
SWEEP_THREADS = 256     # threads of a sweep block (each reduces the window)

LAUNCHES = {"evict_fill": 0}


def reset_launches() -> None:
    LAUNCHES["evict_fill"] = 0


def fill_plan(n: int, sms: int) -> dict:
    """``evict_fill``'s grid: N/4 column quads over blocks of 64-256
    threads (a power of two), as many blocks as the SMs where there are
    enough quads, at most 8 an SM (the rest by a grid-stride loop)."""
    quads = -(-n // COLS)
    threads = min(256, max(64, 1 << (max(-(-quads // sms), 1) - 1)
                           .bit_length()))
    return {"threads": threads,
            "blocks": max(1, min(-(-quads // threads), 8 * sms))}


def sweep_plan(n: int, sms: int) -> dict:
    """``timeout_sweep``'s grid: blocks of ``SWEEP_THREADS`` (every block
    reduces the window itself; one quad a thread at the served N=8192, 8
    blocks, which beat 4 of 512 threads, 16 of 128 and one block without
    the ticket on the card), at most two an SM (the rest by a grid-stride
    loop), so a wide table does not reread the window from each of
    thousands of blocks."""
    quads = -(-n // COLS)
    return {"threads": SWEEP_THREADS,
            "blocks": max(1, min(-(-quads // SWEEP_THREADS), 2 * sms))}


def evict_fill_ref(regs, mask, fills) -> torch.Tensor:
    """Plain version: evicted columns take their fill, the rest pass."""
    return torch.where(mask[None, :], fills[:, None], regs)


def evict_cutoff(ts, valid, evict_age: float):
    """Aging cutoff for one window: ``min(now - evict_age, window_min)``,
    no later than every timestamp in the window, so a flow seen in this
    window always survives it. A NaN timestamp on a valid lane gives a NaN
    cutoff (nothing is evicted), a window with no valid lane -inf."""
    now = torch.where(valid, ts, -float("inf")).max()
    w_min = torch.where(valid, ts, float("inf")).min()
    return torch.minimum(now - float(np.float32(evict_age)), w_min)


def timeout_sweep_ref(regs, ts, valid, evict_age: float, fills) -> tuple:
    """Plain version of the timeout sweep: ``evict_cutoff``, the mask of
    occupied columns last seen before it, ``evict_fill_ref`` and the count.
    -> (new (R, N) regs, n_evicted i32); ``regs`` is left as it was."""
    cutoff = evict_cutoff(ts, valid, evict_age)
    mask = (regs[0] > 0) & (regs[3] < cutoff)
    return evict_fill_ref(regs, mask, fills), mask.sum(dtype=torch.int32)


def _check(regs, fills, *operands) -> None:
    """Raise unless every operand is on regs' device, of its dtype and
    contiguous, regs is (N_REGS, N) and fills (N_REGS,)."""
    for name, a, dtype in (("regs", regs, torch.float32),
                           ("fills", fills, torch.float32)) + operands:
        if a.device != regs.device:
            raise ValueError(f"{name} is on {a.device}, regs on {regs.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if regs.dim() != 2 or regs.shape[0] != N_REGS \
            or fills.shape != (N_REGS,):
        raise ValueError(f"the kernel takes an ({N_REGS}, N) register file "
                         f"and ({N_REGS},) fills, got regs "
                         f"{tuple(regs.shape)}, fills {tuple(fills.shape)}")


def evict_fill(regs: torch.Tensor, mask: torch.Tensor,
               fills: torch.Tensor) -> torch.Tensor:
    """regs (R, N) f32, mask (N,) bool (True = evict), fills (R,) f32
    -> a new (R, N) tensor with the evicted columns reset.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (R = 8) and raises on operands it does not take."""
    if not on_kernel_path(regs):
        return evict_fill_ref(regs, mask, fills)
    _check(regs, fills, ("mask", mask, torch.bool))
    if mask.shape != (regs.shape[1],):
        raise ValueError(f"shapes do not match: regs {tuple(regs.shape)}, "
                         f"mask {tuple(mask.shape)}")
    out = torch.empty_like(regs)
    n = regs.shape[1]
    if n == 0:
        return out
    plan = fill_plan(n, _build.sm_count(regs.device))
    _build.launch("evict", regs.device,
                  (regs.data_ptr(), mask.data_ptr(), fills.data_ptr(),
                   out.data_ptr()),
                  (N_REGS, n, plan["threads"], plan["blocks"]))
    LAUNCHES["evict_fill"] += 1
    return out


def timeout_sweep(regs: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor,
                  evict_age: float, fills: torch.Tensor, *,
                  out: torch.Tensor = None) -> tuple:
    """The timeout sweep of one window over the register file.

    regs (8, N) f32; ts (W,) f32 and valid (W,) bool, the window's columns;
    evict_age seconds; fills (8,) f32 -> (regs, n_evicted i32 scalar): the
    columns with pkt_count > 0 and t_max < ``evict_cutoff(ts, valid,
    evict_age)`` reset to their fills. A CUDA tensor launches the kernel,
    which updates ``regs`` in place and returns it (keep only the returned
    tensor), and raises on operands it does not take; a CPU tensor runs
    ``timeout_sweep_ref`` (new tensors). ``out``, an int32 scalar on regs'
    device (a view into a caller's counters), receives n_evicted, and is
    returned in its place."""
    if out is not None and (out.dtype != torch.int32 or out.dim() != 0
                            or out.device != regs.device):
        raise ValueError(f"out must be an int32 scalar on {regs.device}, "
                         f"got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if not on_kernel_path(regs):
        regs, n_ev = timeout_sweep_ref(regs, ts, valid, evict_age, fills)
        return regs, n_ev if out is None else out.copy_(n_ev)
    _check(regs, fills, ("ts", ts, torch.float32),
           ("valid", valid, torch.bool))
    n, w = regs.shape[1], ts.shape[0]
    if ts.dim() != 1 or valid.shape != ts.shape or n == 0 or w == 0:
        raise ValueError(f"the sweep takes a non-empty register file and "
                         f"window, got regs {tuple(regs.shape)}, ts "
                         f"{tuple(ts.shape)}, valid {tuple(valid.shape)}")
    n_out = (torch.empty((), dtype=torch.int32, device=regs.device)
             if out is None else out)
    plan = sweep_plan(n, _build.sm_count(regs.device))
    _build.launch("evict", regs.device,
                  (regs.data_ptr(), ts.data_ptr(), valid.data_ptr(),
                   fills.data_ptr(), n_out.data_ptr()),
                  (N_REGS, n, w, _build.float_bits(evict_age),
                   plan["threads"], plan["blocks"]), entry="sweep")
    LAUNCHES["evict_fill"] += 1
    return regs, n_out
