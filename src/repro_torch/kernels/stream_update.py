"""Streaming register scatter + clamp + touched-row gather: CUDA kernel + wrappers.

Replaces the Pallas TPU kernel of ``repro/kernels/stream_update.py``:
``_stream_update_kernel`` (:61), reached from ``stream_update_pallas``
(:110) and ``ops.stream_update``. The CUDA source is
``csrc/stream_update.cu``.

The serving step's register half folds one packet window into the stacked
(8, N) register file (six count registers by scatter-add, first/last
timestamp by scatter-min/max), clamps the count registers at the 2^24 f32
exactness envelope, and gathers each lane's updated register row (8, W)
for the classify stage. The TPU realized the scatter as a one-hot MXU
contraction over bucket tiles, with a rows block carried across a grid that
runs in order. The card keeps the tiles and drops the carry: one launch, a
block per tile of bucket columns (``tile_columns``), which scans the whole
window, lists the lanes of its tile in shared memory and folds each
column's lanes in registers, settles and clamps its own columns, and writes
the rows of the lanes whose gather column it owns.

``stream_update_features`` is the kernel's second output mode (a template
flag of the same kernel, the serving step's route): each lane's feature row
(``netsim.features.table_from_registers``' columns) in place of its raw
register row, written into a caller's (W, 8) slice, and the count of
register slots the clamp newly saturated, added into a caller's int32 word
(one atomic a block). The serving step's register half is then this launch
and the aging sweep, a window.

Bound: memory. In place, the function reads the six count rows whole (the
clamp sees every column), t_min/t_max at the columns the window names and
the window, and writes the register words that change and the rows.
``chip_smoke.py`` counts these bytes from its own inputs; PERF.md holds the
bound and the measured time.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``stream_update_ref``, the plain version. The kernel updates ``regs`` IN
PLACE and returns it: the streaming server owns its register file and
reads the state only through the returned tensor. The plain version
returns new tensors. Every count is an integer-valued f32 below 2^24 (or
clamped there), so the two agree bit for bit in any atomic order.
``stream_update_features`` takes CUDA tensors only: its plain version is
``netsim.stream``'s composition of ``stream_update_ref``, the readout and
the count, which the register half runs for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.ref import stream_update_ref

MIN_TILE, MAX_TILE = 32, 256   # bucket columns a block owns (csrc: kBlock)

N_REGISTERS = 8

LAUNCHES = {"stream_update": 0}


def reset_launches() -> None:
    LAUNCHES["stream_update"] = 0


def tile_columns(n: int, sms: int) -> int:
    """Bucket columns a block owns: N over twice the SM count (two blocks
    an SM, so a column's lanes are summed by more threads) rounded up to a
    power of two, kept within [MIN_TILE, MAX_TILE]. The last block's tile
    may be short."""
    tile = 1 << (-(-n // max(2 * sms, 1)) - 1).bit_length()
    return max(MIN_TILE, min(MAX_TILE, tile))


def check_window(regs, bucket, ts, length, is_fwd, valid) -> None:
    """Raise unless the operands are what the kernel takes: regs (8, N)
    f32; bucket (W,) int32; ts, length, is_fwd (W,) f32; valid (W,) bool;
    all contiguous and on regs' device."""
    if regs.dim() != 2 or regs.shape[0] != N_REGISTERS or regs.shape[1] == 0:
        raise ValueError(f"regs must be ({N_REGISTERS}, N>0), got "
                         f"{tuple(regs.shape)}")
    w = bucket.shape[0] if bucket.dim() == 1 else -1
    for name, a, dtype in (("regs", regs, torch.float32),
                           ("bucket", bucket, torch.int32),
                           ("ts", ts, torch.float32),
                           ("length", length, torch.float32),
                           ("is_fwd", is_fwd, torch.float32),
                           ("valid", valid, torch.bool)):
        if a.device != regs.device:
            raise ValueError(f"{name} is on {a.device}, regs on {regs.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "regs" and (a.dim() != 1 or a.shape[0] != w):
            raise ValueError(f"window columns must all be (W,); {name} is "
                             f"{tuple(a.shape)}")


def _launch(regs, bucket, ts, length, is_fwd, valid, rows, n_over, limit,
            features: bool) -> None:
    n, w = regs.shape[1], bucket.shape[0]
    _build.launch("stream_update", regs.device,
                  (regs.data_ptr(), bucket.data_ptr(), ts.data_ptr(),
                   length.data_ptr(), is_fwd.data_ptr(), valid.data_ptr(),
                   rows.data_ptr(), None if n_over is None
                   else n_over.data_ptr()),
                  (n, w, int(limit is not None),
                   _build.float_bits(0.0 if limit is None else limit),
                   tile_columns(n, _build.sm_count(regs.device)),
                   int(features)))
    LAUNCHES["stream_update"] += 1


def stream_update(regs, bucket, ts, length, is_fwd, valid, *, limit=None):
    """regs (8, N) f32, window columns (W,) -> (new_regs (8, N), rows (8, W)).

    ``limit`` clamps the count registers (None skips the clamp). A CPU
    tensor takes the plain version (new tensors); a CUDA tensor launches
    the kernel, which updates ``regs`` in place and returns it as
    new_regs, and raises on operands it does not take."""
    if not on_kernel_path(regs):
        return stream_update_ref(regs, bucket, ts, length, is_fwd, valid,
                                 limit=limit)
    check_window(regs, bucket, ts, length, is_fwd, valid)
    rows = torch.empty((N_REGISTERS, bucket.shape[0]), dtype=torch.float32,
                       device=regs.device)
    _launch(regs, bucket, ts, length, is_fwd, valid, rows, None, limit,
            False)
    return regs, rows


def stream_update_features(regs, bucket, ts, length, is_fwd, valid, out, *,
                           limit=None, n_over=None) -> torch.Tensor:
    """B5's feature-row mode: regs (8, N) f32 and the (W,) window columns
    as ``stream_update`` takes them; out (W, 8) f32, contiguous and 16-byte
    aligned; n_over None or an int32 scalar -> regs, updated in place.

    One launch folds the window into ``regs`` (the clamp at ``limit`` when
    given), writes each lane's feature row into ``out`` (the derivation of
    ``table_from_registers`` on the lane's updated registers, bit for bit)
    and, with ``n_over``, adds the count register slots that reached the
    limit in this window and were below it before (``saturate_counts(prev=)``'s
    count) into ``n_over``. CUDA tensors only; raises on operands it does
    not take."""
    if not on_kernel_path(regs):
        raise ValueError("stream_update_features launches the kernel and "
                         "takes CUDA tensors; a CPU register file takes the "
                         "plain composition in netsim.stream")
    check_window(regs, bucket, ts, length, is_fwd, valid)
    if (out.dtype != torch.float32 or out.device != regs.device
            or out.shape != (bucket.shape[0], N_REGISTERS)
            or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned "
                         f"({bucket.shape[0]}, {N_REGISTERS}) f32 tensor on "
                         f"{regs.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    if n_over is not None:
        if limit is None:
            raise ValueError("n_over counts the clamp's saturations: give "
                             "limit")
        if (n_over.dtype != torch.int32 or n_over.dim() != 0
                or n_over.device != regs.device):
            raise ValueError(f"n_over must be an int32 scalar on "
                             f"{regs.device}, got {n_over.dtype} "
                             f"{tuple(n_over.shape)} on {n_over.device}")
    _launch(regs, bucket, ts, length, is_fwd, valid, out, n_over, limit,
            True)
    return regs
