"""Launch configuration of the fused lookup kernel, and the timing helpers
shared by autotuners.

Port of ``repro/kernels/tuning.py``. The reference's three tile knobs were
TPU grid and VMEM chunk sizes; on the card the kernel gives one thread to
one row, so what remains is:

  tile_n   rows per CUDA block (the block size)
  select   decision-select strategy: matmul | compare | auto
  impl     realization: fused (the CUDA kernel) | loop | ref (plain torch)

``edge_chunk``/``dtable_chunk`` have no counterpart: the kernel loops over
edges and reads one decision entry per tree. ``autotune_tiles`` and
``candidate_tiles`` wait for a later slice; ``measure_min`` and
``sweep_best`` are plain Python and are here already.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class TileConfig:
    tile_n: int = 128        # rows per CUDA block
    select: str = "auto"     # decision-select strategy: matmul|compare|auto
    impl: str = "fused"      # fused (CUDA kernel) | loop | ref (plain torch)


DEFAULT_TILES = TileConfig()


def padded_rows(n: int, tile: int) -> int:
    """Rows a tile-granular kernel processes for an n-row batch."""
    return -(-n // tile) * tile


def measure_min(fn, reps: int, warmup: int = 1) -> float:
    """min-over-reps wall time of ``fn()`` (which must block until the
    work is done: on the card, end it with ``torch.cuda.synchronize()``).
    Warmup runs absorb first-use cost (kernel builds, allocator growth);
    the minimum is robust to host load spikes."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_best(candidates, time_one, *, default, verbose: bool = False,
               label: str = "autotune") -> tuple:
    """Time each candidate, return (best, timings dict).

    ``default`` is ALWAYS timed (appended when missing from
    ``candidates``) and the winner is the measured argmin over a set
    containing it — so the sweep can never select a config that regresses
    versus the default on the tuned shape. A candidate whose ``time_one``
    raises is skipped (unsupported config); if every candidate fails the
    default wins untimed.
    """
    cands = list(candidates)
    if default not in cands:
        cands.append(default)
    timings, best, best_dt = {}, default, float("inf")
    for cand in cands:
        try:
            dt = time_one(cand)
        except Exception:  # noqa: BLE001 — candidate probing: any raise
            #                (build error, launch refusal, shape mismatch)
            #                just means "config unsupported", and the
            #                default wins
            continue
        timings[cand] = dt
        if verbose:
            print(f"{label} {cand} -> {dt * 1e3:.3f} ms")
        if dt < best_dt:
            best, best_dt = cand, dt
    return best, timings
