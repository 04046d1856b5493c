"""Launch configuration of the fused lookup kernel, and the timing helpers
shared by autotuners.

Port of ``repro/kernels/tuning.py``. The reference's three tile knobs were
TPU grid and VMEM chunk sizes; on the card what remains is:

  tile_n   rows per CUDA block, for both selects and the loop kernel
           (each gives a row several threads: launch_plan)
  select   decision-select strategy: matmul | compare | auto
  impl     realization: fused (the CUDA kernel) | loop | ref (plain torch)

``edge_chunk``/``dtable_chunk`` have no counterpart: the kernels loop over
edges and read one decision entry per tree.

``autotune_tiles`` times a small candidate sweep on synthetic rows and
caches the winner per (artifact shape, card, batch). Two departures from
the reference: the plain version (``impl='ref'``) is no candidate, since
nothing on the card's main path may run it; and each candidate is timed by
device work (a few calls captured in one CUDA graph, replays timed with
CUDA events, the minimum taken) where the reference timed jitted calls with
the host's clock — an eager call here would time Python, not the kernel.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass(frozen=True)
class TileConfig:
    tile_n: int = 128        # rows per CUDA block
    select: str = "auto"     # decision-select strategy: matmul|compare|auto
    impl: str = "fused"      # fused (CUDA kernel) | loop | ref (plain torch)


DEFAULT_TILES = TileConfig()

_TILE_CACHE: dict = {}


def padded_rows(n: int, tile: int) -> int:
    """Rows a tile-granular kernel processes for an n-row batch."""
    return -(-n // tile) * tile


def shard_tiles(tiles: TileConfig, batch: int) -> TileConfig:
    """Clamp ``tile_n`` to a partitioned per-device batch.

    The sharded classify hands each device a slab of ceil(K*W/D) rows
    (``netsim.shard_stream.lane_slab_rows``). A block of more rows than the
    slab only leaves threads idle, so the fused realization's ``tile_n`` is
    cut to the smallest power of two that covers the slab (16 at least);
    'loop' and 'ref' pass through. The rows processed stay exactly the
    slab's on every route: the kernels mask their ragged last block, where
    the reference's TPU grid padded to an 8-row multiple.
    """
    if tiles.impl != "fused" or batch >= tiles.tile_n:
        return tiles
    return dataclasses.replace(
        tiles, tile_n=max(16, 1 << max(batch - 1, 0).bit_length()))


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


def clear_tile_cache() -> None:
    _TILE_CACHE.clear()


def _artifact_key(art) -> tuple:
    if art.ftable is not None:
        return ("tree", art.agg, tuple(art.ftable.shape),
                tuple(art.dtable_class.shape))
    return ("classical", art.agg, tuple(art.vtable.q.shape))


def _cache_key(art, batch: int) -> tuple:
    dev = art.device
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return _artifact_key(art), card, batch


def _time_config(art, x, tiles: TileConfig, reps: int,
                 calls: int = 10) -> float:
    """Seconds of device time per ``fused_classify`` call: ``calls`` calls
    captured in one CUDA graph (after one eager warm-up pass, which builds
    the kernel outside the capture), the minimum over ``reps`` timed
    replays. Raises on a device other than CUDA."""
    from repro_torch.kernels.ops import fused_classify   # ops imports us
    if x.device.type != "cuda":
        raise ValueError("tile configurations are timed on a CUDA device")

    def run():
        for _ in range(calls):
            fused_classify(art, x, tiles=tiles, device=x.device)

    main = torch.cuda.current_stream(x.device)
    side = torch.cuda.Stream(x.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        run()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()                                  # first replay: uploads
    best = float("inf")
    for _ in range(max(reps, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(main)
        graph.replay()
        end.record(main)
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / calls)
    return best


def candidate_tiles(batch: int) -> list:
    """Small sweep: block size x select strategy of the fused kernel, plus
    the per-feature-loop kernel (B7), which wins on shapes where the fused
    kernel loses. No plain-version candidate (see the module docstring)."""
    cands = [TileConfig(tile_n=tile_n, select=select)
             for tile_n in (128, 512) if tile_n <= batch
             for select in ("matmul", "compare")]
    if not cands:       # batch below every block size: still time the default
        cands.append(DEFAULT_TILES)
    cands.append(TileConfig(impl="loop"))   # skipped for classical artifacts
    return cands


def autotune_tiles(art, *, batch: int = 2048, reps: int = 2, candidates=None,
                   seed: int = 0, verbose: bool = False) -> TileConfig:
    """Pick the fastest TileConfig for this artifact shape on this card.

    Cached per (artifact shape, card name, batch); the sweep runs on
    synthetic rows drawn from a ``torch.Generator`` seeded by ``seed``,
    uniform around the edge range so the compares see realistic bins. The
    default is always timed, so the winner never loses to it on the tuned
    shape. ``art`` must be on a CUDA device (every candidate is timed there;
    see ``sweep_timings`` for what the sweep measured).
    """
    key = _cache_key(art, batch)
    hit = _TILE_CACHE.get(key)
    if hit is not None:
        return hit[0]
    edges = torch.where(torch.isfinite(art.edges), art.edges, 0.0)
    lo, hi = float(edges.min()), float(edges.max())
    span = max(hi - lo, 1.0)
    a, b = lo - 0.1 * span, hi + 0.1 * span
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((batch, art.n_features), generator=gen)
    x = (a + (b - a) * x).to(art.device)
    best, timings = sweep_best(candidates or candidate_tiles(batch),
                               lambda tiles: _time_config(art, x, tiles, reps),
                               default=DEFAULT_TILES, verbose=verbose,
                               label="autotune")
    _TILE_CACHE[key] = (best, timings)
    return best


def sweep_timings(art, *, batch: int = 2048):
    """{TileConfig: seconds per call} that the cached sweep for this artifact
    shape, card and batch measured, or None when it has not run. A
    candidate that raised is missing from it."""
    hit = _TILE_CACHE.get(_cache_key(art, batch))
    return None if hit is None else dict(hit[1])
