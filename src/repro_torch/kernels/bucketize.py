"""Standalone range match ("bucketize"): CUDA kernel + wrapper.

Replaces the Pallas TPU kernel of ``repro/kernels/bucketize.py``:
``_bucketize_kernel`` (:32), reached from ``bucketize_pallas`` (:45) and
``ops.bucketize``. The CUDA source is ``csrc/bucketize.cu``.

    out[n, f] = #{u : x[n, f] > edges[f, u]}      x (N, F) f32, edges (F, U) f32

as int32, edges padded with +inf (never matched): a count on any edge row,
sorted or not. A table of more than ``NARROW_F`` features (the finance
fit's F=130): a block stages the whole (F, U) table in shared memory once,
checking each edge against the next as it lands, then walks tiles of x in
row-major order, 4 consecutive elements a thread (one 16-byte load and
store where x and out are 16-byte aligned). On sorted rows (the fits'
quantile edges) the count is the number of edges below the element, by a
branch-free binary lifting; with a row out of order anywhere, each row is
marked sorted or not, and on an unsorted row whole groups of 8 edges count
from their (min, max) summaries, the one group an element falls inside
(or, on a row out of order, the whole row) edge by edge. A narrow table
(the tree fits' F=5) keeps the per-feature design it had: a block per
feature and 128 rows, each warp staging the row and its summaries itself.
``launch_plan`` picks the route and sizes the grid; a table past the
shared-memory budget (227 KB) takes the serial walk of
``csrc/range_match.cuh`` (the lookup kernels' range match) instead. The
ragged last tile is masked, so N needs no padding.

Bound: memory (x, edges and out once: 16.7 MB at the finance fit's
N=16000, F=130, U=63, 4.98 us on 3.35 TB/s). PERF.md holds the measured
time.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``bucketize_ref``, the plain version. The counts are integers, so the two
agree bit for bit. ``LAUNCHES`` counts kernel launches and nothing else.
The tree trainers bin their data through ``bucketize`` (``ml/trees.bin_data``),
so training on the card runs this kernel.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.ensemble_lookup import check_operands
from repro_torch.kernels.ref import bucketize_ref

THREADS = 512           # threads of a staged block at most
MIN_THREADS = 128       # ... and at least
SMEM_BUDGET = 232448    # a block's most shared memory on sm_90 (227 KB)
GLOBAL_BLOCK = 256      # threads of a serial-walk block (csrc: kGlobalBlock)
NARROW_F = 8            # a table this narrow goes per feature (kNarrowF)
COLUMN_BLOCK = 128      # rows a per-feature block takes (kColumnBlock)

LAUNCHES = {"bucketize": 0}


def reset_launches() -> None:
    LAUNCHES["bucketize"] = 0


def table_geometry(f: int, u: int) -> dict:
    """The staged table, as ``csrc/bucketize.cu``'s ``Table`` lays it out:
    a row of ``len`` floats (U edges, then +inf up to both ``up``, U padded
    to a multiple of 8, and ``p``, the power of two above U) at an odd
    stride ``rs``, the group summaries at ``ss`` float2 (odd), a sorted
    flag a row, ``slots`` rows (4 * ceil(F / 4)); feature f in slot
    (f % 4) * ceil(F / 4) + f // 4; ``bytes`` in all."""
    up = (u + 7) & ~7
    groups = up // 8
    p = 1
    while p <= u:
        p <<= 1
    length = max(up, p)
    rs, ss = length + 1, groups | 1
    quarter = (f + 3) // 4
    slots = 4 * quarter
    return {"up": up, "groups": groups, "p": p, "len": length, "rs": rs,
            "ss": ss, "quarter": quarter, "slots": slots,
            "bytes": 4 * (slots * rs + 2 * slots * ss + slots)}


def feature_slot(f: int, quarter: int) -> int:
    """The staged row slot of feature ``f`` (csrc: ``Table::slot``)."""
    return (f & 3) * quarter + (f >> 2)


def column_floats(u: int) -> int:
    """Floats of one warp's copy of a row on the per-feature route (csrc:
    ``warp_floats``): U padded to a multiple of 8, then a (min, max) pair
    per group of 8, rounded up to a 16-byte multiple."""
    up = (u + 7) & ~7
    return (up + up // 4 + 3) & ~3


def launch_plan(n: int, f: int, u: int, *, sms: int) -> dict:
    """How the kernel covers (N, F): ``route`` 'columns' (a narrow table,
    F <= ``NARROW_F``: ``grid`` (blocks along N, F) of ``COLUMN_BLOCK``
    rows and one feature, each warp staging its own copy of the row),
    'staged' (the whole table in shared memory, ``smem`` bytes) or 'serial'
    (a table past ``SMEM_BUDGET``: one element a thread, ``grid`` blocks
    of ``GLOBAL_BLOCK``). For 'staged': a grid of at most a block an SM,
    each walking tiles blockIdx.x, + grid, ...; ``threads`` a block
    (``THREADS``, halved down to ``MIN_THREADS`` while the tiles would fill
    under half the grid), ``tile`` = 4 * threads elements (4 a thread) and
    ``tiles`` in all."""
    total = n * f
    geo = table_geometry(f, u)
    col_smem = 4 * column_floats(u) * (COLUMN_BLOCK // 32)
    if f <= NARROW_F and col_smem <= 48 * 1024:
        return {"route": "columns", "threads": COLUMN_BLOCK,
                "grid": (-(-n // COLUMN_BLOCK), f), "smem": col_smem,
                "table": geo}
    if geo["bytes"] > SMEM_BUDGET or f * u > 2 ** 31 - 1:
        return {"route": "serial", "threads": GLOBAL_BLOCK,
                "grid": -(-total // GLOBAL_BLOCK), "smem": 0, "table": geo}
    threads = THREADS
    while threads > MIN_THREADS and -(-total // (4 * threads)) < sms / 2:
        threads //= 2
    tile = 4 * threads
    tiles = -(-total // tile)
    return {"route": "staged", "threads": threads, "tile": tile,
            "tiles": tiles, "grid": min(tiles, sms), "smem": geo["bytes"],
            "table": geo}


def tile_elements(plan: dict, block: int, total: int):
    """The flat (row-major) elements block ``block`` of a staged plan
    counts, in the order it takes them: thread t takes 4 t .. 4 t + 3 of
    each of its tiles (the csrc's walk, for the tests)."""
    for tile in range(block, plan["tiles"], plan["grid"]):
        base = tile * plan["tile"]
        for i in range(base, min(base + plan["tile"], total)):
            yield i


def bucketize(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """x (N, F) f32, edges (F, U) f32 (+inf padded) -> (N, F) int32 bins.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and raises on operands it does not take (another dtype, a
    non-contiguous tensor, tensors on different devices)."""
    if not on_kernel_path(x):
        return bucketize_ref(x, edges)
    check_operands(x, ("edges", edges))
    n, f = x.shape
    if edges.dim() != 2 or edges.shape[0] != f:
        raise ValueError(f"edges {tuple(edges.shape)} do not match x "
                         f"{tuple(x.shape)}")
    out = torch.empty((n, f), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(n, f, edges.shape[1], sms=_build.sm_count(x.device))
    grid = plan["grid"] if plan["route"] == "staged" else 1
    _build.launch("bucketize", x.device,
                  (x.data_ptr(), edges.data_ptr(), out.data_ptr()),
                  (n, f, edges.shape[1], plan["threads"], grid))
    LAUNCHES["bucketize"] += 1
    return out
