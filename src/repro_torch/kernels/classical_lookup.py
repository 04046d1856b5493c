"""The fused IIsy classical-model pipeline (SVM / NB / K-Means): CUDA kernel
+ wrapper.

Replaces the Pallas TPU kernel of ``repro/kernels/classical_lookup.py``:
``_fused_classical_kernel`` (:36), reached from ``classical_lookup_fused``
(:48) and the compat entry ``classical_lookup_pallas`` (:78). The CUDA
source is ``csrc/classical_lookup.cu``; its copies and range match are
``csrc/lane_lookup.cuh``'s, shared with the tree lookups.

The paper's §4.3 "table per feature" mapping: each feature's bin holds a
quantized partial-term vector (a_j*x for SVM planes, log P(x|c) for NB,
(x-c)^2 for K-Means) and the pipeline sums them:

    out[n, m] = sum_f vtable_flat[f*Bp + bins[n, f], m],   m < M

The TPU wrote this as one blocked one-hot matmul (Pallas has no gather) and
returned the lane-padded (N, Mp); here the kernel is the lane lookups' front
half (``csrc/lane_lookup.cuh``, as B1, B2 and B7): a block takes ``tile_n``
rows with several threads a row (``launch_plan``), copies x, the edges and
the value table's M live columns in by ``cp.async`` (the table behind the
range match), range-matches from group summaries, and splits a row's
features over its threads, whose sums meet by shuffles. ``stage_mode``
picks what lives in shared memory ('all', 'edges' or 'none'; the rest is
read through the read-only cache). The output is (N, M).

Bound: memory (x, edges, the table entries read and out once; ~60 KB at the
served shape N=2048, F=5, U=63, M<=2). PERF.md holds the measured time.

Exactness envelope: the entries are integers |q| <= 2^(bits-1) - 1, so
while F * (2^(bits-1) - 1) <= 2^24 (F <= 512 at 16 bits) every sum is exact
in f32 in any order, and the kernel equals ``classical_lookup_fused_ref``
bit for bit.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``classical_lookup_fused_ref``, the plain version on the same flat table.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.core.artifact import flatten_vtable
from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.ensemble_lookup import (RM_GROUP, SMEM_BUDGET_BYTES,
                                                 _lanes_threads, _up4,
                                                 check_operands)
from repro_torch.kernels.ref import bucketize_ref
from repro_torch.kernels.tuning import DEFAULT_TILES

LAUNCHES = {"classical": 0}


def reset_launches() -> None:
    LAUNCHES["classical"] = 0


# what the kernel stages in shared memory: the CUDA source's STAGE_NONE,
# STAGE_EDGES (the edges) and STAGE_ALL (the edges and the value table)
STAGE_MODES = {"none": 0, "edges": 1, "all": 2}


def smem_bytes(f: int, u: int, b_pad: int, m: int, staged: str,
               tile_n: int) -> int:
    """Dynamic shared memory of one launch (mirrors ``cl_layout`` in the
    CUDA source), each part rounded up to 16 bytes: a (min, max) per group
    of ``RM_GROUP`` edges, the block's ``tile_n`` rows of x and their
    table-row offsets; from ``staged='edges'`` the edges; at
    ``staged='all'`` also the value table's M live columns, packed (F*Bp
    rows of M words)."""
    if staged not in STAGE_MODES:
        raise ValueError(f"staged must be one of {sorted(STAGE_MODES)}, "
                         f"got {staged!r}")
    words = _up4(2 * f * -(-u // RM_GROUP)) + 2 * _up4(f * tile_n)
    if staged != "none":
        words += _up4(f * u)
    if staged == "all":
        words += f * b_pad * m
    return 4 * words


def stage_mode(f: int, u: int, b_pad: int, m: int, tile_n: int) -> str:
    """The shared-memory fit check: 'all' when the edges and the value
    table's live columns fit one block's budget, else 'edges' when the
    edges do, else 'none'. It picks where the kernel reads from; it never
    routes away from the kernel."""
    for mode in ("all", "edges"):
        if smem_bytes(f, u, b_pad, m, mode, tile_n) <= SMEM_BUDGET_BYTES:
            return mode
    return "none"


def fits_smem(f: int, u: int, b_pad: int, m: int,
              tile_n: int = DEFAULT_TILES.tile_n) -> bool:
    """True when a launch stages every table in shared memory."""
    return stage_mode(f, u, b_pad, m, tile_n) == "all"


def launch_plan(n: int, f: int, u: int, b_pad: int, m: int, staged: str,
                tile_n: int) -> dict:
    """How one launch covers N rows: ``tile_n`` rows a block, ``blocks``
    blocks, ``lanes`` threads a row (as many as its F features can use, a
    power of two, at most 32), ``threads`` a block, ``stage`` (the CUDA
    source's STAGE_NONE, STAGE_EDGES or STAGE_ALL) and ``smem`` bytes of
    dynamic shared memory."""
    lanes, threads = _lanes_threads(f, tile_n)
    return {"blocks": -(-n // tile_n), "threads": threads, "lanes": lanes,
            "smem": smem_bytes(f, u, b_pad, m, staged, tile_n),
            "stage": STAGE_MODES[staged]}


def classical_lookup_fused_ref(x, edges, vtable_flat, m: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same flat table -> (N, M)."""
    f = x.shape[1]
    b_pad = vtable_flat.shape[0] // f
    bins = bucketize_ref(x, edges).long()                   # (N, F)
    rows = bins + torch.arange(f, device=x.device)[None, :] * b_pad
    return vtable_flat[rows][:, :, :m].sum(dim=1)


def classical_lookup_fused(x, edges, vtable_flat, m: int, *,
                           tile_n: int = None,
                           staged: str = None) -> torch.Tensor:
    """Fused pipeline on the pre-flattened table -> (N, M) f32 sums.

    x (N, F) f32 (any N); edges (F, U) f32 (+inf padded); vtable_flat
    (F*Bp, Mp) f32 (``finalize_artifact``); m the logical column count
    (M <= Mp). tile_n is the rows a CUDA block covers; staged picks what
    lives in shared memory ('all', 'edges' or 'none'; ``STAGE_MODES``);
    None takes what ``stage_mode`` says fits.
    """
    if not on_kernel_path(x):
        return classical_lookup_fused_ref(x, edges, vtable_flat, m)
    n, f = x.shape
    u = edges.shape[1]
    fb, m_pad = vtable_flat.shape
    tile_n = tile_n or DEFAULT_TILES.tile_n
    check_operands(x, ("edges", edges), ("vtable_flat", vtable_flat))
    if edges.shape[0] != f or fb % f or fb // f < u + 1 or not 1 <= m <= m_pad:
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, edges "
            f"{tuple(edges.shape)}, vtable_flat {tuple(vtable_flat.shape)}, "
            f"m {m}")
    b_pad = fb // f
    if staged is None:
        staged = stage_mode(f, u, b_pad, m, tile_n)
    plan = launch_plan(n, f, u, b_pad, m, staged, tile_n)
    if plan["smem"] > SMEM_BUDGET_BYTES:
        raise ValueError("launch needs more shared memory than a block has; "
                         "lower tile_n or stage fewer tables")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    _build.launch("classical_lookup", x.device,
                  (x.data_ptr(), edges.data_ptr(), vtable_flat.data_ptr(),
                   out.data_ptr()),
                  (n, f, u, b_pad, m_pad, m, plan["stage"], tile_n,
                   plan["lanes"], plan["threads"], plan["smem"]))
    LAUNCHES["classical"] += 1
    return out


def classical_lookup(x, edges, vtable, *, tile_n: int = None) -> torch.Tensor:
    """x (N, F) f32, edges (F, U), vtable (F, U+1, M) -> (N, M) f32 sums.

    The counterpart of the reference's compat entry
    ``classical_lookup_pallas``: flattens vtable on the fly (serving uses
    the artifact's pre-flattened copy)."""
    return classical_lookup_fused(x, edges, flatten_vtable(vtable),
                                  vtable.shape[2], tile_n=tile_n)
