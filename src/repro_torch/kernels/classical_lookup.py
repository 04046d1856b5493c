"""The fused IIsy classical-model pipeline (SVM / NB / K-Means): CUDA kernel
+ wrapper.

Replaces the Pallas TPU kernel of ``repro/kernels/classical_lookup.py``:
``_fused_classical_kernel`` (:36), reached from ``classical_lookup_fused``
(:48) and the compat entry ``classical_lookup_pallas`` (:78). The CUDA
source is ``csrc/classical_lookup.cu``; its range match is the device
function ``csrc/range_match.cuh`` shared with the tree kernel.

The paper's §4.3 "table per feature" mapping: each feature's bin holds a
quantized partial-term vector (a_j*x for SVM planes, log P(x|c) for NB,
(x-c)^2 for K-Means) and the pipeline sums them:

    out[n, m] = sum_f vtable_flat[f*Bp + bins[n, f], m],   m < M

The TPU wrote this as one blocked one-hot matmul (Pallas has no gather) and
returned the lane-padded (N, Mp); here one thread owns one row and gathers,
tables staged in shared memory when they fit (``fits_smem``) and read
through the read-only cache otherwise, and the output is (N, M).

Bound: memory (x, edges, vtable_flat and out once; ~69 KB at the served
shape N=2048, F=5, U=63, M<=2). PERF.md holds the measured time.

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
from repro_torch.kernels.ensemble_lookup import SMEM_BUDGET_BYTES, check_operands
from repro_torch.kernels.ref import bucketize_ref
from repro_torch.kernels.tuning import DEFAULT_TILES

LAUNCHES = {"classical": 0}


def reset_launches() -> None:
    LAUNCHES["classical"] = 0


def smem_bytes(f: int, u: int, b_pad: int, m_pad: int, staged: bool) -> int:
    """Dynamic shared memory of one launch (mirrors ``cl_smem_bytes`` in
    the CUDA source): the edges and the flat value table when ``staged``."""
    return 4 * (f * u + f * b_pad * m_pad) if staged else 0


def fits_smem(f: int, u: int, b_pad: int, m_pad: int) -> bool:
    """Stage the tables in shared memory when they fit one block's budget,
    else read them from global memory. It picks where the kernel reads
    from; it never routes away from the kernel."""
    return smem_bytes(f, u, b_pad, m_pad, True) <= SMEM_BUDGET_BYTES


def classical_lookup_fused_ref(x, edges, vtable_flat, m: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same flat table -> (N, M)."""
    f = x.shape[1]
    b_pad = vtable_flat.shape[0] // f
    bins = bucketize_ref(x, edges).long()                   # (N, F)
    rows = bins + torch.arange(f, device=x.device)[None, :] * b_pad
    return vtable_flat[rows][:, :, :m].sum(dim=1)


def classical_lookup_fused(x, edges, vtable_flat, m: int, *,
                           tile_n: int = None,
                           staged: bool = None) -> torch.Tensor:
    """Fused pipeline on the pre-flattened table -> (N, M) f32 sums.

    x (N, F) f32 (any N); edges (F, U) f32 (+inf padded); vtable_flat
    (F*Bp, Mp) f32 (``finalize_artifact``); m the logical column count
    (M <= Mp). tile_n is the CUDA block size; staged=None stages the tables
    in shared memory when ``fits_smem`` says so.
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
        staged = fits_smem(f, u, b_pad, m_pad)
    if smem_bytes(f, u, b_pad, m_pad, staged) > SMEM_BUDGET_BYTES:
        raise ValueError("the tables need more shared memory than a block "
                         "has; pass staged=False")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    _build.launch("classical_lookup", x.device,
                  (x.data_ptr(), edges.data_ptr(), vtable_flat.data_ptr(),
                   out.data_ptr()),
                  (n, f, u, b_pad, m_pad, m, int(staged), tile_n))
    LAUNCHES["classical"] += 1
    return out


def classical_lookup(x, edges, vtable, *, tile_n: int = None) -> torch.Tensor:
    """x (N, F) f32, edges (F, U), vtable (F, U+1, M) -> (N, M) f32 sums.

    The counterpart of the reference's compat entry
    ``classical_lookup_pallas``: flattens vtable on the fly (serving uses
    the artifact's pre-flattened copy)."""
    return classical_lookup_fused(x, edges, flatten_vtable(vtable),
                                  vtable.shape[2], tile_n=tile_n)
