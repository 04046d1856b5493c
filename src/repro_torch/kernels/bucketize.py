"""Standalone range match ("bucketize"): CUDA kernel + wrapper.

Replaces the Pallas TPU kernel of ``repro/kernels/bucketize.py``:
``_bucketize_kernel`` (:32), reached from ``bucketize_pallas`` (:45) and
``ops.bucketize``. The CUDA source is ``csrc/bucketize.cu``.

    out[n, f] = #{u : x[n, f] > edges[f, u]}      x (N, F) f32, edges (F, U) f32

as int32, edges padded with +inf (never matched): a count on any edge row,
sorted or not. A block takes one feature and ``BLOCK`` rows: each warp
stages that edge row in shared memory with a (min, max) summary per group
of 8 edges, and each thread counts one element: whole groups from their
summaries, the one group it falls inside (or, on a row out of order, the
whole row) edge by edge. A row past the shared-memory budget takes the
serial walk of ``csrc/range_match.cuh`` (the lookup kernels' range match)
instead. The ragged last block is masked, so N needs no padding.

Bound: memory (x, edges and out once; 641 KB at the fit's N=16000, F=5,
U=63). PERF.md holds the measured time.

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

BLOCK = 128             # rows of x a block takes (threads, a multiple of 32)

LAUNCHES = {"bucketize": 0}


def reset_launches() -> None:
    LAUNCHES["bucketize"] = 0


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
    _build.launch("bucketize", x.device,
                  (x.data_ptr(), edges.data_ptr(), out.data_ptr()),
                  (n, f, edges.shape[1], BLOCK))
    LAUNCHES["bucketize"] += 1
    return out
