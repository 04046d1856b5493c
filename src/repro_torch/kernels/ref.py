"""Plain PyTorch versions of the kernels — the ground truth the CUDA kernel
is held against, and what a wrapper runs for a CPU tensor.

Port of ``repro/kernels/ref.py`` (bucketize, ensemble and classical
lookups). These are gathers over the unflattened tables; the flat-table
counterpart of the fused kernel is ``ensemble_lookup.ensemble_lookup_fused_ref``.
"""

from __future__ import annotations

import torch


def bucketize_ref(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """x (N, F), edges (F, U) (+inf padded) -> (N, F) int32 bin ids."""
    return (x[:, :, None] > edges[None, :, :]).sum(dim=2, dtype=torch.int32)


def tree_keys(x, edges, ftable, strides) -> torch.Tensor:
    """(N, T) int64 decision keys: sum_f ftable[f, bin_f, t] * strides[t, f]."""
    bins = bucketize_ref(x, edges).long()                    # (N, F)
    f_idx = torch.arange(x.shape[1], device=x.device)[None, :]
    codes = ftable[f_idx, bins].long()                       # (N, F, T)
    return (codes * strides.t().long()[None, :, :]).sum(dim=1)


def ensemble_lookup_ref(x, edges, ftable, strides, dtable, *,
                        n_classes: int, vote: bool) -> torch.Tensor:
    """Gather-based plain version of the fused tree pipeline -> (N, Co) f32."""
    keys = tree_keys(x, edges, ftable, strides)              # (N, T)
    t_idx = torch.arange(dtable.shape[0], device=x.device)[None, :]
    leaf = dtable[t_idx, keys]                               # (N, T)
    if vote:
        return torch.nn.functional.one_hot(
            leaf.long(), n_classes).to(torch.float32).sum(dim=1)
    return leaf.to(torch.float32).sum(dim=1, keepdim=True)


def classical_lookup_ref(x, edges, vtable) -> torch.Tensor:
    """Gather-based plain version of the classical pipeline. -> (N, M) f32."""
    bins = bucketize_ref(x, edges).long()
    f_idx = torch.arange(x.shape[1], device=x.device)[None, :]
    vals = vtable[f_idx, bins]                               # (N, F, M)
    return vals.to(torch.float32).sum(dim=1)
