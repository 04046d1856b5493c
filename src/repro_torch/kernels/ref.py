"""Plain PyTorch versions of the kernels — the ground truth the CUDA kernel
is held against, and what a wrapper runs for a CPU tensor.

Port of ``repro/kernels/ref.py`` (bucketize, ensemble and classical
lookups, the streaming register update, the int8-KV decode attention), plus the plain version of the
per-feature-loop kernel (``ensemble_lookup_loop_ref``: the reference has
none, and its tests run that kernel in interpret mode). The lookups are
gathers over the unflattened tables; the flat-table counterpart of the
fused kernel is ``ensemble_lookup.ensemble_lookup_fused_ref``.
"""

from __future__ import annotations

import numpy as np
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


def ensemble_lookup_loop_ref(x, edges, ftable, strides, dtable, *,
                             n_classes: int, vote: bool) -> torch.Tensor:
    """Plain version of the per-feature-loop kernel (B7) -> (N, Co) f32.

    What the reference's ``_loop_kernel`` computes, op for op: the keys are
    summed in f32 feature by feature (f = 0..F-1, ``keys + code * stride``)
    and cast to int32; the leaf is a compare-select over s in [0, S), so a
    key outside that range reads leaf 0.0 (``ensemble_lookup_ref`` would
    index out of range there); vote mode counts ``leaf == c`` for c in
    [0, n_classes), sum mode totals the leaves. ftable (F, U+1, T) int32,
    strides (T, F) int32, dtable (T, S) f32.
    """
    n, f = x.shape
    t, s = dtable.shape
    bins = bucketize_ref(x, edges).long()                    # (N, F)
    keys = torch.zeros((n, t), dtype=torch.float32, device=x.device)
    for fi in range(f):
        code = ftable[fi][bins[:, fi]].to(torch.float32)     # (N, T)
        keys = keys + code * strides[:, fi].to(torch.float32)[None, :]
    keys = keys.to(torch.int32)
    inside = (keys >= 0) & (keys < s)
    t_idx = torch.arange(t, device=x.device)[None, :]
    leaf = torch.where(inside,
                       dtable[t_idx, torch.where(inside, keys, 0).long()],
                       0.0).to(torch.float32)                # (N, T)
    if vote:
        c_iota = torch.arange(n_classes, dtype=torch.float32, device=x.device)
        return (leaf[:, :, None] == c_iota).to(torch.float32).sum(dim=1)
    return leaf.sum(dim=1, keepdim=True)


def classical_lookup_ref(x, edges, vtable) -> torch.Tensor:
    """Gather-based plain version of the classical pipeline. -> (N, M) f32."""
    bins = bucketize_ref(x, edges).long()
    f_idx = torch.arange(x.shape[1], device=x.device)[None, :]
    vals = vtable[f_idx, bins]                               # (N, F, M)
    return vals.to(torch.float32).sum(dim=1)


def stream_update_ref(regs, bucket, ts, length, is_fwd, valid, *,
                      limit=None):
    """Plain version of the streaming scatter/readout kernel (B5).

    regs (8, N) f32, the stacked register file in ``netsim.stream.
    REGISTER_FIELDS`` order (pkt_count, byte_count, t_min, t_max,
    fwd_pkts, rev_pkts, fwd_bytes, rev_bytes); window columns (W,):
    bucket int, ts/length/is_fwd f32, valid bool. Returns new tensors
    (new_regs (8, N), rows (8, W)): the window folded into the registers
    (count registers clamped at ``limit`` when given, the 2^24 overflow
    guard) and the updated register rows gathered at each lane's bucket.

    Op for op the reference's ``stream_update_ref``: masked per-bucket sums
    added to the registers, per-bucket min/max with invalid lanes pinned to
    the identities (+-inf), the clamp on the count registers only, then the
    gather. Lanes whose bucket lies outside [0, N) fold nothing (the
    reference's segment ops drop them); their rows are read the way the
    reference's gather reads them (a negative id counts from the end once,
    then ids are clamped into range).
    """
    n = regs.shape[1]
    b = bucket.long()
    inside = (b >= 0) & (b < n)
    b_in = torch.where(inside, b, 0)
    v = valid.to(torch.float32)
    ln, fwd = length, is_fwd
    inf = float("inf")

    def seg(x):
        x = torch.where(inside, x, 0.0)
        return torch.zeros(n, dtype=torch.float32,
                           device=regs.device).index_add_(0, b_in, x)

    def seg_ext(x, ident, reduce):
        x = torch.where(inside, x, ident)
        return torch.full((n,), ident, dtype=torch.float32,
                          device=regs.device).scatter_reduce_(
            0, b_in, x, reduce, include_self=True)

    w_min = seg_ext(torch.where(valid, ts, inf), inf, "amin")
    w_max = seg_ext(torch.where(valid, ts, -inf), -inf, "amax")
    new = [regs[0] + seg(v),
           regs[1] + seg(ln * v),
           torch.minimum(regs[2], w_min),
           torch.maximum(regs[3], w_max),
           regs[4] + seg(fwd * v),
           regs[5] + seg((1.0 - fwd) * v),
           regs[6] + seg(ln * fwd * v),
           regs[7] + seg(ln * (1.0 - fwd) * v)]
    if limit is not None:
        lim = float(np.float32(limit))
        for i in (0, 1, 4, 5, 6, 7):              # count registers only
            new[i] = torch.clamp(new[i], max=lim)
    new_regs = torch.stack(new)
    g = torch.where(b < 0, b + n, b).clamp(0, n - 1)
    return new_regs, new_regs[:, g]


def decode_attention_int8_ref(q, k_q, k_s, v_q, v_s, valid, *, scale):
    """Dense oracle for the int8-KV decode-attention kernel (B8).

    q (B,G,M,hd) f32; k_q/v_q (B,S,G,hd) int8; k_s/v_s (B,S,G,1) f32;
    valid (B,S) -> (B,G,M,hd) f32. Dequantizes the whole cache, scores it,
    masks dead slots with -1e30 and softmaxes, as the reference does: with
    every slot dead the output is the uniform mean of V over all S slots."""
    k = k_q.to(torch.float32) * k_s                        # (B,S,G,hd)
    v = v_q.to(torch.float32) * v_s
    sc = torch.einsum("bgmd,bsgd->bgms", q, k) * scale
    sc = torch.where(valid[:, None, None, :] > 0.5, sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bgms,bsgd->bgmd", w, v)
