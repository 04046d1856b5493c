"""Packet- and flow-level feature extraction (§5 of the paper), in PyTorch.

Port of ``repro/netsim/features.py`` (the parts the streaming slice
needs). Switch mechanism -> realization:
  parser header extraction   -> elementwise maps over packet columns
  hash(flow 5-tuple)         -> vectorized FNV-1a integer hash
  per-flow registers         -> ``index_add_`` / ``scatter_reduce_`` keyed
                                by hash bucket

Hash-bucket collisions are real (they are on the switch too): features of
colliding flows merge, exactly like two flows sharing a register slot.

The aggregate-level and file-level (CSV payload) features are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


def rebase_ts_np(ts, t0=None) -> np.ndarray:
    """Rebase raw timestamps to ``t0``-relative seconds -> float32 numpy.

    At epoch scale (~1.7e9 s) float32 resolution is ~256 s, so the
    subtraction happens in float64 on the host *before* the cast. t0
    defaults to the minimum timestamp; the streaming path passes its
    latched stream epoch. The one definition every path shares: the
    streaming-vs-batch bit-consistency contract depends on it.
    """
    ts64 = np.asarray(ts, np.float64)
    if t0 is None:
        t0 = ts64.min() if ts64.size else 0.0
    return (ts64 - t0).astype(np.float32)


def rebase_ts(ts, t0=None, *, device=None) -> torch.Tensor:
    """``rebase_ts_np`` as a float32 tensor on ``device`` (None: CUDA)."""
    return torch.as_tensor(rebase_ts_np(ts, t0), device=resolve_device(device))


def table_from_registers(cnt, byt, t_min, t_max, fwd_pkts, rev_pkts,
                         fwd_bytes, rev_bytes) -> torch.Tensor:
    """Derive the 8-column flow-feature table from raw registers.

    Shared by the one-shot path (``flow_features``) and the streaming path
    (``netsim.stream.flow_table_readout``), so both derive duration and
    mean inter-arrival time identically. Untouched buckets carry
    t_min=+inf / t_max=-inf (the min/max identities); the cnt > 0 guard
    maps them to zero. The mean-IAT division is tensor by tensor, a true
    division on every device, as the reference's is.
    """
    dur = torch.where(cnt > 0, t_max - t_min, 0.0)
    iat = torch.where(cnt > 1, dur / torch.clamp(cnt - 1.0, min=1.0), 0.0)
    return torch.stack([cnt, byt, dur, iat, fwd_pkts, rev_pkts,
                        fwd_bytes, rev_bytes], dim=1)


def _as_u32(c, device) -> torch.Tensor:
    """An integer column as int64 holding its uint32 value (the reference
    casts every column to uint32 first)."""
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=torch.int64) & _U32
    return torch.as_tensor(np.asarray(c).astype(np.uint32).astype(np.int64),
                           device=device)


def fnv1a_hash(*cols, n_buckets: int, device=None) -> torch.Tensor:
    """Vectorized 32-bit FNV-1a over integer columns -> int32 bucket id.

    The reference multiplies in uint32, which wraps. Here the hash lives in
    int64: h < 2^32 and the prime < 2^25, so the product fits, and
    ``& 0xFFFFFFFF`` is the wrap. Runs on the device of a tensor column,
    else on ``device`` (None: CUDA).
    """
    dev = (cols[0].device if isinstance(cols[0], torch.Tensor)
           else resolve_device(device))
    h = None
    for c in cols:
        c = _as_u32(c, dev)
        if h is None:
            h = torch.full(c.shape, FNV_OFFSET, dtype=torch.int64, device=dev)
        for shift in (0, 8, 16, 24):
            byte = (c >> shift) & 0xFF
            h = ((h ^ byte) * FNV_PRIME) & _U32
    return (h % n_buckets).to(torch.int32)


def packet_features(trace, *, device=None) -> torch.Tensor:
    """Stateless per-packet features (parser stage).

    Columns: sport, dport, proto, length, is_sm_ips_ports (src==dst port),
    direction. -> (P, 6) float32 on ``device`` (None: CUDA).
    """
    dev = resolve_device(device)
    col = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    sport, dport = col(trace.sport), col(trace.dport)
    return torch.stack([sport, dport, col(trace.proto), col(trace.length),
                        (sport == dport).to(torch.float32),
                        col(trace.direction)], dim=1)


def segment_sum(v: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Per-bucket sums of ``v`` (zeros where no lane lands)."""
    return torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(
        0, b.long(), v)


def segment_min(v: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Per-bucket minima of ``v`` (+inf, the identity, where no lane lands)."""
    return torch.full((n,), float("inf"), dtype=v.dtype,
                      device=v.device).scatter_reduce_(
        0, b.long(), v, "amin", include_self=True)


def segment_max(v: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Per-bucket maxima of ``v`` (-inf, the identity, where no lane lands)."""
    return torch.full((n,), float("-inf"), dtype=v.dtype,
                      device=v.device).scatter_reduce_(
        0, b.long(), v, "amax", include_self=True)


def flow_features(trace, n_buckets=4096, *, device=None):
    """Stateful flow-level features via hash + per-bucket registers.

    Returns (bucket_ids (P,) int32, flow_table (n_buckets, 8) f32) on
    ``device`` (None: CUDA), columns:
      0 pkt_count  1 byte_count  2 duration  3 mean_iat
      4 fwd_pkts   5 rev_pkts    6 fwd_bytes 7 rev_bytes
    The batch oracle of the streaming path: counts are integer-valued f32
    sums, exact in any order below 2^24, so atomics on the card give the
    reference's bits.
    """
    dev = resolve_device(device)
    b = fnv1a_hash(trace.src_ip, trace.dst_ip, trace.sport, trace.dport,
                   trace.proto, n_buckets=n_buckets, device=dev)
    ts = rebase_ts(trace.ts, device=dev)
    ln = torch.as_tensor(np.asarray(trace.length, np.float32), device=dev)
    fwd = torch.as_tensor((np.asarray(trace.direction) == 0)
                          .astype(np.float32), device=dev)
    seg = lambda v: segment_sum(v, b, n_buckets)
    table = table_from_registers(
        seg(torch.ones_like(ln)), seg(ln), segment_min(ts, b, n_buckets),
        segment_max(ts, b, n_buckets), seg(fwd), seg(1.0 - fwd),
        seg(ln * fwd), seg(ln * (1.0 - fwd)))
    return b, table
