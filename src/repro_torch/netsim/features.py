"""Packet- and flow-level feature extraction (§5 of the paper), in PyTorch.

Port of ``repro/netsim/features.py``. Switch mechanism -> realization:
  parser header extraction   -> elementwise maps over packet columns
  hash(flow 5-tuple)         -> vectorized FNV-1a integer hash
  per-flow registers         -> ``index_add_`` / ``scatter_reduce_`` keyed
                                by hash bucket
  payload parsing (§5.3)     -> digit accumulation over the bytes of a
                                fixed-width field, one column at a time

Hash-bucket collisions are real (they are on the switch too): features of
colliding flows merge, exactly like two flows sharing a register slot.

The payload parse runs where its input lies: on a CUDA tensor it is the
switch's parse on the card, on a CPU tensor the same ops on the CPU.
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


def fnv1a_hash_np(*cols, n_buckets: int) -> np.ndarray:
    """``fnv1a_hash`` on the host in numpy -> (P,) int32 bucket ids, the
    same values. uint32 products wrap as the reference's do, and the
    ufunc loops release the GIL, so the ingest ring's hash on the prefetch
    thread leaves the serving thread free (and starts no intra-op thread
    team of PyTorch's on that thread)."""
    h = np.full(np.shape(cols[0]), FNV_OFFSET, np.uint32)
    prime = np.uint32(FNV_PRIME)
    for c in cols:
        c = np.asarray(c).astype(np.uint32)
        for shift in (0, 8, 16, 24):
            h = (h ^ ((c >> np.uint32(shift)) & np.uint32(0xFF))) * prime
    return (h % np.uint32(n_buckets)).astype(np.int32)


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


def aggregate_features(trace, *, key: str = "dport", n_buckets=1024,
                       device=None):
    """Aggregate-level features over a traffic group (§5.2).

    Groups packets by a coarse key (e.g. destination port = "traffic toward
    application X") and reduces volume/rate statistics per group. Returns
    (group_ids (P,) int32, agg_table (n_buckets, 3): pkts, bytes, rate) on
    ``device`` (None: CUDA). Timestamps are rebased in float64 before the
    f32 cast, as ``flow_features`` does; a group with no duration has rate 0.
    """
    dev = resolve_device(device)
    col = torch.as_tensor(np.asarray(getattr(trace, key)), device=dev)
    g = (col.to(torch.int32) % n_buckets).to(torch.int32)
    ln = torch.as_tensor(np.asarray(trace.length, np.float32), device=dev)
    ts = rebase_ts(trace.ts, device=dev)
    cnt = segment_sum(torch.ones_like(ln), g, n_buckets)
    byt = segment_sum(ln, g, n_buckets)
    dur = torch.where(cnt > 0, segment_max(ts, g, n_buckets)
                      - segment_min(ts, g, n_buckets), 0.0)
    rate = torch.where(dur > 0, byt / torch.clamp(dur, min=1e-6), 0.0)
    return g, torch.stack([cnt, byt, rate], dim=1)


# ---------------------------------------------------------------------------
# file-level (§5.3): fixed-width csv payloads, fields split across packets
# ---------------------------------------------------------------------------

def _format_fixed(v: float, width: int) -> str:
    """Format ``v`` into exactly ``width`` ASCII chars, dropping fractional
    digits to fit, so every retained digit is a correctly rounded one (a
    right-truncated rendering would be a different number)."""
    for prec in range(3, -1, -1):
        s = f"{v:.{prec}f}"
        if len(s) <= width:
            return s.rjust(width)
    raise ValueError(f"value {v!r} does not fit in {width} ASCII chars")


def encode_csv_payload(values, width=8) -> np.ndarray:
    """Encode float rows as fixed-width ASCII columns (the paper's
    reformatted Jane Street file: "columns of eight characters"). Host-side.

    values (R, C) -> uint8 bytes (R, C*width) numpy.
    """
    values = np.asarray(values)
    r, c = values.shape
    out = np.zeros((r, c * width), np.uint8)
    for i in range(r):
        row = "".join(_format_fixed(float(v), width) for v in values[i])
        out[i] = np.frombuffer(row.encode("ascii"), np.uint8)
    return out


def _ascii_to_float(field: torch.Tensor) -> torch.Tensor:
    """Parse fixed-width ASCII numeric fields (N, W) uint8 -> (N,) float32.

    Switch-feasible parsing: digit accumulation with sign and decimal
    point, no branches, each byte contributing by a masked multiply-add.
    The reference scans the W byte columns; this loops over them, with the
    reference's roundings. Its compiled scan contracts both ``val * 10 + d``
    and ``val + d * frac_scale`` into fused multiply-adds, which round
    once; here each runs in float64 and is rounded to f32 once.
    ``val * 10 + d`` is exact in float64 for an f32 ``val`` and a digit, so
    its one rounding is the FMA's at any width (integer parts past 2^24
    included). In ``val + d * frac_scale`` the float64 product is exact,
    but the sum may round before the cast, so that step equals the FMA on
    the fields the tests hold it to, not by construction.
    ``frac_scale * 0.1`` stays a separate f32 op. The card and the CPU
    agree bit for bit.
    """
    dev = field.device
    tenth = torch.full((), 0.1, dtype=torch.float32, device=dev)
    is_digit = (field >= 48) & (field <= 57)
    digit = torch.where(is_digit, field.to(torch.int32) - 48,
                        0).to(torch.float32)
    is_dot = field == 46
    n, w = field.shape
    val = torch.zeros(n, dtype=torch.float32, device=dev)
    frac_scale = torch.ones(n, dtype=torch.float32, device=dev)
    seen_dot = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(w):
        d, dot, dig = digit[:, j], is_dot[:, j], is_digit[:, j]
        whole = (val.to(torch.float64) * 10.0
                 + d.to(torch.float64)).to(torch.float32)
        val = torch.where(dig & ~seen_dot, whole, val)
        frac_scale = torch.where(dig & seen_dot, frac_scale * tenth,
                                 frac_scale)
        frac = (val.to(torch.float64)
                + d.to(torch.float64) * frac_scale.to(torch.float64))
        val = torch.where(dig & seen_dot, frac.to(torch.float32), val)
        seen_dot = seen_dot | dot
    sign = torch.where((field == 45).any(dim=1), -1.0, 1.0)
    return sign * val


def _as_payload(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a, np.uint8),
                           device=resolve_device(device))


def stitch_split_payload(first_pkt, second_pkt, *, device=None):
    """Re-stitch a record split across two packets (§5.3).

    Models the switch mechanism: the tail bytes of packet k are saved in a
    register and prepended to packet k+1 before parsing. first_pkt (R, A),
    second_pkt (R, B) uint8 -> (R, A+B), on the first tensor's device (host
    arrays go to ``device``, None: CUDA).
    """
    first = _as_payload(first_pkt, device)
    second = _as_payload(second_pkt, first.device).to(first.device)
    return torch.cat([first, second], dim=1)


def file_features_csv(payload, feature_cols, width=8, *, device=None):
    """Extract selected fixed-width columns from csv payload bytes.

    payload (R, C*width) uint8 (use ``stitch_split_payload`` first when a
    row spans packets) -> (R, len(feature_cols)) float32, parsed where the
    payload lies (host arrays go to ``device``, None: CUDA).
    """
    payload = _as_payload(payload, device)
    return torch.stack([_ascii_to_float(payload[:, c * width:(c + 1) * width])
                        for c in feature_cols], dim=1)
