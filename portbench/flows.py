"""Packets to switch inputs: the flow hash, the rebased timestamps, and the
batch flow table the stream cells' ensembles are fitted on (numpy)."""

from __future__ import annotations

import numpy as np

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619


def fnv1a_buckets(trace: dict, n_buckets: int) -> np.ndarray:
    """32-bit FNV-1a over the 5-tuple (each field as 4 little-endian
    bytes), modulo ``n_buckets`` -> (P,) int32 bucket ids."""
    h = np.full(len(trace["ts"]), FNV_OFFSET, np.uint32)
    prime = np.uint32(FNV_PRIME)
    for key in ("src_ip", "dst_ip", "sport", "dport", "proto"):
        c = np.asarray(trace[key]).astype(np.uint32)
        for shift in (0, 8, 16, 24):
            h = (h ^ ((c >> np.uint32(shift)) & np.uint32(0xFF))) * prime
    return (h % np.uint32(n_buckets)).astype(np.int32)


def columns(trace: dict, n_buckets: int, n_packets: int) -> dict:
    """The first ``n_packets`` packets as the switch sees them: bucket ids,
    timestamps rebased to the first packet (in float64, then float32),
    lengths and the forward flag, as float32 columns."""
    sl = slice(0, n_packets)
    ts = np.asarray(trace["ts"][sl], np.float64)
    return dict(bucket=fnv1a_buckets({k: v[sl] for k, v in trace.items()
                                      if k != "flow_label"}, n_buckets),
                ts=(ts - ts[0]).astype(np.float32),
                length=np.asarray(trace["length"][sl], np.float32),
                is_fwd=(np.asarray(trace["direction"][sl]) == 0)
                .astype(np.float32))


def flow_rows(cols: dict, flow_id: np.ndarray, flow_label: np.ndarray,
              n_buckets: int):
    """(x (flows, 8) f32, y (flows,)): each flow seen in ``cols`` labeled,
    with its bucket's registers over all of ``cols`` (count, bytes,
    duration, mean inter-arrival, forward / reverse packets and bytes)."""
    b = cols["bucket"].astype(np.int64)
    ln, fw, ts = cols["length"], cols["is_fwd"], cols["ts"]
    add = lambda v: np.bincount(b, v, n_buckets).astype(np.float32)
    cnt, byt = add(np.ones_like(ln)), add(ln)
    t_min = np.full(n_buckets, np.inf, np.float32)
    t_max = np.full(n_buckets, -np.inf, np.float32)
    np.minimum.at(t_min, b, ts)
    np.maximum.at(t_max, b, ts)
    dur = np.where(cnt > 0, t_max - t_min, 0.0).astype(np.float32)
    iat = np.where(cnt > 1, dur / np.maximum(cnt - 1.0, 1.0),
                   0.0).astype(np.float32)
    table = np.stack([cnt, byt, dur, iat, add(fw), add(1.0 - fw),
                      add(ln * fw), add(ln * (1.0 - fw))], axis=1)
    flows, first = np.unique(flow_id, return_index=True)
    return table[b[first]], flow_label[flows]
