"""Synthetic packet-trace generation.

Copy of ``repro/netsim/packets.py``: numpy only, so one seed gives the
same trace in both packages. A trace is a struct-of-arrays over packets —
the form a data plane sees.
Flows are generated first (with class-conditional statistics mirroring
repro_torch.data.unsw_like) and then exploded into per-packet records with
timestamps, sizes and directions.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PacketTrace:
    # per-packet arrays (length P)
    ts: np.ndarray          # float64 seconds
    src_ip: np.ndarray      # uint32
    dst_ip: np.ndarray      # uint32
    sport: np.ndarray       # uint16
    dport: np.ndarray       # uint16
    proto: np.ndarray       # uint8
    length: np.ndarray      # uint16
    direction: np.ndarray   # uint8 0=fwd 1=rev
    flow_id: np.ndarray     # int32 ground-truth flow index (for labels only)
    # per-flow ground truth (length NF)
    flow_label: np.ndarray  # int32 0=normal 1=anomaly

    @property
    def n_packets(self) -> int:
        return len(self.ts)

    @property
    def n_flows(self) -> int:
        return len(self.flow_label)


def synth_trace(n_flows=2000, anomaly_frac=0.13, seed=0,
                mean_pkts=12) -> PacketTrace:
    rng = np.random.default_rng(seed)
    label = (rng.random(n_flows) < anomaly_frac).astype(np.int32)

    # flow 5-tuples
    src_ip = rng.integers(0, 2**32, n_flows, dtype=np.uint32)
    dst_ip = rng.integers(0, 2**32, n_flows, dtype=np.uint32)
    common = np.array([80, 443, 53, 22, 25], np.uint16)
    dport = np.where(label == 0,
                     common[rng.integers(0, 5, n_flows)],
                     rng.integers(1, 10000, n_flows).astype(np.uint16))
    sport = np.where(label == 0,
                     rng.integers(32768, 61000, n_flows),
                     rng.integers(1024, 61000, n_flows)).astype(np.uint16)
    proto = np.where(rng.random(n_flows) < np.where(label == 0, 0.8, 0.45),
                     6, 17).astype(np.uint8)

    # per-flow packet counts / start / duration
    pkts = np.maximum(rng.poisson(np.where(label == 0, mean_pkts,
                                           mean_pkts // 2), n_flows), 2)
    start = np.sort(rng.uniform(0, 60.0, n_flows))
    dur = np.where(label == 0, rng.lognormal(-1.0, 1.0, n_flows),
                   rng.lognormal(-3.0, 0.8, n_flows))

    # explode to packets
    flow_id = np.repeat(np.arange(n_flows, dtype=np.int32), pkts)
    p = len(flow_id)
    offs = rng.random(p)
    ts = start[flow_id] + offs * dur[flow_id]
    order = np.argsort(ts, kind="stable")
    direction = (rng.random(p) < 0.45).astype(np.uint8)
    base_len = np.where(label[flow_id] == 0, 800, 1200)
    length = np.clip(rng.normal(base_len, 300), 64, 1500).astype(np.uint16)

    return PacketTrace(
        ts=ts[order], src_ip=src_ip[flow_id][order],
        dst_ip=dst_ip[flow_id][order], sport=sport[flow_id][order],
        dport=dport[flow_id][order], proto=proto[flow_id][order],
        length=length[order], direction=direction[order],
        flow_id=flow_id[order], flow_label=label)
