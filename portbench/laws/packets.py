"""The packet law of the program's ``netsim/packets.synth_trace`` (copied):
flows start uniformly over the trace, each with Poisson packets (mean
``mean_pkts`` benign, half that anomalous, at least 2) spread over a
lognormal duration, with class-conditional ports, protocols and sizes.

Mix keys: ``flows_per_60s``, ``duration_s``, ``anomaly_frac``,
``mean_pkts``.
"""

from __future__ import annotations

import numpy as np


def synth(rng, n_flows: int, *, anomaly_frac: float = 0.13,
          mean_pkts: int = 12, duration: float = 60.0) -> dict:
    """``synth_trace``'s law over ``duration`` seconds: per-packet columns
    (time-sorted) plus ``flow_label`` a flow."""
    label = (rng.random(n_flows) < anomaly_frac).astype(np.int32)
    src_ip = rng.integers(0, 2**32, n_flows, dtype=np.uint32)
    dst_ip = rng.integers(0, 2**32, n_flows, dtype=np.uint32)
    common = np.array([80, 443, 53, 22, 25], np.uint16)
    dport = np.where(label == 0, common[rng.integers(0, 5, n_flows)],
                     rng.integers(1, 10000, n_flows).astype(np.uint16))
    sport = np.where(label == 0, rng.integers(32768, 61000, n_flows),
                     rng.integers(1024, 61000, n_flows)).astype(np.uint16)
    proto = np.where(rng.random(n_flows) < np.where(label == 0, 0.8, 0.45),
                     6, 17).astype(np.uint8)
    pkts = np.maximum(rng.poisson(np.where(label == 0, mean_pkts,
                                           mean_pkts // 2), n_flows), 2)
    start = np.sort(rng.uniform(0, duration, n_flows))
    dur = np.where(label == 0, rng.lognormal(-1.0, 1.0, n_flows),
                   rng.lognormal(-3.0, 0.8, n_flows))
    flow_id = np.repeat(np.arange(n_flows, dtype=np.int32), pkts)
    p = len(flow_id)
    ts = start[flow_id] + rng.random(p) * dur[flow_id]
    order = np.argsort(ts, kind="stable")
    direction = (rng.random(p) < 0.45).astype(np.uint8)
    base_len = np.where(label[flow_id] == 0, 800, 1200)
    length = np.clip(rng.normal(base_len, 300), 64, 1500).astype(np.uint16)
    return dict(ts=ts[order], src_ip=src_ip[flow_id][order],
                dst_ip=dst_ip[flow_id][order], sport=sport[flow_id][order],
                dport=dport[flow_id][order], proto=proto[flow_id][order],
                length=length[order], direction=direction[order],
                flow_id=flow_id[order], flow_label=label)


def packets(rngs, mix: dict) -> dict:
    """The mix's flows over ``duration_s`` seconds, from ``rngs[0]``."""
    dur = float(mix["duration_s"])
    return synth(rngs[0], int(round(mix["flows_per_60s"] * dur / 60.0)),
                 anomaly_frac=mix["anomaly_frac"],
                 mean_pkts=mix["mean_pkts"], duration=dur)
