"""The program's ``netsim/scenarios.elephant_mice`` (copied): the packet
law's mice, and a few bulk flows that span the whole trace.

Mix keys: those of ``packets`` for the mice, and ``elephants``:
``{"count": flows, "pkts_per_60s": packets a flow}``.
"""

from __future__ import annotations

import numpy as np

from portbench.laws import PACKET_FIELDS
from portbench.laws import packets as mice


def bulk(rng, n_elephants: int, pkts_each: int, duration: float) -> dict:
    """``n_elephants`` bulk flows to port 443 (TCP), each of ``pkts_each``
    packets uniform over ``duration``, about 1400 bytes, 90% forward;
    every elephant labeled anomalous."""
    src = rng.integers(0, 2**32, n_elephants, dtype=np.uint32)
    dst = rng.integers(0, 2**32, n_elephants, dtype=np.uint32)
    sport = rng.integers(1024, 65535, n_elephants).astype(np.uint16)
    flow_id = np.repeat(np.arange(n_elephants, dtype=np.int32), pkts_each)
    ts = rng.uniform(0, duration, len(flow_id))
    order = np.argsort(ts, kind="stable")
    length = np.clip(rng.normal(1400.0, 40, len(flow_id)),
                     64, 1500).astype(np.uint16)
    direction = (rng.random(len(flow_id)) < 0.1).astype(np.uint8)
    f = flow_id[order]
    return dict(ts=ts[order], src_ip=src[f], dst_ip=dst[f], sport=sport[f],
                dport=np.full(len(f), 443, np.uint16),
                proto=np.full(len(f), 6, np.uint8), length=length[order],
                direction=direction[order], flow_id=f,
                flow_label=np.ones(n_elephants, np.int32))


def merge(a: dict, b: dict) -> dict:
    """Interleave two traces by timestamp (stable); ``b``'s flow ids move
    past ``a``'s so ``flow_label[flow_id]`` stays each packet's label."""
    order = np.argsort(np.concatenate([a["ts"], b["ts"]]), kind="stable")
    out = {k: np.concatenate([a[k], b[k]])[order]
           for k in PACKET_FIELDS if k != "flow_id"}
    fid = np.concatenate([a["flow_id"],
                          b["flow_id"] + len(a["flow_label"])])
    out["flow_id"] = fid[order].astype(np.int32)
    out["flow_label"] = np.concatenate([a["flow_label"],
                                        b["flow_label"]]).astype(np.int32)
    return out


def packets(rngs, mix: dict) -> dict:
    """The mice from ``rngs[0]``, the elephants from ``rngs[1]``."""
    dur = float(mix["duration_s"])
    el = mix["elephants"]
    pkts = int(round(el["pkts_per_60s"] * dur / 60.0))
    return merge(mice.packets(rngs, mix),
                 bulk(rngs[1], el["count"], pkts, dur))
