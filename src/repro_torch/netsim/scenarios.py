"""Adversarial packet-trace scenarios: the workloads a flow table fears.

Port of ``repro/netsim/scenarios.py``: numpy on the host, so one seed
gives the same trace in both packages, with or without a card
(``collision_storm`` hashes on the CPU).

``packets.synth_trace`` generates a benign UNSW-like mix — flows arrive
smoothly, live briefly, and hash uniformly. None of the flow-table
failure modes the streaming tier must survive show up there. This module
generates the ones that do (each an adversarial pattern from the
in-network-classification literature — pForest's churn analysis,
Jaqen/ddos-aware sketches):

  ``ddos_flood``       a burst of single-use flows converging on one
                       victim: every attack packet claims a fresh bucket,
                       churning the table through admission/eviction and
                       starving long-lived benign flows of their slots.
  ``collision_storm``  the flood aimed at the *hash*: attack 5-tuples are
                       rejection-sampled until they land in a handful of
                       target buckets, so a few registers absorb
                       thousands of flows — per-bucket aliasing the
                       uniform-hash assumption hides.
  ``slow_loris``       few flows, long idle gaps between probes: a
                       timeout-based eviction sweep forgets the flow
                       between every pair of packets (aging false
                       positives — each probe reads out as a fresh
                       one-packet flow).
  ``elephant_mice``    heavy per-flow skew: a few elephants carry
                       thousands of packets (per-bucket hot spots
                       pressing the 2^24 count envelope) over a sea of
                       two-packet mice.

Every generator composes its attack with a ``synth_trace`` background
(same class-conditional statistics the models train on) via
``merge_traces``, returns a plain ``PacketTrace`` (attack flows labeled
1), and is fully seeded — identical seeds replay identical traces, the
reproducibility contract of the reference's scenario bench. Per-packet
ground truth is ``trace.flow_label[trace.flow_id]`` as everywhere else.
"""

from __future__ import annotations

import numpy as np

from repro_torch.netsim.features import fnv1a_hash_np
from repro_torch.netsim.packets import PacketTrace, synth_trace

SCENARIOS = ("ddos_flood", "collision_storm", "slow_loris",
             "elephant_mice")


def merge_traces(a: PacketTrace, b: PacketTrace) -> PacketTrace:
    """Interleave two traces by timestamp (stable) into one.

    ``b``'s flow ids are offset past ``a``'s so the concatenated
    ``flow_label`` stays a valid per-flow table; per-packet labels
    (``flow_label[flow_id]``) are preserved exactly.
    """
    order = np.argsort(np.concatenate([a.ts, b.ts]), kind="stable")
    cat = lambda f: np.concatenate([getattr(a, f),
                                    getattr(b, f)])[order]
    flow_id = np.concatenate([a.flow_id,
                              b.flow_id + a.n_flows]).astype(np.int32)
    return PacketTrace(
        ts=cat("ts"), src_ip=cat("src_ip"), dst_ip=cat("dst_ip"),
        sport=cat("sport"), dport=cat("dport"), proto=cat("proto"),
        length=cat("length"), direction=cat("direction"),
        flow_id=flow_id[order],
        flow_label=np.concatenate([a.flow_label,
                                   b.flow_label]).astype(np.int32))


def _attack_packets(rng, flow_id: np.ndarray, ts: np.ndarray, src_ip,
                    dst_ip, sport, dport, proto, label,
                    mean_len: float = 120.0) -> PacketTrace:
    """Assemble per-packet arrays for an attack flow set (time-sorted)."""
    order = np.argsort(ts, kind="stable")
    length = np.clip(rng.normal(mean_len, 40, len(flow_id)),
                     64, 1500).astype(np.uint16)
    direction = (rng.random(len(flow_id)) < 0.1).astype(np.uint8)
    return PacketTrace(
        ts=ts[order].astype(np.float64),
        src_ip=src_ip[flow_id][order], dst_ip=dst_ip[flow_id][order],
        sport=sport[flow_id][order], dport=dport[flow_id][order],
        proto=proto[flow_id][order], length=length[order],
        direction=direction[order],
        flow_id=flow_id[order].astype(np.int32),
        flow_label=np.asarray(label, np.int32))


def ddos_flood(*, n_background: int = 300, n_attack: int = 3000,
               pkts_per_attack: int = 1, attack_start: float = 20.0,
               attack_dur: float = 10.0, seed: int = 0) -> PacketTrace:
    """Burst of single-use flows converging on one victim.

    Each attack flow sends ``pkts_per_attack`` packets (default 1 — the
    spoofed-source SYN-flood shape) inside the ``attack_dur`` burst, from
    a unique random source, so every packet claims a fresh flow bucket:
    maximum admission churn, the workload timeout eviction handles worst
    (too-short ages churn live flows out with the flood; too-long ages
    let dead attack buckets squat).
    """
    bg = synth_trace(n_flows=n_background, seed=seed)
    rng = np.random.default_rng(seed + 0x9E37)
    src = rng.integers(0, 2 ** 32, n_attack, dtype=np.uint32)
    dst = np.full(n_attack, rng.integers(0, 2 ** 32, dtype=np.uint32),
                  dtype=np.uint32)                    # one victim
    sport = rng.integers(1024, 65535, n_attack).astype(np.uint16)
    dport = np.full(n_attack, 80, np.uint16)
    proto = np.full(n_attack, 6, np.uint8)
    flow_id = np.repeat(np.arange(n_attack, dtype=np.int32),
                        pkts_per_attack)
    ts = attack_start + rng.uniform(0, attack_dur, len(flow_id))
    atk = _attack_packets(rng, flow_id, ts, src, dst, sport, dport, proto,
                          np.ones(n_attack, np.int32))
    return merge_traces(bg, atk)


def collision_storm(*, n_background: int = 300, n_attack: int = 2000,
                    n_buckets: int = 4096, n_target_buckets: int = 4,
                    pkts_per_attack: int = 2, attack_start: float = 20.0,
                    attack_dur: float = 10.0, seed: int = 0) -> PacketTrace:
    """The flood aimed at the hash: thousands of flows, a handful of
    buckets.

    Attack 5-tuples are rejection-sampled against the FNV-1a hash the
    serving tiers use (``fnv1a_hash_np``, on the host) until they land in
    ``n_target_buckets`` chosen buckets — the crafted-collision attack a
    public hash invites. The targeted registers aggregate thousands of
    unrelated flows (feature garbage in, prediction garbage out for
    anything sharing the bucket) while the rest of the table stays idle,
    so occupancy-triggered defenses never fire. ``n_buckets`` must match the serving table for
    the collisions to land.
    """
    bg = synth_trace(n_flows=n_background, seed=seed)
    rng = np.random.default_rng(seed + 0x517C)
    targets = rng.choice(n_buckets, n_target_buckets, replace=False)
    keep_src = []
    keep_sport = []
    dst = rng.integers(0, 2 ** 32, dtype=np.uint32)
    need = n_attack
    while need > 0:
        # vectorized rejection sampling: acceptance is
        # n_target_buckets/n_buckets, so draw generously per round
        m = max(64 * 1024, need * (n_buckets // n_target_buckets) * 2)
        s = rng.integers(0, 2 ** 32, m, dtype=np.uint32)
        sp = rng.integers(1024, 65535, m).astype(np.uint16)
        b = fnv1a_hash_np(
            s, np.full(m, dst, np.uint32), sp, np.full(m, 80, np.uint16),
            np.full(m, 6, np.uint8), n_buckets=n_buckets)
        hit = np.isin(b, targets)
        keep_src.append(s[hit][:need])
        keep_sport.append(sp[hit][:need])
        need -= len(keep_src[-1])
    src = np.concatenate(keep_src)
    sport = np.concatenate(keep_sport)
    dsts = np.full(n_attack, dst, np.uint32)
    dport = np.full(n_attack, 80, np.uint16)
    proto = np.full(n_attack, 6, np.uint8)
    flow_id = np.repeat(np.arange(n_attack, dtype=np.int32),
                        pkts_per_attack)
    ts = attack_start + rng.uniform(0, attack_dur, len(flow_id))
    atk = _attack_packets(rng, flow_id, ts, src, dsts, sport, dport, proto,
                          np.ones(n_attack, np.int32))
    return merge_traces(bg, atk)


def slow_loris(*, n_background: int = 300, n_slow: int = 64,
               n_probes: int = 8, idle_gap: float = 30.0,
               seed: int = 0) -> PacketTrace:
    """Few flows, long-idle probes: the aging sweep's false-positive bait.

    Each slow flow sends ``n_probes`` small packets ``idle_gap`` seconds
    apart — idle far longer than any reasonable eviction age, so a
    timeout sweep evicts the flow between every pair of probes and each
    probe reads out as a fresh one-packet flow (the per-flow features the
    classifier needs never accumulate). The background keeps its normal
    pace; total span is ``n_probes * idle_gap`` seconds.
    """
    bg = synth_trace(n_flows=n_background, seed=seed)
    rng = np.random.default_rng(seed + 0x10F1)
    src = rng.integers(0, 2 ** 32, n_slow, dtype=np.uint32)
    dst = rng.integers(0, 2 ** 32, n_slow, dtype=np.uint32)
    sport = rng.integers(1024, 65535, n_slow).astype(np.uint16)
    dport = np.full(n_slow, 80, np.uint16)
    proto = np.full(n_slow, 6, np.uint8)
    flow_id = np.repeat(np.arange(n_slow, dtype=np.int32), n_probes)
    probe = np.tile(np.arange(n_probes, dtype=np.float64), n_slow)
    jitter = rng.uniform(0, 0.2, len(flow_id))
    ts = rng.uniform(0, idle_gap, n_slow)[flow_id] \
        + probe * idle_gap + jitter
    atk = _attack_packets(rng, flow_id, ts, src, dst, sport, dport, proto,
                          np.ones(n_slow, np.int32), mean_len=80.0)
    return merge_traces(bg, atk)


def elephant_mice(*, n_mice: int = 1000, n_elephants: int = 8,
                  elephant_pkts: int = 2000, duration: float = 60.0,
                  seed: int = 0) -> PacketTrace:
    """Heavy-tail skew: a few elephants over a sea of mice.

    The elephants (labeled anomalous — exfiltration-shaped bulk flows)
    each carry ``elephant_pkts`` packets across the whole trace span:
    per-bucket hot spots whose count registers grow ~1000x faster than
    any mouse's, pressing toward the 2^24 saturation envelope and making
    their buckets permanent residents no idle-based sweep can recycle.
    The mice are the plain ``synth_trace`` background.
    """
    bg = synth_trace(n_flows=n_mice, seed=seed)
    rng = np.random.default_rng(seed + 0xE1E0)
    src = rng.integers(0, 2 ** 32, n_elephants, dtype=np.uint32)
    dst = rng.integers(0, 2 ** 32, n_elephants, dtype=np.uint32)
    sport = rng.integers(1024, 65535, n_elephants).astype(np.uint16)
    dport = np.full(n_elephants, 443, np.uint16)
    proto = np.full(n_elephants, 6, np.uint8)
    flow_id = np.repeat(np.arange(n_elephants, dtype=np.int32),
                        elephant_pkts)
    ts = rng.uniform(0, duration, len(flow_id))
    atk = _attack_packets(rng, flow_id, ts, src, dst, sport, dport, proto,
                          np.ones(n_elephants, np.int32), mean_len=1400.0)
    return merge_traces(bg, atk)


SCENARIO_FNS = {
    "ddos_flood": ddos_flood,
    "collision_storm": collision_storm,
    "slow_loris": slow_loris,
    "elephant_mice": elephant_mice,
}


def make_scenario(name: str, **kw) -> PacketTrace:
    """Generate a named adversarial scenario (see ``SCENARIOS``)."""
    if name not in SCENARIO_FNS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"expected one of {SCENARIOS}")
    return SCENARIO_FNS[name](**kw)
