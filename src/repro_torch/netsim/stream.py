"""Streaming flow-table tier: per-flow registers updated window by window.

Port of ``repro/netsim/stream.py``. The paper's challenge (ii) is
extracting features *on the data plane*, where packets arrive continuously
and per-flow registers are updated incrementally:

  register file   -> ``FlowTableState``: the stacked (8, N) register file
                     (pkt/byte counts, first/last ts, fwd/rev splits), one
                     row per register in ``REGISTER_FIELDS`` order, with a
                     named view per register
  per-packet ALU  -> ``window_update_readout``: the window folded into the
                     registers, clamped, read out as feature rows and its
                     newly saturated slots counted in one kernel call
                     (``kernels.stream_update.stream_update_features``, B5)
                     on the card; ``update_flow_table`` is the plain
                     composition
  aging sweep     -> ``age_out`` / ``approx_lru_sweep`` through the masked
                     reset ``kernels.ops.evict_fill`` (B6); on the serving
                     step, the whole timeout sweep in one call
                     (``kernels.ops.timeout_sweep``, B6's second entry)
  register readout-> ``flow_table_readout``: the same 8 feature columns as
                     the one-shot ``features.flow_features``
  recirculation   -> ``iter_windows``: fixed-size packet windows, the final
                     one padded with invalid lanes; ``iter_chunks``: K
                     windows stacked into one (K, W) ``PacketChunk``, which
                     ``chunk_update_readout`` folds in order

Bit-consistency contract (the reference's, held by the tests): streaming
over W windows reproduces the batch ``flow_features`` table bit for bit,
because count/byte registers are integer-valued f32 sums (exact in any
order below 2^24), first/last timestamps are min/max, and duration and
mean IAT are derived at readout by the shared
``features.table_from_registers``. Timestamps are rebased to the stream
epoch ``t0`` in float64 on the host before the f32 cast; ``t0`` defaults
to the trace's minimum timestamp.

The register file lives in one (8, N) tensor so the kernel can update it
in place: on the card ``window_update_readout`` consumes the state it is
given, and callers keep only the state it returns (the reference's
donation contract).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import on_kernel_path, resolve_device
from repro_torch.kernels.evict import evict_cutoff
from repro_torch.kernels.ops import evict_fill, timeout_sweep
from repro_torch.kernels.stream_update import (stream_update_features,
                                               stream_update_ref)
from repro_torch.netsim.features import (fnv1a_hash, fnv1a_hash_np,
                                         rebase_ts_np, table_from_registers)

FLOW_FEATURES = 8      # columns of the readout table == features.flow_features

# f32 integer-exactness envelope: count/byte registers are integer-valued
# f32 sums, exact only below 2^24. saturate_counts clamps here.
OVERFLOW_LIMIT = float(1 << 24)

# per-register init/evict identities, in FlowTableState row order
REGISTER_FIELDS = ("pkt_count", "byte_count", "t_min", "t_max",
                   "fwd_pkts", "rev_pkts", "fwd_bytes", "rev_bytes")
EVICT_FILLS = (0.0, 0.0, float("inf"), float("-inf"), 0.0, 0.0, 0.0, 0.0)
# registers under the 2^24 envelope (monotone f32 integer accumulators)
COUNT_FIELDS = ("pkt_count", "byte_count", "fwd_pkts", "rev_pkts",
                "fwd_bytes", "rev_bytes")
# the count registers as two row slices of the stacked file (rows 0-1, 4-7):
# slices, not an index list, so no index tensor crosses to the device
_COUNT_SLICES = (slice(0, 2), slice(4, 8))

# approx-LRU defaults: 2-bit age counters (pForest's choice) ranked by a
# 2-bit activity class — 16 score levels total
LRU_AGE_BITS = 2
LRU_ACT_BITS = 2

EVICT_POLICIES = ("timeout", "approx_lru")


def _row(i: int, name: str):
    return property(lambda self: self.regs[i],
                    doc=f"The {name} register row, a view of ``regs``.")


@dataclasses.dataclass
class FlowTableState:
    """The register file: ``regs`` (8, N) f32, one row per switch register
    in ``REGISTER_FIELDS`` order, each also readable by name (a view).

    t_min/t_max start at the min/max identities (+-inf) so an untouched
    bucket reads out exactly like one the batch path never saw.
    """
    regs: torch.Tensor

    pkt_count = _row(0, "pkt_count")
    byte_count = _row(1, "byte_count")
    t_min = _row(2, "t_min")
    t_max = _row(3, "t_max")
    fwd_pkts = _row(4, "fwd_pkts")
    rev_pkts = _row(5, "rev_pkts")
    fwd_bytes = _row(6, "fwd_bytes")
    rev_bytes = _row(7, "rev_bytes")

    @property
    def n_buckets(self) -> int:
        return self.regs.shape[1]

    def clone(self) -> "FlowTableState":
        return FlowTableState(self.regs.clone())

    def copy_(self, other: "FlowTableState") -> "FlowTableState":
        """Write ``other``'s registers into this file in place. Returns
        self."""
        self.regs.copy_(other.regs)
        return self


@dataclasses.dataclass
class PacketWindow:
    """One fixed-size chunk of the packet stream.

    ts is rebased f32 (see module docstring); is_fwd is 1.0 for forward
    direction; valid masks tile-pad lanes out of every register update.
    """
    bucket: torch.Tensor    # (W,) int32 flow-hash bucket ids
    ts: torch.Tensor        # (W,) f32 rebased seconds
    length: torch.Tensor    # (W,) f32 packet bytes
    is_fwd: torch.Tensor    # (W,) f32 1.0 = forward
    valid: torch.Tensor     # (W,) bool

    @property
    def size(self) -> int:
        return self.bucket.shape[0]


def init_flow_table(n_buckets: int, *, device=None) -> FlowTableState:
    """A fresh register file on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    regs = torch.zeros((len(REGISTER_FIELDS), n_buckets), dtype=torch.float32,
                       device=dev)
    regs[2].fill_(float("inf"))
    regs[3].fill_(float("-inf"))
    return FlowTableState(regs)


def flow_table_from_arrays(arrays, *, device=None) -> FlowTableState:
    """A register file from host arrays: a mapping with one (N,) array per
    name of ``REGISTER_FIELDS`` (how the reference's ``FlowTableState``
    crosses over). device=None: CUDA."""
    regs = np.stack([np.asarray(arrays[f], np.float32)
                     for f in REGISTER_FIELDS])
    return FlowTableState(torch.as_tensor(regs, device=resolve_device(device)))


def packet_window_from_arrays(bucket, ts, length, is_fwd, valid, *,
                              device=None) -> PacketWindow:
    """A window from host arrays (how the reference's ``PacketWindow``
    crosses over). device=None: CUDA."""
    dev = resolve_device(device)
    col = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
    return PacketWindow(bucket=col(bucket, np.int32), ts=col(ts, np.float32),
                        length=col(length, np.float32),
                        is_fwd=col(is_fwd, np.float32),
                        valid=col(valid, np.bool_))


def update_flow_table(state: FlowTableState,
                      window: PacketWindow) -> FlowTableState:
    """Fold one window into the register file (plain composition; returns a
    new state and leaves ``state`` as it was).

    Sums are masked scatter-adds into the carry (an invalid lane adds
    exactly 0.0, a bitwise no-op on the non-negative count registers);
    first/last ts ride scatter-min/max with invalid lanes pinned to the
    identities. Bit-identical to the batch reductions in any order while
    the counts stay below 2^24. Bucket ids must lie in [0, N).
    """
    b = window.bucket.long()
    w = window.valid.to(torch.float32)
    inf = float("inf")
    ln, fwd = window.length, window.is_fwd
    regs = state.regs.clone()

    def add(i, v):
        regs[i].index_add_(0, b, v)

    add(0, w)
    add(1, ln * w)
    regs[2].scatter_reduce_(0, b, torch.where(window.valid, window.ts, inf),
                            "amin", include_self=True)
    regs[3].scatter_reduce_(0, b, torch.where(window.valid, window.ts, -inf),
                            "amax", include_self=True)
    add(4, fwd * w)
    add(5, (1.0 - fwd) * w)
    add(6, ln * fwd * w)
    add(7, ln * (1.0 - fwd) * w)
    return FlowTableState(regs)


_FILLS: dict = {}


def evict_fills(device) -> torch.Tensor:
    """``EVICT_FILLS`` as an (8,) f32 tensor on ``device``, built once per
    device and shared (read it, never write it). It is written on the
    device itself, with no host-to-device copy, so a serving step stays
    free of host syncs; one built while a CUDA graph is being captured
    belongs to that graph and is not kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    fills = _FILLS.get(dev)
    if fills is None:
        fills = torch.zeros(len(EVICT_FILLS), dtype=torch.float32, device=dev)
        fills[2:3].fill_(float("inf"))
        fills[3:4].fill_(float("-inf"))
        if not (dev.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _FILLS[dev] = fills
    return fills


def _reset(state: FlowTableState, evict: torch.Tensor, use_kernel) -> tuple:
    out = evict_fill(state.regs, evict, evict_fills(state.regs.device),
                     use_kernel=use_kernel)
    return FlowTableState(out), evict.sum(dtype=torch.int32)


def age_out(state: FlowTableState, evict_before, *,
            use_kernel: Optional[bool] = None) -> tuple:
    """LRU/timeout eviction sweep: recycle buckets idle too long.

    A bucket whose last-seen timestamp (t_max) predates ``evict_before``
    is reset to the init identities, bit-identical to a bucket the stream
    never touched; surviving buckets pass through bit for bit. The reset
    rides ``kernels.ops.evict_fill`` (B6). Returns (state, n_evicted i32).
    """
    evict = (state.pkt_count > 0) & (state.t_max < evict_before)
    return _reset(state, evict, use_kernel)


def saturate_counts(state: FlowTableState, *, limit: float = OVERFLOW_LIMIT,
                    prev: Optional[FlowTableState] = None) -> tuple:
    """Overflow guard for the f32 integer-exactness envelope.

    Clamps the count registers at ``limit`` (a bitwise no-op for every
    in-envelope register) and counts the register slots *newly* saturated:
    with ``prev`` (the register file at the start of the window) a slot
    counts iff it reached the limit now and was below it then; without
    ``prev``, slots strictly above the limit count. Returns (state,
    n_newly_saturated i32).
    """
    lim = float(np.float32(limit))
    regs = state.regs.clone()
    for sl in _COUNT_SLICES:
        regs[sl] = torch.clamp(state.regs[sl], max=lim)
    if prev is not None:
        return FlowTableState(regs), _newly_saturated(prev.regs, state.regs,
                                                      lim)
    n = [(state.regs[sl] > lim).sum(dtype=torch.int32)
         for sl in _COUNT_SLICES]
    return FlowTableState(regs), n[0] + n[1]


def _newly_saturated(before: torch.Tensor, after: torch.Tensor,
                     lim: float) -> torch.Tensor:
    """The count register slots of two (8, N) register files at or above
    ``lim`` in ``after`` and below it in ``before``. -> an int32 scalar."""
    n = [((after[sl] >= lim) & (before[sl] < lim)).sum(dtype=torch.int32)
         for sl in _COUNT_SLICES]
    return n[0] + n[1]


def _age_classes(idle: torch.Tensor, evict_age: float, top_age: int):
    """floor(idle / period) as the reference computes it under ``jax.jit``:
    ``period`` is a constant there, and XLA turns the division into a
    product with its float32 reciprocal, which can round to another class
    than a true division."""
    period = np.float32(evict_age) / np.float32(top_age)
    return torch.floor(idle * float(np.float32(1.0) / period))


def approx_lru_sweep(state: FlowTableState, w: PacketWindow,
                     evict_age: float, *, occupancy: float = 0.75,
                     age_bits: int = LRU_AGE_BITS,
                     act_bits: int = LRU_ACT_BITS,
                     use_kernel: Optional[bool] = None) -> tuple:
    """pForest-style approx-LRU eviction: multi-bit age counters ranked by
    activity, swept only under occupancy pressure.

    age class = idle time quantized into ``2**age_bits`` levels (a flow
    idle >= ``evict_age`` sits in the top class); activity =
    ``log2(pkt_count + 1)`` clipped to ``2**act_bits`` classes; score =
    oldest-then-smallest first. Nothing is evicted while occupancy is at or
    below ``occupancy``; above it, every bucket at or above the smallest
    score threshold whose classes cover the excess is recycled. Flows seen
    in this window are never evicted, and an all-invalid window sweeps
    nothing. The reset rides ``kernels.ops.evict_fill`` (B6). Returns
    (state, n_evicted i32).
    """
    n = state.n_buckets
    dev = state.regs.device
    n_scores = 1 << (age_bits + act_bits)
    top_age = (1 << age_bits) - 1
    top_act = float((1 << act_bits) - 1)
    inf = float("inf")
    now = torch.where(w.valid, w.ts, -inf).max()
    w_min = torch.where(w.valid, w.ts, inf).min()
    occupied = state.pkt_count > 0
    n_occ = occupied.sum(dtype=torch.int32)
    high = int(occupancy * n)
    pressure = w.valid.any() & (n_occ > high)
    # age/activity classes in float (inf-safe), cast after the clip
    idle = torch.clamp(now - state.t_max, min=0.0)
    age_cls = torch.clamp(_age_classes(idle, evict_age, top_age),
                          0.0, float(top_age))
    act_cls = torch.clamp(torch.floor(torch.log2(state.pkt_count + 1.0)),
                          0.0, top_act)
    score = (age_cls * (top_act + 1.0) + (top_act - act_cls)).to(torch.int32)
    protected = state.t_max >= w_min          # seen this window: survives
    eligible = occupied & ~protected
    score = torch.where(eligible, score, -1)
    # smallest threshold whose classes cover the occupancy excess
    n_target = n_occ - high
    s = torch.arange(n_scores, dtype=torch.int32, device=dev)
    counts = (score[None, :] == s[:, None]).sum(dim=1, dtype=torch.int32)
    cum = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
    ok = cum >= n_target                      # cum[k] = #(score >= k)
    thr = torch.where(ok.any(), torch.where(ok, s, -1).max(), 0)
    evict = eligible & (score >= thr) & pressure
    return _reset(state, evict, use_kernel)


def lifecycle_sweep(state: FlowTableState, w: PacketWindow,
                    evict_age: Optional[float], saturate: bool,
                    prev: Optional[FlowTableState] = None, *,
                    evict_policy: str = "timeout",
                    lru_occupancy: float = 0.75,
                    use_kernel: Optional[bool] = None) -> tuple:
    """Aging sweep + overflow guard for one served window.

    ``evict_policy="timeout"`` evicts buckets idle since before
    ``evict_cutoff``; ``"approx_lru"`` runs the pressure-triggered sweep
    (``lru_occupancy`` is its high-water fraction). ``prev`` (the register
    file before this window's update) lets the overflow guard count only
    newly saturated slots. Returns (state, n_evicted, n_overflow), both
    counters zero when the feature is off.
    """
    dev = state.regs.device
    n_ev = torch.zeros((), dtype=torch.int32, device=dev)
    n_ov = torch.zeros((), dtype=torch.int32, device=dev)
    if evict_policy not in EVICT_POLICIES:
        raise ValueError(f"evict_policy must be one of {EVICT_POLICIES}, "
                         f"got {evict_policy!r}")
    if evict_age is not None:
        if evict_policy == "approx_lru":
            state, n_ev = approx_lru_sweep(state, w, evict_age,
                                           occupancy=lru_occupancy,
                                           use_kernel=use_kernel)
        else:
            state, n_ev = age_out(state,
                                  evict_cutoff(w.ts, w.valid, evict_age),
                                  use_kernel=use_kernel)
    if saturate:
        state, n_ov = saturate_counts(state, prev=prev)
    return state, n_ev, n_ov


def flow_table_readout(state: FlowTableState,
                       bucket: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Feature table from the registers — same columns as flow_features.

    bucket=None reads out every bucket -> (n_buckets, 8). Passing bucket
    ids gathers the register rows first and derives features on the
    gathered rows -> (len(bucket), 8), bit-identical (the derivation is
    elementwise).
    """
    regs = state.regs if bucket is None else state.regs[:, bucket.long()]
    return table_from_registers(*regs)


def window_update_readout(state: FlowTableState, w: PacketWindow, *,
                          evict_age: Optional[float] = None,
                          saturate: bool = True,
                          evict_policy: str = "timeout",
                          lru_occupancy: float = 0.75,
                          use_kernel: Optional[bool] = None,
                          sweep: Optional[PacketWindow] = None) -> tuple:
    """Fold one window and read out its touched-flow feature rows.

    The serving step's register half: update -> aging sweep -> overflow
    guard -> touched-row readout, returning ``(state, x (W, 8), n_evicted,
    n_overflow)``. By default it is ``chunk_update_readout``'s kernel route
    on a chunk of one window: the scatter-update, the 2^24 clamp, the
    guard's count and the feature rows in one B5 launch (on the card it
    updates ``state.regs`` in place: keep only the returned state), and the
    timeout sweep in one B6 launch (``kernels.ops.timeout_sweep``, which
    finds the cutoff, resets the evicted columns and counts them, in place
    on the register file B5 has just updated). The approx-LRU sweep resets
    through B6's mask-taking entry, out of place. use_kernel=False runs the
    plain composition (``update_flow_table``, ``lifecycle_sweep``, the
    gather) on either device.

    ``sweep`` is the window whose timestamps and valid lanes the aging sweep
    reads (its cutoff, its clock and its protection), ``w`` by default. The
    sharded tier folds a shard's localized window (its own lanes valid, its
    local bucket ids) and sweeps with the full one, so every shard cuts off
    where a single device would. The two routes are bit-identical because

      * eviction cannot touch this window's rows (the cutoff is clamped to
        the window minimum, the approx-LRU sweep protects flows seen this
        window), so reading the rows before the sweep reads the same bits;
      * the clamp already landed in the kernel and commutes with eviction
        (the fills are in the envelope), and only this window's columns can
        newly saturate: the others keep their bits or are reset below the
        limit. So the guard's count, taken as B5 settles the register file
        before the sweep, is the plain route's count after it.
    """
    if use_kernel is False:
        prev = state
        state = update_flow_table(state, w)
        state, n_ev, n_ov = lifecycle_sweep(
            state, w if sweep is None else sweep, evict_age, saturate,
            prev=prev, evict_policy=evict_policy,
            lru_occupancy=lru_occupancy, use_kernel=False)
        return state, flow_table_readout(state, w.bucket), n_ev, n_ov
    state, xs, n_ev, n_ov = chunk_update_readout(
        state, _one_window_chunk(w), evict_age=evict_age, saturate=saturate,
        evict_policy=evict_policy, lru_occupancy=lru_occupancy,
        sweep=None if sweep is None else _one_window_chunk(sweep))
    return state, xs[0], n_ev, n_ov


def _fold_readout(regs: torch.Tensor, w: PacketWindow, x: torch.Tensor,
                  n_over: Optional[torch.Tensor]) -> torch.Tensor:
    """B5 on window ``w``: fold it into ``regs``, write its lanes' feature
    rows into ``x`` (W, 8) and, with ``n_over`` (an int32 scalar; None
    leaves the clamp off), clamp the count registers at the 2^24 envelope
    and add the slots newly saturated into it. On the card one launch of
    B5's feature-row mode, in place; on the CPU its plain version:
    ``stream_update_ref``, ``table_from_registers`` on its rows and the
    count over the whole file. -> the register file."""
    limit = None if n_over is None else OVERFLOW_LIMIT
    if on_kernel_path(regs):
        return stream_update_features(regs, w.bucket, w.ts, w.length,
                                      w.is_fwd, w.valid, x, limit=limit,
                                      n_over=n_over)
    new, rows = stream_update_ref(regs, w.bucket, w.ts, w.length, w.is_fwd,
                                  w.valid, limit=limit)
    x.copy_(table_from_registers(*rows))
    if n_over is not None:
        n_over += _newly_saturated(regs, new, float(np.float32(limit)))
    return new


def _register_half(state: FlowTableState, w: PacketWindow, x: torch.Tensor,
                   counts: torch.Tensor, *, evict_age, saturate,
                   evict_policy, lru_occupancy,
                   sweep: PacketWindow) -> FlowTableState:
    """One window of ``chunk_update_readout``'s kernel route: B5 on ``w``
    (its feature rows into ``x``, the guard's count into ``counts[1]``),
    then the aging sweep on ``sweep`` (its count into ``counts[0]``).
    ``counts`` is the window's (2,) int32 column of the chunk's counters,
    zero where a feature is off. -> the state."""
    regs = _fold_readout(state.regs, w, x, counts[1] if saturate else None)
    if evict_age is None:
        return FlowTableState(regs)
    if evict_policy == "timeout":
        # the register file is this step's own: the sweep works in place
        regs, _ = timeout_sweep(regs, sweep.ts, sweep.valid, evict_age,
                                evict_fills(regs.device), out=counts[0])
        return FlowTableState(regs)
    state, n_ev, _ = lifecycle_sweep(
        FlowTableState(regs), sweep, evict_age, False,
        evict_policy=evict_policy, lru_occupancy=lru_occupancy)
    counts[0].copy_(n_ev)
    return state


@dataclasses.dataclass
class PacketChunk:
    """K windows stacked into one (K, W) transfer.

    Row k is exactly the ``PacketWindow`` the per-window path would have
    seen (the bit-equality contract of chunked serving depends on it). A
    ragged final chunk is padded with *dead* windows, every lane invalid,
    which fold nothing into the registers, dispatch nothing and report -1
    on every lane.
    """
    bucket: torch.Tensor    # (K, W) int32 flow-hash bucket ids
    ts: torch.Tensor        # (K, W) f32 rebased seconds
    length: torch.Tensor    # (K, W) f32 packet bytes
    is_fwd: torch.Tensor    # (K, W) f32 1.0 = forward
    valid: torch.Tensor     # (K, W) bool (an all-False row: a dead window)

    @property
    def n_windows(self) -> int:
        return self.bucket.shape[0]

    @property
    def window(self) -> int:
        return self.bucket.shape[1]

    def window_at(self, k: int) -> PacketWindow:
        """Row k as a ``PacketWindow`` (views of the chunk's rows)."""
        return PacketWindow(bucket=self.bucket[k], ts=self.ts[k],
                            length=self.length[k], is_fwd=self.is_fwd[k],
                            valid=self.valid[k])


def _one_window_chunk(w: PacketWindow) -> PacketChunk:
    """A window as a chunk of one (views of its columns)."""
    return PacketChunk(bucket=w.bucket[None], ts=w.ts[None],
                       length=w.length[None], is_fwd=w.is_fwd[None],
                       valid=w.valid[None])


def packet_chunk_from_arrays(bucket, ts, length, is_fwd, valid, *,
                             device=None) -> PacketChunk:
    """A chunk from host (K, W) arrays (how the reference's ``PacketChunk``
    crosses over). device=None: CUDA."""
    w = packet_window_from_arrays(bucket, ts, length, is_fwd, valid,
                                  device=device)
    return PacketChunk(bucket=w.bucket, ts=w.ts, length=w.length,
                       is_fwd=w.is_fwd, valid=w.valid)


def chunk_update_readout(state: FlowTableState, chunk: PacketChunk, *,
                         evict_age: Optional[float] = None,
                         saturate: bool = True,
                         evict_policy: str = "timeout",
                         lru_occupancy: float = 0.75,
                         use_kernel: Optional[bool] = None,
                         sweep: Optional[PacketChunk] = None) -> tuple:
    """Whole-chunk register half: fold the chunk's K windows in order.

    Returns ``(state, xs (K, W, 8), n_evicted, n_overflow)``, bit-identical
    to K ``window_update_readout`` steps: each window's readout rows as
    they stood after its own fold and sweep, and the counts summed over the
    chunk. Everything row-wise (classify, dispatch) runs on the stacked rows
    after this returns.

    By default (the counterpart of the reference's Pallas branch) each
    window is one launch of B5 in its feature-row mode, in place, which
    folds the window, clamps, counts the slots it newly saturated and
    writes the window's feature rows straight into ``xs[k]``, then, when
    ``evict_age`` is set, one of B6's timeout sweep, in place. Both counts
    land in one (2, K) int32 tensor, zeroed once a chunk (B6 writes row 0,
    B5 adds into row 1), summed once at the end. On a CUDA tensor the
    register half is then K launches of B5 and K of the sweep, in window
    order, a zero fill and a sum: keep only the returned state. A CPU
    tensor runs the same loop through B5's plain version and the count's
    plain form. use_kernel=False loops the plain window step instead. The
    reference's plain route packs the registers into (N, 6)/(N, 2) arrays
    for its scan; this register file stays the stacked (8, N) one, which
    binds the result no more than the TPU layout does. ``sweep``: the chunk
    whose windows the aging sweeps read, row by row
    (``window_update_readout``'s ``sweep``; default ``chunk``).
    """
    if evict_policy not in EVICT_POLICIES:
        raise ValueError(f"evict_policy must be one of {EVICT_POLICIES}, "
                         f"got {evict_policy!r}")
    k, w_lanes = chunk.bucket.shape
    if sweep is None:
        sweep = chunk
    dev = state.regs.device
    kw = dict(evict_age=evict_age, saturate=saturate,
              evict_policy=evict_policy, lru_occupancy=lru_occupancy)
    if use_kernel is False:
        n_ev = torch.zeros((), dtype=torch.int32, device=dev)
        n_ov = torch.zeros((), dtype=torch.int32, device=dev)
        xs = []
        for i in range(k):
            state, x, ev, ov = window_update_readout(
                state, chunk.window_at(i), use_kernel=False,
                sweep=sweep.window_at(i), **kw)
            xs.append(x)
            n_ev, n_ov = n_ev + ev, n_ov + ov
        return state, torch.stack(xs), n_ev, n_ov
    xs = torch.empty((k, w_lanes, FLOW_FEATURES), dtype=torch.float32,
                     device=dev)
    counts = torch.zeros((2, k), dtype=torch.int32, device=dev)
    for i in range(k):
        state = _register_half(state, chunk.window_at(i), xs[i], counts[:, i],
                               sweep=sweep.window_at(i), **kw)
    n_ev, n_ov = counts.sum(dim=1, dtype=torch.int32)
    return state, xs, n_ev, n_ov


def trace_columns(trace, n_buckets: int, *, t0: Optional[float] = None,
                  bucket=None) -> tuple:
    """Host-side per-packet columns every window iterator shares.
    -> (cols dict of numpy arrays, t0_used).

    Rebasing stays in float64 on the host and the bucket hash is
    elementwise (order-free; ``features.fnv1a_hash_np``, numpy on the
    host), so every consumer presents bit-identical lanes. t0=None latches
    the trace's minimum timestamp.
    """
    ts64 = np.asarray(trace.ts, np.float64)
    if t0 is None:
        t0 = float(ts64.min()) if ts64.size else 0.0
    if bucket is None:
        bucket = fnv1a_hash_np(trace.src_ip, trace.dst_ip, trace.sport,
                               trace.dport, trace.proto, n_buckets=n_buckets)
    if isinstance(bucket, torch.Tensor):
        bucket = bucket.cpu().numpy()
    return dict(bucket=np.asarray(bucket, np.int32),
                ts=rebase_ts_np(ts64, t0),
                length=np.asarray(trace.length, np.float32),
                is_fwd=(np.asarray(trace.direction) == 0)
                .astype(np.float32)), t0


def _pad_columns(cols: dict, n: int, total: int) -> dict:
    """Pad each (n,) column to ``total`` lanes replicating the last packet
    — the same in-distribution discipline as ``kernels.ops.pad_window``,
    applied once to the whole trace instead of per window."""
    if total == n:
        return cols
    return {k: np.concatenate([v, np.repeat(v[n - 1:n], total - n, axis=0)])
            for k, v in cols.items()}


def iter_windows(trace, window: int, n_buckets: int, *,
                 t0: Optional[float] = None, bucket=None, pad: bool = True,
                 device=None) -> Iterator[PacketWindow]:
    """Chunk a PacketTrace into fixed-size PacketWindows on ``device``
    (None: CUDA).

    Each column crosses to the device once; windows are row slices of it.
    t0 is the stream epoch every window rebases against (default: the
    trace's minimum timestamp, the batch path's epoch); pass ``bucket`` to
    reuse an already-computed full-trace hash. pad=True pads the final
    ragged window to ``window`` lanes (valid=False); pad=False leaves it
    short, every lane valid.
    """
    dev = resolve_device(device)
    cols, _ = trace_columns(trace, n_buckets, t0=t0, bucket=bucket)
    n = len(cols["ts"])
    if not n:
        return
    total = -(-n // window) * window if pad else n
    cols = _pad_columns(cols, n, total)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in cols.items()}
    valid = torch.arange(total, device=dev) < n
    for s in range(0, total, window):
        sl = slice(s, s + window)
        yield PacketWindow(valid=valid[sl],
                           **{k: v[sl] for k, v in on_dev.items()})


def pack_chunk_columns(cols: dict, n: int, window: int, rows: int) -> tuple:
    """Pack ``n`` packets of host columns into ``rows`` windows of
    ``window`` lanes. -> (full_cols, valid) as flat (rows*window,) numpy
    arrays.

    The single padding rule of the chunk iterators: the ragged final *live*
    window replicates the last packet (valid=False on the pad lanes), and
    every window beyond the live ones is *dead*: all-zero columns, every
    lane invalid, so it folds nothing into the registers, dispatches
    nothing and reports -1 on every lane.
    """
    n_win = -(-n // window) if n else 0
    if n_win > rows:
        raise ValueError(f"{n} packets need {n_win} windows of {window} "
                         f"lanes, only {rows} rows available")
    live = _pad_columns(cols, n, n_win * window)
    full = {k: np.zeros((rows * window,), v.dtype) for k, v in live.items()}
    for k, v in live.items():
        full[k][:n_win * window] = v
    valid = np.zeros((rows * window,), bool)
    valid[:n_win * window] = np.arange(n_win * window) < n
    return full, valid


def iter_chunks(trace, window: int, chunk_windows: int, n_buckets: int, *,
                t0: Optional[float] = None, bucket=None,
                device=None) -> Iterator[PacketChunk]:
    """Stack the trace's windows K at a time into (K, W) PacketChunks on
    ``device`` (None: CUDA).

    Each column crosses to the device once for the whole trace, and a chunk
    is a row-range slice of it. Row k of a chunk equals the k-th
    ``iter_windows`` window bit for bit (the same padding, the same rebase
    against ``t0``, default the trace minimum); the final chunk is padded
    to K rows with dead windows (``pack_chunk_columns``).
    """
    dev = resolve_device(device)
    cols, _ = trace_columns(trace, n_buckets, t0=t0, bucket=bucket)
    n = len(cols["ts"])
    if not n:
        return
    n_win = -(-n // window)
    n_chunks = -(-n_win // chunk_windows)
    rows = n_chunks * chunk_windows
    full, valid = pack_chunk_columns(cols, n, window, rows)
    on_dev = {k: torch.as_tensor(v.reshape(rows, window), device=dev)
              for k, v in full.items()}
    valid = torch.as_tensor(valid.reshape(rows, window), device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk_windows, (c + 1) * chunk_windows)
        yield PacketChunk(valid=valid[sl],
                          **{k: v[sl] for k, v in on_dev.items()})


def stream_flow_features(trace, n_buckets=4096, window=1024, *,
                         t0: Optional[float] = None, device=None):
    """One-shot convenience: stream the whole trace window by window.

    Returns (bucket_ids (P,), flow_table (n_buckets, 8)), bit-consistent
    with ``features.flow_features`` on the same trace (the equivalence
    oracle). t0 overrides the stream epoch (default: the trace minimum).
    """
    dev = resolve_device(device)
    b = fnv1a_hash(trace.src_ip, trace.dst_ip, trace.sport, trace.dport,
                   trace.proto, n_buckets=n_buckets, device=dev)
    state = init_flow_table(n_buckets, device=dev)
    for w in iter_windows(trace, window, n_buckets, bucket=b, t0=t0,
                          device=dev):
        state = update_flow_table(state, w)
    return b, flow_table_readout(state)

