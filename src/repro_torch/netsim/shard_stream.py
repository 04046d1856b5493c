"""Sharded flow-table tier: the register file partitioned across a mesh.

Port of ``repro/netsim/shard_stream.py``. A single device's register file
bounds how many flows the streaming tier tracks; a deployment shards the
table across devices the way a switch banks its SRAM. The buckets are
partitioned over the mesh's 'shard' dim by

    owner(bucket) = bucket % n_shards
    local(bucket) = bucket // n_shards

so global bucket ``b`` lives at column ``b // n_shards`` of shard
``b % n_shards`` (the interleaved layout keeps the hash's bucket spread
even per shard). Where the reference holds every shard's block in one
array with a leading shard dim, each rank here (one process per device,
``distributed.sharding``) holds only its own ``(8, n_local)`` block, in the
port's stacked register layout.

Every shard receives the whole (replicated) window, masks it down to the
packets it owns (``localize_window``) and folds them with the same register
half as the single-device tier (B5, and B6's sweep, on the card): buckets
are independent, so the update itself sends nothing between devices. The
aging sweep reads the *full* window's timestamps and valid lanes, so its
cutoff is the single-device cutoff on every shard. The readout zeroes the
rows of lanes the shard does not own, so the small merges (a sum over
shards) are exact: one real value plus zeros. On in-order traces with the
timeout policy (or no eviction) the sharded tier equals the single-device
tier bit for bit.

Out-of-order arrivals are tolerated: every register is an associative,
order-free reduction and every derived feature an epoch-invariant
difference. The stream's true time origin is the min-merged epoch register
(``ShardedFlowTable.epoch``): the minimum observed rebased timestamp, 0.0
on an in-order stream, negative when the true start came after the host's
provisional latch. Every shard sees every window, so each rank's epoch is
already the merged one; reading it needs no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import all_gather, psum_scatter
from repro_torch.distributed.sharding import (as_flow_mesh, flow_shard_mesh,
                                              mesh_device, mesh_group)
from repro_torch.netsim.features import fnv1a_hash, table_from_registers
from repro_torch.netsim.stream import (REGISTER_FIELDS, FlowTableState,
                                       PacketWindow, init_flow_table,
                                       iter_windows, update_flow_table,
                                       window_update_readout)


@dataclasses.dataclass
class ShardedFlowTable:
    """One rank's part of the register file partitioned over 'shard'.

    ``regs`` is this shard's (8, n_local) block (column j holds global
    bucket ``j * n_shards + shard``); ``epoch`` the 0-dim f32 min-merged
    stream-epoch register (+inf before any packet).
    """
    regs: torch.Tensor
    epoch: torch.Tensor
    n_shards: int
    shard: int

    @property
    def n_local(self) -> int:
        return self.regs.shape[1]

    @property
    def n_buckets(self) -> int:
        return self.regs.shape[1] * self.n_shards

    def clone(self) -> "ShardedFlowTable":
        return dataclasses.replace(self, regs=self.regs.clone(),
                                   epoch=self.epoch.clone())

    def copy_(self, other: "ShardedFlowTable") -> "ShardedFlowTable":
        """Write ``other``'s registers and epoch into these in place (the
        server's carries). Returns self."""
        self.regs.copy_(other.regs)
        self.epoch.copy_(other.epoch)
        return self


def n_local_buckets(n_buckets: int, n_shards: int) -> int:
    if n_buckets % n_shards:
        raise ValueError(f"n_buckets={n_buckets} must divide evenly over "
                         f"{n_shards} shards")
    return n_buckets // n_shards


def init_sharded_table(n_buckets: int, *, mesh=None,
                       n_shards: Optional[int] = None, shard: int = 0,
                       device=None) -> ShardedFlowTable:
    """This rank's fresh block: the single-device init identities (counts
    0, t_min/t_max at +-inf), so an untouched sharded bucket reads out as an
    untouched single-device one. With ``mesh`` the shard count, this rank's
    shard and its device come from the mesh; without, from ``n_shards``,
    ``shard`` and ``device`` (None: CUDA)."""
    if mesh is not None:
        mesh = as_flow_mesh(mesh)
        n_shards, shard = mesh.size(0), mesh.get_local_rank("shard")
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)
    regs = init_flow_table(n_local_buckets(n_buckets, n_shards),
                           device=dev).regs
    epoch = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    return ShardedFlowTable(regs=regs, epoch=epoch, n_shards=n_shards,
                            shard=shard)


def localize_window(w, n_shards: int, shard: int):
    """Mask a replicated window (or chunk) down to one shard's packets.

    -> (local, own): bucket ids remapped to local columns (``b //
    n_shards``, in range for every lane, owned or not) and ``valid``
    restricted to owned lanes, so the single-device register half folds
    exactly the owned packets; ``own`` the lanes' ownership mask."""
    own = (w.bucket % n_shards) == shard
    return dataclasses.replace(w, bucket=w.bucket // n_shards,
                               valid=w.valid & own), own


def window_epoch(w) -> torch.Tensor:
    """The oldest valid timestamp of a window or chunk (+inf when none)."""
    return torch.where(w.valid, w.ts, float("inf")).min()


def shard_window_update(state: FlowTableState, w: PacketWindow,
                        n_shards: int, shard: int, *,
                        evict_age: Optional[float] = None,
                        saturate: bool = True,
                        evict_policy: str = "timeout",
                        lru_occupancy: float = 0.75,
                        use_kernel: Optional[bool] = None) -> tuple:
    """One shard's whole per-window register pass: the localized window
    folded into this shard's block, the aging sweep on the full window,
    the overflow guard at local columns, and the owner-masked readout.

    -> (state, epoch_min, own, x (W, 8), n_evicted, n_overflow), x with
    the rows of lanes this shard does not own zeroed. ``state`` is this
    shard's (8, n_local) block as a ``FlowTableState``; on the card B5 and
    B6's sweep work on it in place (keep only the returned state).

    The timeout sweep keeps the bit-identity contract with the single
    device. ``evict_policy="approx_lru"`` sweeps per shard: occupancy and
    the score histogram are this shard's block's, so each shard defends its
    own slice and the result is NOT a single-device table's.
    """
    local, own = localize_window(w, n_shards, shard)
    state, x, n_ev, n_ov = window_update_readout(
        state, local, evict_age=evict_age, saturate=saturate,
        evict_policy=evict_policy, lru_occupancy=lru_occupancy,
        use_kernel=use_kernel, sweep=w)
    x = torch.where(own[:, None], x, 0.0)
    return state, window_epoch(w), own, x, n_ev, n_ov


def lane_slab_rows(n_lanes: int, n_shards: int, n_data: int = 1) -> int:
    """The per-device lane slab: ceil(n_lanes / (n_shards * n_data)) rows.

    The partitioned classify pads the lane axis to ``T * n_shards * n_data``
    rows so every device owns a slab of one shape whichever shard the
    traffic hashed to: ownership skew moves values between slabs, never
    shapes."""
    return -(-n_lanes // (n_shards * n_data))


def scatter_lane_slab(x: torch.Tensor, mesh) -> torch.Tensor:
    """Owner-masked lane rows -> this device's complete lane slab.

    ``x`` is the (N, F) readout with the rows of lanes this shard does not
    own exactly zero, so the reduce-scatter over 'shard' sums one real row
    plus zeros per lane (the owner's row, bit for bit) and hands shard s
    the block [s*N'/D_s, (s+1)*N'/D_s) of the N' padded rows; the 'data'
    index cuts that block into D_d slabs. Zero pad rows stay zero and
    ``gather_lane_values``'s [:N] drops them."""
    n_sh, n_dt = mesh.size(0), mesh.size(1)
    n = x.shape[0]
    t = lane_slab_rows(n, n_sh, n_dt)
    pad = t * n_sh * n_dt - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    sl = psum_scatter(x, mesh.get_group("shard"))
    d = mesh.get_local_rank("data")
    return sl[d * t:(d + 1) * t]


def gather_lane_values(v: torch.Tensor, n_lanes: int, mesh) -> torch.Tensor:
    """Per-device slab results -> the full lane vector on every device.

    The all-gather over the whole mesh concatenates the slabs in rank
    order, shard-major and data-minor, the order ``scatter_lane_slab``
    dealt them, so row i is lane i's value; [:n_lanes] drops the
    padding."""
    return all_gather(v, mesh_group(mesh))[:n_lanes]


def stream_epoch(state: ShardedFlowTable) -> torch.Tensor:
    """The true observed stream start in the provisional rebased frame, a
    0-dim tensor: 0.0 until a packet arrives, exactly 0.0 on an in-order
    stream whose provisional t0 was its first packet, negative when the
    true start arrived after the host's latch. Features never depend on it
    (they are timestamp differences)."""
    return torch.where(torch.isfinite(state.epoch), state.epoch, 0.0)


def sharded_flow_table(state: ShardedFlowTable, mesh) -> torch.Tensor:
    """(n_buckets, 8) feature table in canonical bucket order, on every
    rank (a collective: every rank of the mesh calls it).

    All-gathers the shards' blocks over 'shard' and interleaves them back
    to the global order (row b = block[b % D][:, b // D]), then derives the
    features through the shared ``table_from_registers``. The raw t_min /
    t_max registers feed the derivation untouched; combine them with
    ``stream_epoch`` for wall-clock flow times."""
    d, n_local = state.n_shards, state.n_local
    blocks = all_gather(state.regs, mesh.get_group("shard"))
    regs = (blocks.reshape(d, len(REGISTER_FIELDS), n_local)
            .permute(1, 2, 0).reshape(len(REGISTER_FIELDS), d * n_local))
    return table_from_registers(*regs)


def stream_sharded_flow_features(trace, n_buckets: int = 4096,
                                 window: int = 1024, *, mesh=None,
                                 n_shards: Optional[int] = None,
                                 t0: Optional[float] = None, device=None):
    """Stream a trace through the sharded register file window by window
    (a collective: every rank of the mesh calls it with the same trace).

    -> (bucket_ids (P,), flow_table (n_buckets, 8)) in canonical bucket
    order: the sharded counterpart of ``stream_flow_features`` and the
    equivalence oracle, bit-consistent with the batch ``flow_features``
    (the plain register update, no clamp, no eviction). mesh=None builds
    ``flow_shard_mesh(n_shards, device=device)`` (device None: CUDA)."""
    mesh = as_flow_mesh(mesh if mesh is not None
                        else flow_shard_mesh(n_shards, device=device))
    dev = mesh_device(mesh)
    b = fnv1a_hash(trace.src_ip, trace.dst_ip, trace.sport, trace.dport,
                   trace.proto, n_buckets=n_buckets, device=dev)
    state = init_sharded_table(n_buckets, mesh=mesh)
    for w in iter_windows(trace, window, n_buckets, bucket=b, t0=t0,
                          device=dev):
        local, _ = localize_window(w, state.n_shards, state.shard)
        state.regs = update_flow_table(FlowTableState(state.regs),
                                       local).regs
        state.epoch = torch.minimum(state.epoch, window_epoch(w))
    return b, sharded_flow_table(state, mesh)
