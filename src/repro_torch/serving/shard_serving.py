"""Sharded streaming hybrid serving: the flow table scaled out over a mesh.

Port of ``repro/serving/shard_serving.py``. ``ShardedStreamingServer`` is
the ``StreamingHybridServer`` with its register file partitioned over a
('shard', 'data') mesh (``netsim.shard_stream``, ``distributed.sharding``):
one process per device, each holding only its own register block, joined
by ``torch.distributed`` (NCCL on the card, gloo on the CPU). Every rank
runs the same step on the same (replicated) window:

  register half      the window localized to this shard's buckets, folded
                     into its block (B5, and B6's sweep on the full window's
                     clock); the readout rows of lanes it does not own zeroed
  partitioned        the owner-masked rows reduce-scattered over 'shard'
  classify           into complete lane slabs of ceil(K*W/D) rows, cut by
                     the 'data' index; the fused classify (B1) on this
                     device's slab only; pred and conf all-gathered over the
                     whole mesh back to full width
  dispatch           capacity-bounded, then the buffer psummed over 'shard'
                     (complete rows: one real row plus zeros), and the
                     evicted / overflow counts psummed
  backend, fold      the parent's ``accumulate_stream_stats``

So each window, switch half and chunk switch half sends 3 psums, 1
reduce-scatter and 2 all-gathers (``distributed.collectives`` counts
them), and never the register file. ``partition_classify=False`` is the
``merge_overhead`` baseline: every device classifies all lanes, and pred
and conf are psummed masked to their owner.

Backends. On the fused route (the step's CUDA graph on the card; on the
CPU, every step unless ``fuse=False``) the window step's backend serves
the merged buffer on every device; a chunk's backend serves
K*capacity/D rows on each device, and the answers are all-gathered before
the back-patch (one all-gather more); deferral (``flush_every`` = k > 1)
keeps each shard's partial rows with no merge a window, and a flush
reduce-scatters them, serves k*capacity/D rows on each device and
all-gathers the answers. On the two-phase route (``fuse=False``, a
``fault_policy``, or a backend the probe finds syncing) ONE host call
serves complete rows: rank 0 makes the (guarded) call and broadcasts the
answers, or the failure, to every rank, so every rank patches or degrades
the same windows and a timeout on one rank never splits them.

Contract: with the timeout policy or no eviction the sharded server equals
the single-device ``StreamingHybridServer`` bit for bit on in-order traces
(predictions, ``StreamStats``, ``flow_table()``) at every mesh shape: the
reduce-scatter of owner-masked rows sums one real row plus zeros per lane,
and classify is row-independent. Approx-LRU sweeps each shard's block on
its own (``netsim.shard_stream.shard_window_update``). The min-merged
epoch register (``.epoch``) records the stream's true start.

At one device (the one-rank group ``flow_shard_mesh`` starts) every
collective still runs, over a group of one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.core.hybrid import dispatch
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (all_gather, broadcast,
                                                 psum, psum_scatter)
from repro_torch.distributed.sharding import (as_flow_mesh, flow_shard_mesh,
                                              mesh_device, mesh_group,
                                              mesh_rank)
from repro_torch.kernels.ops import fused_classify
from repro_torch.kernels.tuning import TileConfig, shard_tiles
from repro_torch.netsim.shard_stream import (ShardedFlowTable,
                                             gather_lane_values,
                                             init_sharded_table,
                                             lane_slab_rows, localize_window,
                                             n_local_buckets,
                                             scatter_lane_slab,
                                             shard_window_update,
                                             sharded_flow_table, stream_epoch,
                                             window_epoch)
from repro_torch.netsim.stream import (FlowTableState, PacketChunk,
                                       PacketWindow, chunk_update_readout)
from repro_torch.obs import Observability
from repro_torch.obs.profiling import phase
from repro_torch.serving.faults import FaultPolicy
from repro_torch.serving.stream_serving import (StreamingHybridServer,
                                                _Carries,
                                                chunk_classify_tail)

# the dtypes a two-phase answer may cross in (rank 0's header names one)
_ANSWER_DTYPES = (torch.int64, torch.int32, torch.int16, torch.int8,
                  torch.uint8, torch.bool, torch.float32, torch.float64)


# The census each of the parent's AUDIT_CONTRACTS steps sends here
# (``distributed.collectives``): a window or chunk switch half 3 psums, 1
# reduce-scatter, 2 all-gathers, one rank >= 2 "readout" psum (the dispatch
# buffer) and one rank >= 2 reduce-scatter (the lane slab), as the
# reference's rows (``repro/serving/shard_serving.py``). The chunk step
# all-gathers its backend's answers once more (ROADMAP C3: the reference's
# come back through its out_specs, uncounted). A deferred step sends no
# buffer psum; a flush reduce-scatters the buffer and all-gathers the
# answers.
_CENSUS = {
    "_window_step": {"collectives": {"psum": 3, "reduce_scatter": 1,
                                     "all_gather": 2},
                     "readout_psums": 1, "readout_scatters": 1},
    "_window_switch": {"collectives": {"psum": 3, "reduce_scatter": 1,
                                       "all_gather": 2},
                       "readout_psums": 1, "readout_scatters": 1},
    "_chunk_step": {"collectives": {"psum": 3, "reduce_scatter": 1,
                                    "all_gather": 3},
                    "readout_psums": 1, "readout_scatters": 1},
    "_deferred_step": {"collectives": {"psum": 2, "reduce_scatter": 1,
                                       "all_gather": 2},
                       "readout_psums": 0, "readout_scatters": 1},
    "_flush_step": {"collectives": {"reduce_scatter": 1, "all_gather": 1},
                    "readout_psums": 0, "readout_scatters": 1},
}


class ShardedStreamingServer(StreamingHybridServer):
    """StreamingHybridServer over a bucket-sharded register file.

    ``mesh`` (or ``n_shards`` / ``n_data``) picks the ('shard', 'data')
    mesh: default every rank of the default group on 'shard', and with no
    group a one-device mesh on a one-rank group; a 1D ('shard',) mesh is
    normalized to a size-1 'data' dim. ``n_buckets`` is the *global* table
    size and must divide over the shards. Every parent knob keeps its
    meaning, and ``step``, ``step_chunk``, ``flush``, ``serve_trace``,
    ``serve_stream``, ``reset``, ``obs=`` and ``fault_policy=`` are the
    parent's. Every rank of the mesh makes the same calls in the same
    order with the same inputs (the step's collectives pair them up).

    ``device`` is this rank's device (None: CUDA, raising without a card);
    it must be of the mesh's device type.
    """

    # The parent's rows, each with the census its step sends (``_CENSUS``)
    AUDIT_CONTRACTS = tuple(dict(row, **_CENSUS[row["attr"]])
                            for row in StreamingHybridServer.AUDIT_CONTRACTS)

    def __init__(self, artifact: TableArtifact, backend_fn: Callable, *,
                 n_buckets: int = 4096, window: int = 512,
                 threshold: float = 0.7, capacity: int = 64,
                 flush_every: int = 1,
                 chunk_windows: Optional[Union[int, str]] = None,
                 flush_occupancy: Optional[float] = None,
                 flush_deadline: Optional[float] = None,
                 evict_age: Optional[float] = None, saturate: bool = True,
                 evict_policy: str = "timeout", lru_occupancy: float = 0.75,
                 fault_policy: Optional[FaultPolicy] = None,
                 mesh=None, n_shards: Optional[int] = None,
                 n_data: Optional[int] = None,
                 partition_classify: bool = True,
                 use_kernel: Optional[bool] = None, autotune: bool = False,
                 tiles: Optional[TileConfig] = None,
                 fuse: Optional[bool] = None,
                 obs: Optional[Observability] = None, device=None):
        # the mesh before the parent's init: it allocates the register file
        # (and sweeps "auto") through hooks that need it
        dev = resolve_device(device)
        if mesh is not None:
            self.mesh = as_flow_mesh(mesh)
        else:
            self.mesh = flow_shard_mesh(n_shards, n_data or 1, device=dev)
        if self.mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {self.mesh.device_type}, the "
                             f"server on {dev.type}")
        n_sh = self.n_shards = self.mesh.size(0)
        self.n_data = self.mesh.size(1)
        n_dev = self.n_devices = self.mesh.size()
        self.partition_classify = bool(partition_classify)
        self._shard = self.mesh.get_local_rank("shard")
        self._data = self.mesh.get_local_rank("data")
        self._rank = mesh_rank(self.mesh)
        self._shard_group = self.mesh.get_group("shard")
        self._mesh_group = mesh_group(self.mesh)
        n_local_buckets(n_buckets, n_sh)          # validate divisibility
        if flush_every > 1 and (flush_every * capacity) % n_dev:
            # flush_every == 1 never builds the deferral buffer
            raise ValueError(
                f"flush_every*capacity={flush_every * capacity} must divide "
                f"evenly over {n_dev} devices (each device's backend serves "
                f"one slice of the deferral buffer per flush)")
        # "auto" resolves in the parent's init, whose candidates pass the
        # same check (_auto_chunk_filter)
        if (isinstance(chunk_windows, int)
                and (chunk_windows * capacity) % n_dev):
            raise ValueError(
                f"chunk_windows*capacity={chunk_windows * capacity} must "
                f"divide evenly over {n_dev} devices (each device's backend "
                f"serves one slice of the chunk's deferral buffer)")
        super().__init__(artifact, backend_fn, n_buckets=n_buckets,
                         window=window, threshold=threshold,
                         capacity=capacity, flush_every=flush_every,
                         chunk_windows=chunk_windows,
                         flush_occupancy=flush_occupancy,
                         flush_deadline=flush_deadline, evict_age=evict_age,
                         saturate=saturate, evict_policy=evict_policy,
                         lru_occupancy=lru_occupancy,
                         fault_policy=fault_policy, use_kernel=use_kernel,
                         autotune=autotune, tiles=tiles, fuse=fuse, obs=obs,
                         device=mesh_device(self.mesh))

    # -- the partitioned classify ------------------------------------------

    def _slab_classify(self, x: torch.Tensor):
        """Reduce-scatter the owner-masked (N, F) rows into this device's
        complete lane slab, classify the slab only (``tile_n`` clamped to
        it), all-gather pred and conf back to the full N lanes. Equal to
        classifying all N rows: each complete row is the owner's row bit
        for bit, and classify is row-independent."""
        n = x.shape[0]
        t = lane_slab_rows(n, self.n_shards, self.n_data)
        pred, conf = fused_classify(self.artifact,
                                    scatter_lane_slab(x, self.mesh),
                                    tiles=shard_tiles(self.tiles, t),
                                    device=self.device)
        return (gather_lane_values(pred, n, self.mesh),
                gather_lane_values(conf, n, self.mesh))

    def _classify(self, x: torch.Tensor, own: torch.Tensor):
        if self.partition_classify:
            return self._slab_classify(x)
        # merge_overhead baseline: every device classifies every lane; one
        # shard contributes each lane's value, the others zeros
        pred, conf = fused_classify(self.artifact, x, tiles=self.tiles,
                                    device=self.device)
        return (psum(torch.where(own, pred, 0), self._shard_group),
                psum(torch.where(own, conf, 0.0), self._shard_group))

    # -- the step kinds -------------------------------------------------------

    def _shard_switch(self, c: _Carries, w: PacketWindow, tau, *,
                      merge_buf: bool):
        """The window's switch half on this rank. ``merge_buf`` psums the
        dispatch buffer over 'shard' (complete rows for the backend); the
        deferred step keeps this shard's partial rows, which a flush
        reduce-scatters."""
        t = c.table
        phase("register")
        state, e, own, x, n_ev, n_ov = shard_window_update(
            FlowTableState(t.regs), w, self.n_shards, self._shard,
            **self._register_kw())
        self._store_regs(t.regs, state)
        t.epoch.copy_(torch.minimum(t.epoch, e))
        phase("switch")
        sw_pred, conf = self._classify(x, own)
        phase("dispatch")
        fwd = (conf < tau) & w.valid
        buf, idx, valid = dispatch(x, fwd, self.capacity)
        if merge_buf:
            buf = psum(buf, self._shard_group)
        n_ev = psum(n_ev, self._shard_group)
        n_ov = psum(n_ov, self._shard_group)
        return buf, (sw_pred, idx, valid, fwd, conf, n_ev, n_ov)

    def _window_switch(self, c: _Carries, w: PacketWindow, tau):
        return self._shard_switch(c, w, tau, merge_buf=True)

    def _defer_switch(self, c: _Carries, w: PacketWindow, tau):
        return self._shard_switch(c, w, tau, merge_buf=False)

    def _chunk_switch(self, c: _Carries, chunk: PacketChunk, tau):
        """The chunk's switch half on this rank: K register steps on the
        local block, one partitioned classify over the K*W rows (the
        baseline psums the rows and classifies them all), the dispatch of
        every window and one psum of its buffer."""
        t = c.table
        phase("register")
        local, own = localize_window(chunk, self.n_shards, self._shard)
        state, xs, n_ev, n_ov = chunk_update_readout(
            FlowTableState(t.regs), local, sweep=chunk, **self._register_kw())
        self._store_regs(t.regs, state)
        t.epoch.copy_(torch.minimum(t.epoch, window_epoch(chunk)))
        xs = torch.where(own[..., None], xs, 0.0)
        if not self.partition_classify:
            xs = psum(xs, self._shard_group)      # owner partials: complete
        n_ev = psum(n_ev, self._shard_group)
        n_ov = psum(n_ov, self._shard_group)
        new, dd, pending, frac, rows = chunk_classify_tail(
            self.artifact, c.stats, chunk, xs, n_ev, n_ov, tau,
            self.capacity, tiles=self.tiles, device=self.device,
            classify=self._slab_classify if self.partition_classify
            else None)
        if self.partition_classify:
            dd = dataclasses.replace(dd, buf=psum(dd.buf, self._shard_group))
        c.stats.copy_(new)        # the backend accounting folds here too
        return dd.buf, (dd, pending, frac, rows)

    # -- the backend across the mesh --------------------------------------------

    def _fused_backend(self, kind: str, c: _Carries, rows):
        """The fused route's backend: a window's merged buffer on every
        device; a chunk's complete rows, K*capacity/D of them on each device;
        a flush's partial rows reduce-scattered over 'shard' and cut by the
        'data' index, k*capacity/D on each device. The slices' answers are
        all-gathered in slot order."""
        if kind == "window":
            return self._backend_answer(rows)
        if kind == "flush":
            sl = psum_scatter(c.dd.buf, self._shard_group)
            per = sl.shape[0] // self.n_data
            rows = sl[self._data * per:(self._data + 1) * per]
        else:
            per = rows.shape[0] // self.n_devices
            rows = rows[self._rank * per:(self._rank + 1) * per]
        return all_gather(self._backend_answer(rows).reshape(-1),
                          self._mesh_group)

    def _eager_backend(self, kind: str, c: _Carries, rows):
        # on the CPU every step is eager: the reference's fused route there
        # is every route but fuse=False (which a fault policy sets)
        if self.device.type == "cpu" and self._fuse is not False:
            return self._fused_backend(kind, c, rows)
        return super()._eager_backend(kind, c, rows)

    def _flush_rows_host(self) -> torch.Tensor:
        """The two-phase flush's complete rows: the shards' partial rows
        summed over 'shard'."""
        return psum(self._dd.buf, self._shard_group)

    def _share(self, n: int, be: Optional[torch.Tensor],
               flag: Optional[bool] = None) -> tuple:
        """Rank 0's two-phase outcome on every rank: (its ``n`` answers, or
        None when its guarded call failed; its ``flag``, or None)."""
        head = torch.zeros(3, dtype=torch.int64)
        if self._rank == 0:
            if be is not None:
                if be.numel() != n:
                    raise ValueError(f"the backend answered {be.numel()} "
                                     f"rows of {n}")
                head[0] = 1 + _ANSWER_DTYPES.index(be.dtype)
            head[1] = -1 if flag is None else int(flag)
        code, fl = broadcast(head.to(self.device),
                             self._mesh_group).tolist()[:2]
        flag = None if fl < 0 else bool(fl)
        if not code:
            return None, flag
        dtype = _ANSWER_DTYPES[code - 1]
        out = (be.reshape(-1).contiguous() if self._rank == 0
               else torch.empty(n, dtype=dtype, device=self.device))
        return broadcast(out, self._mesh_group), flag

    def _host_backend(self, rows) -> Optional[torch.Tensor]:
        """ONE host call over complete rows, on rank 0 (through the guard
        when there is one), its answers or its failure broadcast."""
        be = self._host_call(rows) if self._rank == 0 else None
        return self._share(rows.shape[0], be)[0]

    def _probe_backend(self, rows) -> torch.Tensor:
        """Rank 0 probes the backend (``StreamingHybridServer.
        _probe_backend``) and broadcasts its verdict with the answers, so
        every rank takes the same route from here on."""
        be = super()._probe_backend(rows) if self._rank == 0 else None
        be, self._fused_ok = self._share(rows.shape[0], be, self._fused_ok)
        return be

    # -- the chunk-size autotune ------------------------------------------------

    def _auto_chunk_server(self, k: int, artifact, backend_fn, **kw):
        """The sweep's throwaway servers share this server's mesh and
        classify layout, so each candidate's time includes its
        collectives."""
        return ShardedStreamingServer(
            artifact, backend_fn, chunk_windows=k, mesh=self.mesh,
            partition_classify=self.partition_classify, **kw)

    def _auto_chunk_filter(self, capacity: int):
        """Only the Ks whose chunk buffer divides over the mesh."""
        n_dev = self.n_devices
        return lambda k: (k * capacity) % n_dev == 0

    def _resolve_auto_chunk_windows(self, artifact, backend_fn, **kw):
        """Every rank sweeps in step (the throwaways' collectives pair up);
        rank 0's K is every rank's."""
        k, sweep = super()._resolve_auto_chunk_windows(artifact, backend_fn,
                                                       **kw)
        dev = mesh_device(self.mesh)
        k = int(broadcast(torch.tensor([k], device=dev), self._mesh_group))
        return k, sweep

    # -- state ------------------------------------------------------------------

    def _make_state(self) -> ShardedFlowTable:
        """This rank's block of the partitioned register file."""
        return init_sharded_table(self.n_buckets, mesh=self.mesh)

    @property
    def classify_rows_per_device(self) -> int:
        """Rows each device's classify processes a step: the ceil(K*W/D)
        slab (exactly: the kernels mask their ragged last block), or the
        K*W lanes on every device with ``partition_classify=False``."""
        lanes = (self.chunk_windows or 1) * self.window
        if not self.partition_classify:
            return lanes
        return lane_slab_rows(lanes, self.n_shards, self.n_data)

    def flow_table(self) -> torch.Tensor:
        """(n_buckets, 8) table in canonical bucket order, gathered across
        the shards (a collective: every rank calls it). Timestamps stay in
        the provisional rebased frame; combine with ``.epoch`` for wall
        clock."""
        return sharded_flow_table(self._table, self.mesh)

    @property
    def epoch(self) -> float:
        """The true observed stream start (the min-merged register) in the
        provisional rebased frame; 0.0 on an in-order stream. Reading it
        syncs; it needs no collective."""
        return float(stream_epoch(self._table))

    def serve_stream(self, source, *, deadline: Optional[float] = None,
                     clock: Callable[[], float] = time.monotonic, **kw):
        """``StreamingHybridServer.serve_stream``. Each rank cuts its own
        copy of the source, so at more than one device a ``deadline`` needs
        a ``clock`` that reads the same on every rank: the wall clock could
        cut the ranks' streams differently and split them."""
        if (deadline is not None and clock is time.monotonic
                and self.n_devices > 1):
            raise ValueError(
                "a wall-clock ingest deadline cuts each rank's stream on "
                "its own clock; pass a clock every rank shares, or no "
                "deadline, to serve_stream at more than one device")
        return super().serve_stream(source, deadline=deadline, clock=clock,
                                    **kw)
