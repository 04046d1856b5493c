"""Network feature extraction (§5 of the paper), in PyTorch.

Port of ``repro/netsim``: synthetic packet traces, per-packet,
flow-level, aggregate-level and file-level (CSV payload) features, and
``stream``, the always-on deployment shape — the same flow registers
carried as a ``FlowTableState`` and updated window by window, or K windows
at a time as a ``PacketChunk`` — ``ingest``, the open-ended packet ring
that cuts a live stream into such chunks, ``shard_stream``, the register
file partitioned over a ('shard', 'data') mesh of devices, and
``scenarios``, the adversarial traces (floods, hash-collision storms,
slow-loris probes, elephant/mice skew).
"""

from repro_torch.netsim.features import (aggregate_features,
                                         encode_csv_payload,
                                         file_features_csv, fnv1a_hash,
                                         flow_features, packet_features,
                                         rebase_ts, rebase_ts_np,
                                         stitch_split_payload,
                                         table_from_registers)
from repro_torch.netsim.ingest import (HostCut, IngestStats,
                                       LatencyRecorder, PacketRingBuffer,
                                       PinnedStaging, await_chunk, cut_stream,
                                       prefetch_iter, replay_source,
                                       slice_trace)
from repro_torch.netsim.packets import PacketTrace, synth_trace
from repro_torch.netsim.scenarios import (SCENARIOS, collision_storm,
                                          ddos_flood, elephant_mice,
                                          make_scenario, merge_traces,
                                          slow_loris)
from repro_torch.netsim.shard_stream import (ShardedFlowTable,
                                             gather_lane_values,
                                             init_sharded_table,
                                             lane_slab_rows, localize_window,
                                             n_local_buckets,
                                             scatter_lane_slab,
                                             shard_window_update,
                                             sharded_flow_table,
                                             stream_epoch,
                                             stream_sharded_flow_features)
from repro_torch.netsim.stream import (FlowTableState, PacketChunk,
                                       PacketWindow, age_out,
                                       chunk_update_readout,
                                       flow_table_from_arrays,
                                       flow_table_readout, init_flow_table,
                                       iter_chunks, iter_windows,
                                       lifecycle_sweep, pack_chunk_columns,
                                       packet_chunk_from_arrays,
                                       packet_window_from_arrays,
                                       saturate_counts, stream_flow_features,
                                       trace_columns, update_flow_table,
                                       window_update_readout)

__all__ = [
    "SCENARIOS", "FlowTableState", "HostCut", "IngestStats",
    "LatencyRecorder", "PacketChunk", "PacketRingBuffer", "PacketTrace",
    "PacketWindow", "PinnedStaging", "ShardedFlowTable", "age_out",
    "aggregate_features", "await_chunk", "chunk_update_readout",
    "collision_storm", "cut_stream", "ddos_flood", "elephant_mice",
    "encode_csv_payload", "file_features_csv", "flow_features",
    "flow_table_from_arrays", "flow_table_readout", "fnv1a_hash",
    "gather_lane_values", "init_flow_table", "init_sharded_table",
    "iter_chunks", "iter_windows", "lane_slab_rows", "lifecycle_sweep",
    "localize_window", "make_scenario", "merge_traces", "n_local_buckets",
    "pack_chunk_columns", "packet_chunk_from_arrays", "packet_features",
    "packet_window_from_arrays", "prefetch_iter", "rebase_ts",
    "rebase_ts_np", "replay_source", "saturate_counts", "scatter_lane_slab",
    "shard_window_update", "sharded_flow_table", "slice_trace",
    "slow_loris", "stitch_split_payload", "stream_epoch",
    "stream_flow_features", "stream_sharded_flow_features", "synth_trace",
    "table_from_registers", "trace_columns", "update_flow_table",
    "window_update_readout"]
