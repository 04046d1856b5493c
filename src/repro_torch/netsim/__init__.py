"""Network feature extraction (§5 of the paper), in PyTorch.

Port of ``repro/netsim``: synthetic packet traces, per-packet and
flow-level features (hash + per-bucket registers), and ``stream``, the
always-on deployment shape — the same flow registers carried as a
``FlowTableState`` and updated window by window.
"""

from repro_torch.netsim.features import (fnv1a_hash, flow_features,
                                         packet_features, rebase_ts,
                                         rebase_ts_np, table_from_registers)
from repro_torch.netsim.packets import PacketTrace, synth_trace
from repro_torch.netsim.stream import (FlowTableState, PacketWindow,
                                       age_out, flow_table_from_arrays,
                                       flow_table_readout, init_flow_table,
                                       iter_windows, lifecycle_sweep,
                                       packet_window_from_arrays,
                                       saturate_counts, stream_flow_features,
                                       trace_columns, update_flow_table,
                                       window_update_readout)

__all__ = [
    "FlowTableState", "PacketTrace", "PacketWindow", "age_out",
    "flow_features", "flow_table_from_arrays", "flow_table_readout",
    "fnv1a_hash", "init_flow_table", "iter_windows", "lifecycle_sweep",
    "packet_features", "packet_window_from_arrays", "rebase_ts",
    "rebase_ts_np", "saturate_counts", "stream_flow_features",
    "synth_trace", "table_from_registers", "trace_columns",
    "update_flow_table", "window_update_readout"]
