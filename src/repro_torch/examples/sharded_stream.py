"""The sharded flow-table tier, one process per device.

Serves a synthetic packet trace through ``ShardedStreamingServer`` over a
('shard', 'data') mesh of every rank of the group, and checks its answers
against the single-device ``StreamingHybridServer`` on the same trace:
predictions, ``StreamStats`` and the flow table, bit for bit. Every rank
builds the same trace and models from the seed (the shard bench's recipe:
an RF 4x3 switch and an RF 16x6 backend on the trace's batch flow
features); rank 0 prints.

    # gloo processes on the CPU (torchrun sets the rendezvous)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.examples.sharded_stream --device cpu --n-flows 1000
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.sharded_stream --device cpu --n-flows 1000 --n-data 2
    # one card: a one-rank NCCL group, no launcher
    PYTHONPATH=src python -m repro_torch.examples.sharded_stream

``main`` returns what it computed for callers that check it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.mapping import map_tree_ensemble
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import BACKENDS, flow_shard_mesh
from repro_torch.ml.trees import fit_random_forest, predict_tree_ensemble
from repro_torch.netsim.features import flow_features
from repro_torch.netsim.packets import synth_trace
from repro_torch.serving.shard_serving import ShardedStreamingServer
from repro_torch.serving.stream_serving import StreamingHybridServer


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-flows", type=int, default=4000)
    ap.add_argument("--n-buckets", type=int, default=8192)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--n-data", type=int, default=1,
                    help="ranks along 'data'; the rest go along 'shard'")
    ap.add_argument("--chunk-windows", type=int, default=None)
    ap.add_argument("--evict-age", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    had_group = dist.is_initialized()
    if not had_group and "WORLD_SIZE" in os.environ:
        # a launcher (torchrun) started this process: join its group
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(BACKENDS[dev.type])
    try:
        # with no group yet (no launcher) a one-device mesh starts one
        mesh = flow_shard_mesh(n_data=args.n_data, device=dev)
        trace = synth_trace(n_flows=args.n_flows, seed=args.seed)
        b, table = flow_features(trace, n_buckets=args.n_buckets, device=dev)
        first = np.unique(trace.flow_id, return_index=True)[1]
        rows = table[b[torch.as_tensor(first, device=dev)].long()]
        small = fit_random_forest(rows, trace.flow_label, n_classes=2,
                                  n_trees=4, max_depth=3, seed=0, device=dev)
        big = fit_random_forest(rows, trace.flow_label, n_classes=2,
                                n_trees=16, max_depth=6, seed=1, device=dev)
        art = map_tree_ensemble(small, rows.shape[1])

        def backend(r):
            return predict_tree_ensemble(big, r)

        kw = dict(n_buckets=args.n_buckets, window=args.window,
                  threshold=0.9, capacity=64,
                  chunk_windows=args.chunk_windows, evict_age=args.evict_age,
                  device=dev)
        srv = ShardedStreamingServer(art, backend, mesh=mesh, **kw)
        pred, stats = srv.serve_trace(trace)
        ref = StreamingHybridServer(art, backend, **kw)
        ref_pred, ref_stats = ref.serve_trace(trace)
        table = srv.flow_table()
        equal = (torch.equal(pred, ref_pred)
                 and stats.as_dict() == ref_stats.as_dict()
                 and torch.equal(table, ref.flow_table()))
        if dist.get_rank() == 0:
            print(f"mesh (shard, data)={tuple(mesh.mesh.shape)} "
                  f"{dist.get_backend()} device={dev} "
                  f"packets={stats.n_packets} windows={stats.n_windows} "
                  f"handled_at_switch={stats.fraction_handled:.4f} "
                  f"backend_rows={stats.total_backend_rows} "
                  f"evicted={stats.n_evicted} epoch={srv.epoch} "
                  f"classify_rows_per_device={srv.classify_rows_per_device} "
                  f"equal_single_device={equal}")
        if not equal:
            raise AssertionError("the sharded tier's answers differ from the "
                                 "single-device server's")
        return dict(pred=pred, stats=stats, table=table, server=srv,
                    equal=equal)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
