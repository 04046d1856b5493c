"""Serving runtime: the hybrid batch tier, the streaming tier (window,
chunk and open-ended ``serve_stream`` serving), its sharded form over a
mesh of devices (``shard_serving.ShardedStreamingServer``) and the LM
engine (``engine.ServeEngine``: prefill, then int8-KV decode)."""

from repro_torch.serving.engine import ServeEngine, greedy_generate
from repro_torch.serving.hybrid_serving import HybridServer
from repro_torch.serving.shard_serving import ShardedStreamingServer
from repro_torch.serving.stream_serving import (StreamingHybridServer,
                                                StreamStats)

__all__ = ["HybridServer", "ServeEngine", "ShardedStreamingServer",
           "StreamStats", "StreamingHybridServer", "greedy_generate"]
