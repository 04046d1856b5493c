"""Serving runtime: the hybrid batch tier, the streaming tier and the LM
engine (``engine.ServeEngine``: prefill, then int8-KV decode)."""
