"""Kernels of the port: the hand-written CUDA kernels (``csrc/*.cu``: the
tree lookups, fused and per-feature-loop, the classical lookup, the range
match, the streaming register scatter/readout, the eviction fill and the
int8-KV decode attention), the tile autotune (``tuning.py``), their build
(``_build.py``), their plain PyTorch versions (``ref.py`` and each wrapper
module) and the public wrappers (``ops.py``)."""
