"""Kernels of the port: the hand-written CUDA kernels (``csrc/*.cu``: the
tree and classical lookups, the range match, the streaming register
scatter/readout and the eviction fill), their build (``_build.py``), their
plain PyTorch versions (``ref.py`` and each wrapper module) and the public
wrappers (``ops.py``)."""
