"""Kernels of the port: the CUDA tree-ensemble lookup (csrc/ensemble_lookup.cu),
its build, its plain PyTorch versions (ref.py) and the classify wrappers (ops.py)."""
