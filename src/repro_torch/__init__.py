"""IIsy in PyTorch: the hybrid classification path on an NVIDIA GPU.

A port of the ``repro`` package, module for module, with the same public
names at the same module paths. Plain tensor code is PyTorch; every kernel
that ``repro`` wrote in Pallas for a TPU and that the ported paths run is a
hand-written CUDA kernel here (``csrc/*.cu``: the tree lookups, fused and
per-feature-loop, the classical lookup, the range match, the streaming
register scatter/readout and the eviction fill), built with ``nvcc`` at
first use and held bit for bit against its plain PyTorch version.

Routing rule (``device.py``): a CUDA tensor goes through the kernel, a CPU
tensor through the plain version. Entry points (``HybridServer``,
``StreamingHybridServer``, ``kernels.ops.fused_classify``,
``launch.serve``) run on CUDA unless the caller passes ``device="cpu"``,
and raise when no card is present.

This package imports torch and numpy only — never jax, never ``repro``.
"""
