"""IIsy in PyTorch: the hybrid classification path on an NVIDIA GPU.

A port of the ``repro`` package, module for module, with the same public
names at the same module paths. Plain tensor code is PyTorch; every kernel
that ``repro`` wrote in Pallas for a TPU is a hand-written CUDA kernel here
(``csrc/*.cu``: the tree lookups, fused and per-feature-loop, the
classical lookup, the range match, the streaming register scatter/readout
and the eviction fill, held bit for bit against their plain PyTorch
versions; and the int8-KV decode attention B8, held to rtol 2e-4 /
atol 2e-5), built with ``nvcc`` at first use.

The LM side serves every config of the registry (``models/``,
``configs/``, ``serving/engine.py``): dense and MoE GQA decoders, MLA, the
recurrent blocks, Whisper's encoder-decoder and the image-patch frontend;
prefill, then decode (on the card one CUDA graph a step) over caches
written in place, an int8 KV cache's attention core B8; ``launch.serve
--backend lm``
puts a smoke-size qwen3-4b behind the switch. ``launch.serve --use-case
finance`` serves the paper's second use case, and
``examples.finance_lowlatency`` parses its switch features from CSV
payloads on the card.

Routing rule (``device.py``): a CUDA tensor goes through the kernel, a CPU
tensor through the plain version. Entry points (``HybridServer``,
``StreamingHybridServer``, ``kernels.ops.fused_classify``,
``models.model.init_model``, ``launch.serve``) run on CUDA unless the
caller passes ``device="cpu"``, and raise when no card is present.

This package imports torch and numpy only — never jax, never ``repro``.
"""
