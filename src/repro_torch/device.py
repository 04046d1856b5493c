"""Device resolution and the kernel routing rule.

``resolve_device`` is shared by every entry point: no device means CUDA,
and a missing card is an error, never a silent move to the CPU.

``on_kernel_path`` is the one routing rule of the port: a CUDA tensor goes
through the hand-written kernel, a CPU tensor through the kernel's plain
PyTorch version. There is no third branch — any other device raises.
(Counterpart of ``repro.kernels.ops._on_tpu`` and
``repro.kernels.tuning.resolve_interpret``.)
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda``; raises RuntimeError when CUDA is asked for and
    absent. Pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` correctly rounded on every device, as the reference's eager
    division gives it.

    For a Python-number divisor PyTorch's CUDA kernel multiplies by the
    reciprocal, which can miss the correctly rounded quotient by one ulp
    (9 / 10 gives 0.90000004 where the CPU gives 0.89999998) and flip a
    ``conf >= tau`` test. A divisor tensor on ``x``'s device takes the true
    division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean as the reference computes it: ``jnp.mean`` is jitted, and XLA
    turns its division by the element count into a product with the float32
    reciprocal, so this takes the sum times ``float32(1 / count)`` on every
    device (PyTorch's own ``mean`` rounds differently on the CPU)."""
    count = x.numel() if dim is None else x.shape[dim]
    total = x.sum() if dim is None else x.sum(dim=dim)
    return total * float(np.float32(1.0) / np.float32(count))


def on_kernel_path(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for a tensor on {t.device}")


def to_numpy(a, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array: how the
    host-side control plane (mapping, resource accounting) reads tables."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)
