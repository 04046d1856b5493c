"""Op recording for the hot-path auditor: the port's counterpart of the
reference's jaxpr walk (``repro/analysis/jaxpr_utils.py``).

The reference traces a jitted step into a jaxpr and reads its primitives.
A PyTorch step has no program to read before it runs, so the port runs the
step body once under :class:`OpRecorder`, a ``TorchDispatchMode`` that sees
every aten op the body dispatches, and records:

* every op's name (``aten.add.Tensor``, ``c10d.allreduce_.default``);
* the dtype of every tensor an op produces (``hotpath-dtype``);
* the **host-sync ops** (``hotpath-zero-sync``), the counterparts of the
  reference's ``forbidden_primitives``:

  - ``aten._local_scalar_dense``: what ``.item()``, ``float()``,
    ``int()`` and ``bool()`` on a tensor reach;
  - an ``aten._to_copy`` or ``aten.copy_`` whose source and destination
    devices differ (``.cpu()``, ``.to("cuda")``, ``.numpy()``'s copy);
  - the ops whose output shape depends on the data (``nonzero``,
    ``masked_select``, ``unique``, boolean-mask indexing), which sync on
    CUDA to size their output.

A copy that stays on the CPU crosses nothing, so ``.cpu()`` or ``.numpy()``
of a CPU tensor dispatches no op: on the CPU the lint rule
``lint-host-sync-in-graph`` covers them, and on the card the auditor also
runs the body under ``torch.cuda.set_sync_debug_mode("error")``.

A hand-written kernel's launch is an opaque call, not an aten op: the
recorder reads it from the kernel wrappers' launch counts
(``kernel_launches``), and a collective from ``distributed.collectives``'
per-call records (kind and output ndim) for the census.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# aten op names (the overload packet's) that block on the device or whose
# output shape is data dependent
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "nonzero_static",
                      "masked_select", "unique", "_unique", "_unique2",
                      "unique_dim", "unique_consecutive", "argwhere"})
# ops that move a tensor: a sync when source and destination devices differ
COPY_OPS = frozenset({"_to_copy", "copy_", "copy"})
# indexing ops: a sync when an index is a bool (or uint8) mask
INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                       "_index_put_impl_"})
MASK_DTYPES = (torch.bool, torch.uint8)


def op_name(func) -> str:
    """``aten.add.Tensor`` -> ``add``: the op's overload packet name."""
    packet = getattr(func, "overloadpacket", None)
    return getattr(packet, "__name__", str(func))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def _device_of(obj):
    return obj.device if isinstance(obj, torch.Tensor) else None


def host_sync_reason(func, args, kwargs, out) -> str:
    """Why this op call syncs the host ('' when it does not)."""
    name = op_name(func)
    if name in SYNC_OPS:
        return name
    if name in COPY_OPS:
        if name == "_to_copy":
            src = _device_of(args[0]) if args else None
            dst = out.device if isinstance(out, torch.Tensor) else None
        else:                                    # copy_(dst, src)
            dst = _device_of(args[0]) if args else None
            src = _device_of(args[1]) if len(args) > 1 else None
        if src is not None and dst is not None and src != dst:
            return f"{name} {src} -> {dst}"
        return ""
    if name in INDEX_OPS and len(args) > 1:
        for idx in _tensors(args[1]):
            if idx.dtype in MASK_DTYPES:
                return f"{name} with a {idx.dtype} mask"
    return ""


class OpRecorder(TorchDispatchMode):
    """Records every aten op a block dispatches (see the module docstring).

    ``ops``: op names in call order; ``dtypes``: the dtype names of every
    tensor an op produced; ``syncs``: (op, reason) for each host-sync op.
    """

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []
        self.dtypes: set = set()
        self.syncs: List[Tuple[str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(str(func))
        for t in _tensors(out):
            self.dtypes.add(str(t.dtype).replace("torch.", ""))
        why = host_sync_reason(func, args, kwargs, out)
        if why:
            self.syncs.append((str(func), why))
        return out


def _kernel_modules():
    from repro_torch.kernels import (bucketize, classical_lookup,
                                     decode_attention, ensemble_lookup,
                                     evict, stream_update)
    return (ensemble_lookup, classical_lookup, bucketize, stream_update,
            evict, decode_attention)


def kernel_launches() -> Dict[str, int]:
    """Every hand-written kernel's launch count, by kernel (B1 ``matmul``,
    B2 ``compare``, B7 ``loop``, B3 ``classical``, B4 ``bucketize``, B5
    ``stream_update``, B6 ``evict_fill``, B8 ``decode_attention``)."""
    out: Dict[str, int] = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def reset_kernel_launches() -> None:
    """Every kernel wrapper's launch count back to 0."""
    for mod in _kernel_modules():
        mod.reset_launches()


def launch_delta(before: Dict[str, int],
                 after: Dict[str, int]) -> Dict[str, int]:
    """The kernels launched between two ``kernel_launches`` reads (the
    ones that launched at all)."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def collective_census(calls) -> Dict[str, int]:
    """kind -> count over ``distributed.collectives.calls()`` records."""
    census: Dict[str, int] = {}
    for kind, _ in calls:
        census[kind] = census.get(kind, 0) + 1
    return census


def readout_count(calls, kind: str) -> int:
    """Calls of ``kind`` whose output is rank >= 2: the readout merges
    (the dispatch buffer's psum, the lane slab's reduce-scatter), not the
    scalar counts or the lane vectors."""
    return sum(1 for k, ndim in calls if k == kind and ndim >= 2)
