"""Production mesh construction.

Port of ``repro/launch/mesh.py``.

Single pod: (data=16, model=16), 256 devices.
Multi-pod:  (pod=2, data=16, model=16), 512 devices; the 'pod' axis carries
pure data parallelism (params replicated across pods, gradients reduced
over ('pod', 'data')).

A mesh is a ``DeviceMesh`` over the default process group, one process a
device. ``fake_group`` starts a group of N ranks in one process with
PyTorch's fake backend, whose collectives move nothing: the counterpart of
the reference's 512 placeholder host devices, on which the dry run places
``meta`` tensors and runs a step once.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import _check_group, _start_one_rank_group

LM_DIMS = ("data", "model")


def _device_type() -> str:
    """The mesh's device type for the running default group: the card's
    for NCCL, else the CPU (gloo, and the fake backend's meta tensors)."""
    return "cuda" if "nccl" in dist.get_backend() else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model'),
    over the default group, which must have 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod",) + LM_DIMS if multi_pod else LM_DIMS
    n = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production mesh "
                           f"needs a default group of {n} ranks (have "
                           f"{have}); the dry run starts one with "
                           f"fake_group({n})")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """The degenerate (1, 1) ('data', 'model') mesh for one-device runs of
    mesh-aware code, on ``device``'s type (None: CUDA, raising without a
    card). With no default group it starts a one-rank group (gloo on the
    CPU, NCCL bound to the card), as ``flow_shard_mesh`` does; a running
    group must have one rank."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_one_rank_group(dev)
    _check_group(dev)
    if dist.get_world_size() != 1:
        raise ValueError(f"a (1, 1) mesh needs a one-rank group; the default "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=LM_DIMS)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default group of ``world_size`` ranks in this process (rank 0),
    on PyTorch's fake backend: its collectives return at once and move no
    data, so a step over ``meta`` tensors runs on a mesh of that size. The
    group is destroyed on the way out. Raises if a group already runs."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group needs a process with no default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
