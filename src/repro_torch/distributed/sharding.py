"""The flow-table mesh: ('shard', 'data') over one process per device.

Port of the flow-table half of ``repro/distributed/sharding.py``
(``flow_shard_mesh``, ``as_flow_mesh``). The reference builds a
``jax.sharding.Mesh`` over every local device of one process. Here each
device is a process of its own (``torchrun --nproc-per-node N``), the
processes are joined by ``torch.distributed`` (NCCL on the card, gloo on
the CPU), and the mesh is a ``DeviceMesh`` over the default group's ranks,
shard-major:

    rank = s * n_data + d

'shard' partitions the flow-table buckets (shard s owns the buckets with
``bucket % n_shards == s``); 'data' parallelizes the classify lanes and the
backend slices, and the registers are replicated along it. The tier's
all-gathers concatenate in rank order, which is this order, so a gathered
lane vector comes back in lane order.

A one-device mesh needs no launcher: with no default group,
``flow_shard_mesh`` starts a one-rank group from an in-memory store (gloo
on the CPU, NCCL on CUDA), the counterpart of the reference's "every local
device" default. A mesh of more devices needs one process per device,
already joined. A flow-table mesh spans every rank of the default group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

MESH_DIMS = ("shard", "data")
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def _start_one_rank_group(dev: torch.device) -> None:
    """A one-rank default group from an in-memory store. On the card the
    group is bound to the device, so NCCL's communicator exists before the
    first step (and before any CUDA graph captures a collective)."""
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device(
            "cuda", torch.cuda.current_device() if dev.index is None
            else dev.index)
    dist.init_process_group(BACKENDS[dev.type], store=dist.HashStore(),
                            rank=0, world_size=1, **kw)


def _check_group(dev: torch.device) -> None:
    backend = dist.get_backend()
    if BACKENDS[dev.type] not in backend:       # e.g. "cpu:gloo,cuda:nccl"
        raise ValueError(
            f"the default process group runs {backend!r}; a flow-table "
            f"mesh on {dev.type} needs {BACKENDS[dev.type]!r}")


def flow_shard_mesh(n_shards: Optional[int] = None, n_data: int = 1, *,
                    device=None) -> DeviceMesh:
    """The (n_shards, n_data) ('shard', 'data') mesh of the sharded
    flow-table tier, on ``device``'s type (None: CUDA, raising without a
    card).

    n_shards=None takes every rank of the default group not consumed by
    'data' (one when no group exists yet). With no default group a
    one-device mesh starts a one-rank group; a larger one raises and asks
    for one process per device. The mesh must span the default group.
    """
    dev = resolve_device(device)
    if n_data < 1 or (n_shards is not None and n_shards < 1):
        raise ValueError(f"mesh dims must be >= 1, got n_shards={n_shards}, "
                         f"n_data={n_data}")
    if not dist.is_initialized():
        n = (n_shards or 1) * n_data
        if n != 1:
            raise RuntimeError(
                f"a flow-table mesh of {n} devices needs one process per "
                f"device, joined in a torch.distributed group: start them "
                f"with `torchrun --nproc-per-node {n} ...` (or call "
                f"init_process_group in each) before building the mesh")
        _start_one_rank_group(dev)
    _check_group(dev)
    world = dist.get_world_size()
    if n_shards is None:
        n_shards = max(1, world // n_data)
    if n_shards * n_data != world:
        raise ValueError(
            f"a ({n_shards}, {n_data}) flow-table mesh needs "
            f"{n_shards * n_data} ranks; the default group has {world}")
    return init_device_mesh(dev.type, (n_shards, n_data),
                            mesh_dim_names=MESH_DIMS)


def as_flow_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """Normalize a flow-table mesh to the 2D ('shard', 'data') form.

    A 1D ('shard',) mesh gains a size-1 'data' dim (the same ranks, the
    same shard blocks); a ('shard', 'data') mesh passes through; anything
    else raises ValueError."""
    names = tuple(mesh.mesh_dim_names or ())
    if names == MESH_DIMS:
        return mesh
    if names == ("shard",):
        return DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1, 1),
                          mesh_dim_names=MESH_DIMS)
    raise ValueError(f"flow-table mesh must have dims ('shard',) or "
                     f"('shard', 'data'), got {names}")


def mesh_group(mesh: DeviceMesh):
    """The process group over every device of the mesh (the all-gathers'
    ('shard', 'data') group): the default group, which the mesh spans."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a flow-table mesh spans the default group's "
                         f"{dist.get_world_size()} ranks, this one "
                         f"{mesh.size()}")
    return dist.group.WORLD


def mesh_rank(mesh: DeviceMesh) -> int:
    """This device's index in ('shard', 'data') order: s * n_data + d."""
    return (mesh.get_local_rank("shard") * mesh.size(1)
            + mesh.get_local_rank("data"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank serves on: the CPU, or its current card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
