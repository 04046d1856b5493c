"""The sharded tier's collectives, each counted by kind.

``psum`` (all-reduce SUM), ``psum_scatter`` (reduce-scatter along dim 0,
tiled), ``all_gather`` (along dim 0) and ``broadcast``, over a process
group. Each call adds one to ``COUNTS[kind]`` where it issues its
collective and nowhere else, so a census of a step (``reset_counts``
before it, ``counts`` after) reads what the step sends between devices:
the counterpart of the reference's hot-path census
(``repro/serving/shard_serving.py`` ``AUDIT_CONTRACTS``). Inside a CUDA
graph the count is taken when the step is captured, not at each replay,
as the kernels' launch counts are. ``CALLS`` keeps one record a call as well,
(kind, the output's ndim), so a census can tell the rank >= 2 "readout"
merges (rows) from the scalar and vector ones (the counterpart of the
reference auditor's ``_readout_psum_count``).

NCCL has no bool: a bool tensor crosses as uint8 and comes back bool (a
psum of masks is then their logical or).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"psum": 0, "reduce_scatter": 0, "all_gather": 0, "broadcast": 0}
CALLS: list = []        # (kind, output ndim), one a call, in call order

# the names the running torch offers (torch 2.13 deprecates the *_tensor
# forms in favour of the *_single ones); nowhere else picks
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    CALLS.clear()


def counts() -> dict:
    return dict(COUNTS)


def calls() -> list:
    """The (kind, output ndim) records since the last ``reset_counts``."""
    return list(CALLS)


def _count(kind: str, out: torch.Tensor) -> None:
    COUNTS[kind] += 1
    CALLS.append((kind, out.dim()))


def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()


def _back(y: torch.Tensor, dtype) -> torch.Tensor:
    return y.bool() if dtype == torch.bool else y


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    y = _wire(x).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    _count("psum", y)
    return _back(y, x.dtype)


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter along dim 0, tiled: the group's rank i gets rows
    [i*n/G, (i+1)*n/G) of the sum over ranks (n divisible by G)."""
    g = dist.get_world_size(group)
    if x.shape[0] % g:
        raise ValueError(f"{x.shape[0]} rows do not scatter over {g} ranks")
    w = _wire(x)
    out = torch.empty((x.shape[0] // g,) + tuple(x.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _REDUCE_SCATTER(out, w, group=group)
    _count("reduce_scatter", out)
    return _back(out, x.dtype)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group-rank order."""
    g = dist.get_world_size(group)
    w = _wire(x)
    out = torch.empty((g * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _ALL_GATHER(out, w, group=group)
    _count("all_gather", out)
    return _back(out, x.dtype)


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """The group's first rank's ``x`` (of one shape and dtype on every
    rank) on every rank; written into ``x`` when it is contiguous and not
    bool."""
    w = _wire(x)
    dist.broadcast(w, src=dist.get_process_group_ranks(group)[0],
                   group=group)
    _count("broadcast", w)
    return _back(w, x.dtype)
