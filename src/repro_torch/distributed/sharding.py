"""Sharding: the language-model rules over a ('data', 'model') mesh, and
the flow-table mesh ('shard', 'data') of the streaming tier.

Port of ``repro/distributed/sharding.py``.

The language-model half places params, optimizer state, batches and
decode caches over a ``DeviceMesh`` with dims ('data', 'model'), or
('pod', 'data', 'model') across pods:

  pod    pure data parallelism across pods: params replicate across pods.
  data   FSDP: batch parallelism, and weights shard their *input* dim over
         'data' (DTensor gathers them where an op needs them whole, where
         GSPMD inserted the per-layer all-gather).
  model  tensor parallelism (heads, FFN columns, vocab) and expert
         parallelism (the MoE's expert dim).

A spec is ``P``: one entry a tensor dim, each an axis name, a tuple of
axis names (the dim split over all of them, the first outermost: ``P(("pod",
"data"))`` is pod-major, as in JAX) or None. ``placements`` turns it into
DTensor placements over a mesh. The rules are the reference's, by name
and shape: special cases for the embedding, the LM head, the expert
stacks and the per-head blocks, then "last dim -> model, second-to-last
-> data" for 2-D+ weights; a dim that does not divide its axis replicates
and 1-D leaves replicate. The rules read a mesh's dim sizes only, so they
take a ``DeviceMesh``, a ``{name: size}`` mapping or an object whose
``shape`` is one.

``shard_hint`` and ``hint_batch_heads`` are the reference's sharding hints
as ``DTensor.redistribute``: the model code calls them where GSPMD would
insert a resharding that DTensor refuses to infer (an unflatten of a
sharded dim that the head count does not divide, a gather along a sharded
dim). On a plain tensor, or a mesh of one device, they return their
argument, so a single-device path is unchanged.

The flow-table half builds the ('shard', 'data') mesh of the sharded
flow-table tier over one process per device. The reference builds a
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

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.device import resolve_device

MESH_DIMS = ("shard", "data")
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


# ---------------------------------------------------------------------------
# specs and placements
# ---------------------------------------------------------------------------

def _entry(e):
    """A spec entry as ``jax.sharding.PartitionSpec`` keeps it: a tuple of
    one axis is that axis, an empty tuple is None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P:
    """A partition spec: one entry a tensor dim (an axis name, a tuple of
    names, or None); trailing dims it does not name replicate. Equal to
    another ``P`` or a tuple with the same entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _dim_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a mapping, or an object whose
    ``shape`` is a mapping (the reference tests' stand-in)."""
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        return {n: mesh.size(i) for i, n in enumerate(names)}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def _axis(mesh, name: str) -> int:
    return _dim_sizes(mesh).get(name, 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _leading_nones(shape, n_tail):
    return (None,) * (len(shape) - n_tail)


def placements(mesh: DeviceMesh, spec) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: mesh dim j is
    ``Shard(i)`` when entry i names it (alone or in a tuple), else
    ``Replicate()``. A tuple entry shards its dim over its axes in mesh
    order, so the first axis is the outermost (pod-major). A mesh dim of
    one device splits nothing, so it takes ``Replicate()`` whatever the
    spec says: the same local tensors, and no redistribution for DTensor
    to plan between layouts that do not differ."""
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None:
                continue
            if ax not in names:
                raise ValueError(f"spec {spec!r} names {ax!r}, which the "
                                 f"mesh {names} does not have")
            j = names.index(ax)
            if mesh.size(j) > 1:
                out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list)) and not (
        isinstance(x, tuple) and not isinstance(x, torch.Size))


def map_with_path(fn, *trees, path=()):
    """``fn(path, *leaves)`` over trees of one structure (dicts, lists,
    tuples; a ``torch.Size`` and a ``P`` are leaves)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: map_with_path(fn, *(u[k] for u in trees), path=path + (k,))
                for k in t}
    if not _is_leaf(t):
        return type(t)(map_with_path(fn, *(u[i] for u in trees), path=path + (i,))
                       for i in range(len(t)))
    return fn(path, *trees)


def _shape(leaf):
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


# ---------------------------------------------------------------------------
# the language-model rules
# ---------------------------------------------------------------------------

def spec_for_param(path: str, shape, mesh, *, serve: bool = False) -> P:
    """serve=False (train): FSDP x TP; weights shard their input dim over
    'data' (gathered where used) and their output dim over 'model'.
    serve=True: TP only; weights replicate over 'data', so a decode step
    never pays the per-layer FSDP gather."""
    d_sz = _axis(mesh, "data")
    m_sz = _axis(mesh, "model")
    shape = _shape(shape)
    nd = len(shape)
    data_ax = None if serve else "data"

    # --- special cases ------------------------------------------------------
    if path.endswith("embed"):                       # (V, D): vocab -> model
        v, d = shape
        return P("model" if _div(v, m_sz) else None,
                 data_ax if (data_ax and _div(d, d_sz)) else None)
    if path.endswith("lm_head"):                     # (D, V)
        d, v = shape
        return P(data_ax if (data_ax and _div(d, d_sz)) else None,
                 "model" if _div(v, m_sz) else None)
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("w_gate", "w_up", "w_down") and nd >= 3:
        # expert stacks (..., E, D, F) / (..., E, F, D): experts -> model
        e, a, _ = shape[-3:]
        return P(*_leading_nones(shape, 3),
                 "model" if _div(e, m_sz) else None,
                 data_ax if (data_ax and _div(a, d_sz)) else None,
                 None)
    if leaf in ("wq", "wk", "wv") and nd >= 3 and shape[-1] == shape[-2]:
        # per-head block-diagonal stacks (..., H, hd, hd): heads -> model
        h = shape[-3]
        return P(*_leading_nones(shape, 3),
                 "model" if _div(h, m_sz) else None, None, None)

    # --- generic ------------------------------------------------------------
    if nd >= 2:
        a, b = shape[-2], shape[-1]
        return P(*_leading_nones(shape, 2),
                 data_ax if (data_ax and _div(a, d_sz)) else None,
                 "model" if _div(b, m_sz) else None)
    return P()                                        # 1-D: replicate


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def param_specs(params_or_shapes, mesh, *, serve: bool = False):
    """A ``P`` tree matching the param tree (leaves: tensors or shapes)."""
    return map_with_path(lambda path, leaf: spec_for_param(_path_str(path), leaf,
                                                  mesh, serve=serve),
                params_or_shapes)


def opt_state_specs(params_or_shapes, mesh):
    """Adam's m and v mirror the params' specs; the step replicates."""
    ps = param_specs(params_or_shapes, mesh)
    return {"m": ps, "v": ps, "step": P()}


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in _dim_sizes(mesh) else ("data",)


def batch_specs(mesh, batch_shapes, *, seq_shard: bool = False):
    """Specs for a train or prefill batch: the batch dim over (pod, data)
    when it divides (else over 'data' when that divides); with
    ``seq_shard`` the sequence dim over 'model'."""
    baxes = _batch_axes(mesh)
    bsz = math.prod(_axis(mesh, a) for a in baxes)
    m_sz = _axis(mesh, "model")

    def one(_, leaf):
        shape = _shape(leaf)
        b = shape[0]
        first = baxes if _div(b, bsz) else (
            "data" if _div(b, _axis(mesh, "data")) else None)
        rest = [None] * (len(shape) - 1)
        if seq_shard and len(shape) >= 2 and _div(shape[1], m_sz):
            rest[0] = "model"
        return P(first, *rest)

    return map_with_path(one, batch_shapes)


def cache_specs(mesh, cache_shapes, batch: int):
    """Decode-cache specs. The batch dim is found by its size (the
    serving batch is known), never by position: stacked segment caches
    carry a leading period dim. The batch dim goes to 'data' when it
    divides; then the largest other dim that divides goes to 'model'
    (the sequence of a KV ring, the width of a recurrent state)."""
    d_sz = _axis(mesh, "data")
    m_sz = _axis(mesh, "model")

    def one(_, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        spec = [None] * nd
        bdim = None
        if batch > 1:
            for i, s in enumerate(shape):
                if s == batch:
                    bdim = i
                    break
        if bdim is not None and _div(shape[bdim], d_sz):
            spec[bdim] = "data"
        cand = [i for i in range(nd) if i != bdim and spec[i] is None
                and _div(shape[i], m_sz) and shape[i] >= m_sz]
        if cand:
            best = max(cand, key=lambda i: shape[i])
            spec[best] = "model"
        return P(*spec)

    return map_with_path(one, cache_shapes)


def named_sharding_tree(mesh: DeviceMesh, spec_tree):
    return map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


def distribute_tree(tree, shardings):
    """Each tensor leaf as a ``DTensor`` placed by its ``NamedSharding``.
    Every rank holds the whole leaf and keeps its own slice, with no
    collective (``src_data_rank=None``); a leaf that already is a
    ``DTensor`` is redistributed."""
    def one(_, t, sh):
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(t, sh.mesh, sh.placements,
                                 src_data_rank=None)
    return map_with_path(one, tree, shardings)


# ---------------------------------------------------------------------------
# hints: explicit reshardings in the model code
# ---------------------------------------------------------------------------

def _pin(x, want):
    """``x`` redistributed to ``want``, even when it is already there: the
    redistribute's backward then lays the grad out as ``x`` was, as the
    transpose of a sharding constraint constrains the cotangent."""
    return x.redistribute(x.device_mesh, tuple(want))


def is_sharded(x) -> bool:
    """A ``DTensor`` on a mesh of several devices."""
    return isinstance(x, DTensor) and x.device_mesh.size() > 1


def shard_hint(x, *spec):
    """``x`` laid out as ``spec`` over its own mesh, in the forward and (for
    its grad) in the backward: the reference's best-effort
    ``with_sharding_constraint``. Returns ``x`` itself for a plain tensor,
    a mesh of one device, a spec whose rank is not the tensor's or that
    names an axis the mesh lacks, or a dim that does not divide its axes
    (each of which makes the reference's constraint a no-op or an error it
    swallows)."""
    if not is_sharded(x) or len(spec) != x.ndim:
        return x
    sizes = _dim_sizes(x.device_mesh)
    for n, entry in zip(x.shape, spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = [a for a in axes if a is not None]
        if any(a not in sizes for a in axes) or not _div(
                n, math.prod(sizes[a] for a in axes)):
            return x
    return _pin(x, placements(x.device_mesh, spec))


def _batch_entry(sizes: dict, n: int):
    """The spec entry of a batch dim of size ``n``: the batch axes when it
    divides them, else 'data' when it divides that, else None."""
    baxes = _batch_axes(sizes)
    if n % math.prod(sizes[a] for a in baxes) == 0:
        return baxes
    return "data" if n % sizes["data"] == 0 else None


def hint_batch_heads(x, heads_dim: int = 2):
    """Pin a (B, S, H, hd)-like activation: batch over the batch axes (or
    'data'), heads over 'model' when they divide, the rest whole. No-op
    without a mesh."""
    if not is_sharded(x):
        return x
    sizes = _dim_sizes(x.device_mesh)
    spec = [None] * x.ndim
    spec[0] = _batch_entry(sizes, x.shape[0])
    if heads_dim < x.ndim and x.shape[heads_dim] % sizes["model"] == 0:
        spec[heads_dim] = "model"
    return shard_hint(x, *spec)


def hint_batch(x):
    """Pin an activation's batch dim over the batch axes (or 'data'), the
    rest whole. No-op without a mesh."""
    return hint_batch_heads(x, heads_dim=x.ndim)


def gather_data(tree):
    """Every ``DTensor`` leaf with its 'pod' and 'data' shards gathered
    (FSDP's gather of a layer's weights before the layer runs, which GSPMD
    inserts by itself), and a 1-D leaf (a norm's gain, a bias) gathered
    whole, where GSPMD gathers the small operand of an elementwise op. The
    backward reduce-scatters the grads back to the leaves' layout. Plain
    leaves are returned as they are."""
    def one(_, t):
        if not is_sharded(t):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        want = tuple(Replicate() if isinstance(p, Shard) and (
            t.ndim <= 1 or names[i] in ("pod", "data")) else p
            for i, p in enumerate(t.placements))
        if want == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)
    return map_with_path(one, tree)


def dense(x, w):
    """``x @ w`` for a weight ``w`` (input dim second-to-last). On a mesh
    ``x`` is first laid out for it: its batch dim over the batch axes, its
    contraction dim split as ``w``'s input dim is (over 'model' for a
    row-parallel weight, else whole), the rest whole; so the product runs on
    each device's slice of the work, where DTensor would rather gather the
    weight and compute the whole product on every device. Plain tensors
    multiply as they are."""
    if is_sharded(x) and is_sharded(w):
        names = w.device_mesh.mesh_dim_names
        spec = [None] * x.ndim
        if x.ndim >= 2:
            spec[0] = _batch_entry(_dim_sizes(x.device_mesh), x.shape[0])
        row = tuple(names[j] for j, p in enumerate(w.placements)
                    if isinstance(p, Shard) and p.dim == w.ndim - 2)
        if row:
            spec[-1] = row if len(row) > 1 else row[0]
        x = shard_hint(x, *spec)
    return x @ w


class _Reshape(torch.autograd.Function):
    """A ``DTensor`` reshape whose backward is a reshape too (``reshape``,
    of a contiguous grad), where a view's backward views a grad that a
    redistribute may hand it strided."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return reshape(g.contiguous(), *ctx.shape), None


def reshape(x, *shape):
    """``x.reshape(shape)``, which on a ``DTensor`` also holds where
    DTensor refuses the view: an unflatten or flatten of a sharded dim
    whose outer factor does not divide its axis (a head count that does
    not divide 'model'), where GSPMD reshards by itself. Then the dims
    past the shapes' common prefix are gathered first. The result is
    pinned to its layout, so its grad comes back in a layout the view's
    backward takes."""
    if not is_sharded(x):
        return x.reshape(*shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    try:
        y = _Reshape.apply(x, shape)
    except RuntimeError:
        # DTensor's view propagation refused the layout (an uneven
        # unflatten); gather what the view reorganizes and retry
        keep = 0
        while (keep < min(x.ndim, len(shape)) - 1
               and x.shape[keep] == shape[keep]):
            keep += 1
        want = tuple(p if isinstance(p, Shard) and p.dim < keep
                     else (p if p.is_partial() else Replicate())
                     for p in x.placements)
        y = _Reshape.apply(_pin(x, want), shape)
    return _pin(y, y.placements)


def per_shard(fn, *xs, heads=True, params=()):
    """``fn(*params, *xs)`` for an ``fn`` that is independent along the
    batch dim of its operands (and, with ``heads``, along their head dim
    2: attention): on a ``DTensor`` mesh of several devices each operand
    is laid out by ``hint_batch_heads`` (``hint_batch`` without ``heads``)
    and ``fn`` runs on each device's shards, as an SPMD partitioner runs
    it. ``params`` are weights ``fn`` reads whole on every device; their
    grads are partial sums over the axes the operands are split on. The
    result (a tensor, or a tuple or dict of tensors whose dim 0 is the
    batch) is laid out as the operands. Plain operands go straight to
    ``fn``."""
    if not is_sharded(xs[0]):
        return fn(*params, *xs)
    xs = [hint_batch_heads(x) if heads else hint_batch(x) for x in xs]
    mesh = xs[0].device_mesh
    lay = tuple(xs[0].placements)
    if any(tuple(x.placements) != lay for x in xs):
        raise ValueError(f"per_shard: operands laid out differently: "
                         f"{[tuple(x.placements) for x in xs]}")
    split = tuple(Partial() if isinstance(p, Shard) else Replicate()
                  for p in lay)
    whole = [w.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=split) for w in params]
    out = fn(*whole, *[x.to_local() for x in xs])
    return map_with_path(lambda _, t: DTensor.from_local(
        t, mesh, lay, run_check=False), out)


def write_row_(x, dim: int, index, source):
    """``x.index_copy_(dim, index, source)`` for a one-element ``index`` (a
    decode step's cache slot), in place. On a ``DTensor`` whose ``dim`` is
    sharded each device writes its own shard: the row at the slot's local
    index (clamped into the shard), which becomes ``source`` where the
    shard holds the slot and keeps its old value where it does not. All
    device ops, with no host read of the slot."""
    if not isinstance(x, DTensor):
        return x.index_copy_(dim, index, source)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = x.device_mesh
    dim = dim % x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in x.placements)
    if isinstance(source, DTensor):
        src = source.redistribute(mesh, want).to_local()
    else:
        src = source
    idx = index.full_tensor() if isinstance(index, DTensor) else index
    local = x.to_local()
    n, offset = compute_local_shape_and_global_offset(x.shape, mesh,
                                                      x.placements)
    lo, n = offset[dim], n[dim]
    at = torch.clamp(idx - lo, 0, max(n - 1, 0))
    if n:
        mine = (idx >= lo) & (idx < lo + n)
        old = local.index_select(dim, at)
        shape = [1] * local.ndim
        local.index_copy_(dim, at, torch.where(mine.reshape(shape), src,
                                               old))
    return x


def lay_as(x, ref):
    """``x`` laid out as ``ref`` (both ``DTensor`` s of one shape); a plain
    ``x`` is returned as it is."""
    if not isinstance(x, DTensor) or tuple(x.placements) == tuple(
            ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def settle(x):
    """``x`` with every pending reduction done: a ``DTensor``'s partial
    placements (a sum split over ranks) made whole. A plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``, which on a ``DTensor`` runs on
    the local shard (settled first): for an op DTensor has no sharding
    strategy for, forward or backward (``log_sigmoid_backward``)."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = settle(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def replicate_dim(x, dim: int):
    """``x`` with ``dim`` whole on every rank (a ``DTensor``'s shards of it
    gathered): what an ``unbind``, a gather or a slice along that dim
    needs under DTensor. A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


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
            f"the default process group runs {backend!r}; a mesh on "
            f"{dev.type} needs {BACKENDS[dev.type]!r}")


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
