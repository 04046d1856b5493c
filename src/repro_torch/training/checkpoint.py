"""Checkpointing with a manifest and atomic publish.

Port of ``repro/training/checkpoint.py``, in the reference's on-disk
format, so a checkpoint written by either package restores into the
other:

  <dir>/step_<N>.tmp/            written first
      manifest.json              step, leaf index (name, file, shape, dtype)
      leaf_<i>.npy               one array a leaf, in jax.tree.flatten order
  <dir>/step_<N>/                atomic rename on completion (the publish)
  <dir>/LATEST                   text file with the newest published step

A leaf's name is its path, dict keys and list / tuple indices joined by
``/`` (the reference's ``_tree_paths``); restore matches leaves by name.

Fault-tolerance properties:
  * a crash mid-write never corrupts a published checkpoint (tmp + rename);
  * the async writer overlaps serialization with training (the step only
    blocks on the previous snapshot's completion).

``restore_checkpoint`` takes a ``device``, or the reference's
``shardings``: a tree of ``distributed.sharding.NamedSharding`` that places
each leaf as a ``DTensor`` on its mesh. That is the elastic path: the
writer's mesh does not matter, since a checkpoint holds whole arrays (a
``DTensor`` leaf is gathered whole when it is saved), and each rank reads
the whole ``.npy`` and keeps its own slice, with no collective.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.device import resolve_device
from repro_torch.models.transformer import tree_map
from repro_torch.training.optim import tree_flatten, tree_unflatten


def _tree_paths(tree):
    flat = tree_flatten(tree)
    names = ["/".join(str(k) for k in path) for path, _ in flat]
    return names, [leaf for _, leaf in flat]


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf, which later in-place updates do not reach
    (``.cpu()`` of a CPU tensor, and ``np.asarray``, would share it); a
    ``DTensor`` is gathered whole."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3):
    """Blocking save with atomic publish. Leaves are tensors (any device)
    or numpy arrays."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    names, leaves = _tree_paths(tree)
    index = []
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        arr = _host(leaf)
        fn = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fn), arr)
        index.append({"name": name, "file": fn,
                      "shape": list(arr.shape), "dtype": str(arr.dtype)})
    manifest = {"step": step, "n_leaves": len(index), "leaves": index,
                "format": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))
    _gc(directory, keep)
    return final


def _gc(directory, keep):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _place(arr: np.ndarray, sh, dtype) -> DTensor:
    """This rank's slice of the whole array ``arr``, as a ``DTensor``
    placed by the ``NamedSharding`` ``sh``: sliced on the host, then moved
    to the mesh's device (no collective)."""
    from repro_torch.distributed.sharding import mesh_device
    shape, offset = compute_local_shape_and_global_offset(
        arr.shape, sh.mesh, sh.placements)
    local = arr[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    t = torch.from_numpy(np.array(local, copy=True)).to(
        device=mesh_device(sh.mesh), dtype=dtype)
    return DTensor.from_local(t, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(arr.shape),
                              stride=torch.empty(arr.shape,
                                                 device="meta").stride())


def restore_checkpoint(directory: str, tree_like, *,
                       step: Optional[int] = None, device=None,
                       shardings=None):
    """Restore into the structure of ``tree_like`` (a tree of tensors, meta
    tensors allocating nothing). -> (tree, step).

    Each leaf takes ``tree_like``'s dtype and lands on ``device``, or with
    device=None on its ``tree_like`` leaf's device (CUDA for a meta leaf).
    ``shardings``: a matching tree of ``NamedSharding``; each leaf then is a
    ``DTensor`` holding this rank's slice on its mesh's device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names, leaves = _tree_paths(tree_like)
    flat_sh = ([leaf for _, leaf in tree_flatten(shardings)]
               if shardings is not None else [None] * len(leaves))
    by_name = {e["name"]: e for e in manifest["leaves"]}
    out = []
    for name, ref, sh in zip(names, leaves, flat_sh):
        e = by_name[name]
        arr = np.load(os.path.join(d, e["file"]))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(ref.shape)}")
        if sh is not None:
            out.append(_place(arr, sh, ref.dtype))
            continue
        dev = device
        if dev is None:
            dev = None if ref.device.type == "meta" else ref.device
        t = torch.from_numpy(arr)
        out.append(t.to(device=resolve_device(dev), dtype=ref.dtype))
    return tree_unflatten(tree_like, out), step


class AsyncCheckpointer:
    """One-deep async writer: snapshot on host, write in a thread. The
    snapshot is a copy, so the optimizer may update the tree in place
    while the thread writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree):
        self.wait()                       # at most one write in flight
        host_tree = tree_map(_host, tree)

        def work():
            self.last_path = save_checkpoint(self.directory, step, host_tree,
                                             keep=self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
