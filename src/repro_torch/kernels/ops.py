"""Public wrappers over the kernels: routing, the shared-memory fit check,
and the scalar epilogues that turn kernel outputs into (pred, confidence).

Port of ``repro/kernels/ops.py``: batch classify, the streaming wrappers
(``pad_window``, ``evict_fill``, ``timeout_sweep``, ``stream_update``) and
the int8-KV decode attention of the LM backend (``decode_attention_int8``).
Routing follows ``device.on_kernel_path``: on a CUDA tensor each wrapper
launches the hand-written kernel, on a CPU tensor it runs the kernel's
plain version.
``TileConfig.impl='loop'`` runs the per-feature-loop kernel (B7) on a CUDA
tensor and its plain version on a CPU tensor. ``TileConfig.impl='ref'`` and
``use_kernel=False`` run the plain gather version on either device, and
only when the caller sets them.

The reference's VMEM fit check (``VMEM_BUDGET_BYTES``, a TPU v5e figure)
becomes a shared-memory fit check: it decides whether the kernel stages the
tables in shared memory or reads them from global memory, and never routes
away from the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.artifact import (TableArtifact, build_dtable_flat,
                                       flatten_ftable, flatten_vtable,
                                       pad_dtable)
from repro_torch.core.inference import classical_aggregate
from repro_torch.device import resolve_device, true_div
from repro_torch.kernels import bucketize as _bk
from repro_torch.kernels import classical_lookup as _ck
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ensemble_lookup as _ek
from repro_torch.kernels import evict as _ev
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import stream_update as _su
from repro_torch.kernels.tuning import DEFAULT_TILES, TileConfig


def _pad_batch(x: torch.Tensor, tile: int):
    """Pad N up to a tile multiple by replicating the last valid row.

    Replication (not zeros) keeps every padded lane on a real sample: a zero
    row is out-of-distribution for the tables and could perturb telemetry
    computed before slicing. The CUDA kernel masks its ragged last block, so
    batch classify needs no padding; ``pad_window`` pads windows with this.
    """
    n = x.shape[0]
    pad = (-n) % tile
    if pad:
        x = torch.cat([x, x[n - 1:n].expand((pad,) + tuple(x.shape[1:]))])
    return x, n


def pad_window(cols, tile: int):
    """Tile-pad per-packet columns to a multiple of ``tile``.

    ``cols`` is a dict, list or tuple of tensors sharing leading length W0;
    returns (padded_cols of the same kind, valid (Wp,) bool, n). Pad lanes
    replicate the last packet (in-distribution, as ``_pad_batch``) and
    carry valid=False, so register updates and telemetry mask them out
    exactly. A ragged final window then has the window's size, as every
    other window.
    """
    leaves = list(cols.values()) if isinstance(cols, dict) else list(cols)
    n = leaves[0].shape[0]
    pad = (-n) % tile
    if pad:
        padded = [_pad_batch(a, tile)[0] for a in leaves]
        cols = (dict(zip(cols, padded)) if isinstance(cols, dict)
                else type(cols)(padded))
    valid = torch.arange(n + pad, device=leaves[0].device) < n
    return cols, valid, n


def evict_fill(regs, mask, fills, *, use_kernel=None) -> torch.Tensor:
    """Masked register reset: the eviction sweep's scatter (B6).

    regs (R, N) f32 stacked register file, mask (N,) bool (True = evict),
    fills (R,) per-register reset identities -> a new (R, N) tensor.
    Evicted columns take their fill value, surviving columns pass through
    bit for bit. The CUDA kernel for a CUDA tensor, the plain ``where`` for
    a CPU tensor; use_kernel=False takes the plain version on either.
    """
    if use_kernel is False:
        return _ev.evict_fill_ref(regs, mask, fills)
    return _ev.evict_fill(regs, mask, fills)


def timeout_sweep(regs, ts, valid, evict_age, fills, *, out=None):
    """The timeout sweep of one window in one call (B6's second entry).

    regs (8, N) f32 stacked register file; ts (W,) f32 and valid (W,) bool
    the window's columns; fills (8,) -> (regs, n_evicted i32): every
    occupied column last seen before ``evict_cutoff(ts, valid, evict_age)``
    reset to its fills. The CUDA kernel for a CUDA tensor (it updates
    ``regs`` in place and returns it), the plain composition
    (``evict.timeout_sweep_ref``) for a CPU tensor (new tensors). ``out``
    (an int32 scalar) receives n_evicted in place of a new tensor.
    """
    return _ev.timeout_sweep(regs, ts, valid, evict_age, fills, out=out)


def stream_update(regs, bucket, ts, length, is_fwd, valid, *, limit=None):
    """Streaming register scatter + clamp + touched-row gather (B5).

    regs (8, N) f32 stacked register file (``netsim.stream.
    REGISTER_FIELDS`` order); bucket/ts/length/is_fwd/valid the (W,)
    window columns -> (new_regs (8, N), rows (8, W)): the window folded
    into the registers (count registers clamped at ``limit`` when given,
    the 2^24 overflow guard) and each lane's updated register row. The
    CUDA kernel for a CUDA tensor (it updates ``regs`` in place and
    returns it), the plain version for a CPU tensor (new tensors).
    """
    return _su.stream_update(regs, bucket, ts, length, is_fwd, valid,
                             limit=limit)


def decode_attention_int8(q, k_q, k_s, v_q, v_s, valid, *,
                          scale: float) -> torch.Tensor:
    """Int8-KV GQA decode attention (B8), the attention core of the
    quantized ``models.attention.gqa_decode``.

    q (B,G,M,hd) f32; k_q/v_q (B,S,G,hd) int8 in the cache's own layout;
    k_s/v_s (B,S,G,1) f32 per-slot scales; valid (B,S) f32 -> (B,G,M,hd)
    f32. The CUDA kernel for a CUDA tensor (it raises on operands it does
    not take), the dense plain version for a CPU tensor.
    """
    return _da.decode_attention_int8(q, k_q, k_s, v_q, v_s, valid,
                                     scale=scale)


def _flat_tree_tables(art: TableArtifact, vote: bool):
    """Pre-flattened tables from the artifact, or flattened on the fly."""
    if art.ftable_flat is not None:
        return art.ftable_flat, art.dtable_flat, art.dtable_pad
    dtable = art.dtable_class if vote else art.dtable_value.q
    return (flatten_ftable(art.ftable, art.strides),
            build_dtable_flat(dtable, art.n_classes, vote),
            pad_dtable(dtable))


def tree_tables_smem_bytes(art: TableArtifact,
                           tiles: TileConfig = None) -> int:
    """Shared memory a staged launch needs for this artifact: the edges, the
    flat feature table and the one decision table the chosen select reads,
    plus what that select's kernel keeps per block
    (``ensemble_lookup.smem_bytes``)."""
    tiles = tiles or DEFAULT_TILES
    ftable_flat, dtable_flat, _ = _flat_tree_tables(art, art.agg == "vote")
    f, u = art.edges.shape
    fb, t_pad = ftable_flat.shape
    cout, t, s_pad = dtable_flat.shape
    select = _ek.resolve_select(tiles.select, t, s_pad, cout)
    return _ek.smem_bytes(f, u, fb // f, t_pad, t, s_pad, cout, select,
                          "all", tiles.tile_n)


def _flat_vtable(art: TableArtifact) -> torch.Tensor:
    return (art.vtable_flat if art.vtable_flat is not None
            else flatten_vtable(art.vtable.q))


def classical_tables_smem_bytes(art: TableArtifact,
                                tiles: TileConfig = None) -> int:
    """Shared memory a staged classical launch needs: the edges and the
    value table's live columns, plus what the kernel keeps per block
    (``classical_lookup.smem_bytes``)."""
    tiles = tiles or DEFAULT_TILES
    f, u = art.edges.shape
    return _ck.smem_bytes(f, u, _flat_vtable(art).shape[0] // f,
                          art.vtable.q.shape[2], "all", tiles.tile_n)


def fits_smem(art: TableArtifact, tiles: TileConfig = None) -> bool:
    """True when the kernel that ``tiles`` picks stages every table of this
    artifact in shared memory (same kernel, same result either way). On
    False the loop kernel reads every table from global memory, while the
    fused tree lookup may still stage the edges and the feature table and
    the classical lookup the edges, reading the rest from global memory
    (``ensemble_lookup.stage_mode`` and ``classical_lookup.stage_mode`` say
    which)."""
    tiles = tiles or DEFAULT_TILES
    if art.ftable is None:
        return classical_tables_smem_bytes(art, tiles) <= _ek.SMEM_BUDGET_BYTES
    if tiles.impl == "loop":
        f, u = art.edges.shape
        t, s = art.dtable_class.shape
        return _ek.loop_fits_smem(f, u, t, s, tiles.tile_n)
    return tree_tables_smem_bytes(art, tiles) <= _ek.SMEM_BUDGET_BYTES


def bucketize(x, edges, *, device=None) -> torch.Tensor:
    """Public range match: x (N, F), edges (F, U) (+inf padded) -> (N, F)
    int32 bins. device=None runs the kernel on CUDA (raising without a
    card); pass device="cpu" for the plain version."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    edges = torch.as_tensor(edges, dtype=torch.float32, device=dev).contiguous()
    return _bk.bucketize(x, edges)


# ---------------------------------------------------------------------------
# fused classify
# ---------------------------------------------------------------------------

def _tree_epilogue(art: TableArtifact, out: torch.Tensor):
    if art.agg == "vote":
        pred = torch.argmax(out, dim=1)
        conf = true_div(out.max(dim=1).values, art.n_trees)
        return pred, conf
    total = out[:, 0] / art.dtable_value.scale
    if art.agg == "wsum_sigmoid":
        p1 = torch.sigmoid(art.base_score + art.learning_rate * total)
        return (p1 > 0.5).to(torch.int32), torch.maximum(p1, 1.0 - p1)
    if art.agg == "iforest":
        n = torch.full((), art.iforest_subsample, dtype=torch.float32,
                       device=out.device)
        cfac = 2.0 * (torch.log(n - 1.0) + 0.5772156649) - 2.0 * (n - 1.0) / n
        score = torch.pow(2.0, -true_div(total, art.n_trees) / cfac)
        return (score > 0.5).to(torch.int32), torch.maximum(score, 1.0 - score)
    raise ValueError(art.agg)


def pred_dtype(art: TableArtifact) -> torch.dtype:
    """The dtype of ``fused_classify``'s predictions for this artifact:
    int32 where the epilogue thresholds a score (sum ensembles, the
    isolation forest), int64 where it takes an arg max or min (votes and
    the classical families). The reference's are int32 throughout
    (ROADMAP C3)."""
    return torch.int32 if art.agg in ("wsum_sigmoid", "iforest") \
        else torch.int64


def _classical_epilogue(art: TableArtifact, out: torch.Tensor):
    return classical_aggregate(art, out / art.vtable.scale)


def classify_batch_rows(art: TableArtifact, n: int, *,
                        tiles: TileConfig = None) -> int:
    """Rows ``fused_classify`` processes for an n-row batch: exactly n on
    every route ('loop' too), since the CUDA kernels mask their ragged last
    block instead of padding the batch as the reference's TPU grid had to."""
    return n


def fused_classify(art: TableArtifact, x, *, tiles: TileConfig = None,
                   device=None):
    """(pred, confidence) through the fused kernel path.

    device=None runs on CUDA (and raises without a card); pass
    device="cpu" for the plain path. ``tiles.impl``: 'fused' (the fused
    CUDA kernel B1/B2 on the card), 'loop' (the per-feature-loop CUDA kernel
    B7 on the card; tree artifacts only), each its plain version on the CPU;
    'ref' (the plain gather version on either). All are bit-identical.
    """
    tiles = tiles or DEFAULT_TILES
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    art = art.to(dev)
    impl = tiles.impl
    if impl not in ("fused", "loop", "ref"):
        raise ValueError(f"impl must be fused|loop|ref, got {impl!r}")

    if art.ftable is not None:
        vote = art.agg == "vote"
        if impl == "fused":
            ftable_flat, dtable_flat, dtable_pad = _flat_tree_tables(art, vote)
            out = _ek.ensemble_lookup_fused(
                x, art.edges, ftable_flat, dtable_flat, dtable_pad,
                select=tiles.select, tile_n=tiles.tile_n)
        else:
            dtable = (art.dtable_class if vote else art.dtable_value.q)
            args = (x, art.edges, art.ftable, art.strides,
                    dtable.to(torch.float32))
            if impl == "loop":
                out = _ek.ensemble_lookup_loop(*args, n_classes=art.n_classes,
                                               vote=vote, tile_n=tiles.tile_n)
            else:
                out = _ref.ensemble_lookup_ref(*args, n_classes=art.n_classes,
                                               vote=vote)
        return _tree_epilogue(art, out)

    if impl == "loop":
        raise ValueError("impl='loop' is the per-feature-loop tree kernel; "
                         "classical artifacts have no loop realization")
    if impl == "fused":
        out = _ck.classical_lookup_fused(x, art.edges, _flat_vtable(art),
                                         art.vtable.q.shape[2],
                                         tile_n=tiles.tile_n)
    else:
        out = _ref.classical_lookup_ref(x, art.edges,
                                        art.vtable.q.to(torch.float32))
    return _classical_epilogue(art, out)
