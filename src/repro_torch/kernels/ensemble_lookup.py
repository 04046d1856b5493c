"""The fused IIsy match-action pipeline (tree family): CUDA kernel + wrapper.

Replaces the Pallas TPU kernels of ``repro/kernels/ensemble_lookup.py``:
``_fused_kernel`` (:112, select='matmul') and ``_fused_compare_kernel``
(:132, select='compare'), both reached from ``ensemble_lookup_fused``
(:169). One CUDA source, ``csrc/ensemble_lookup.cu``, holds both selects;
its range match is the device function ``csrc/range_match.cuh`` that the
classical lookup and the standalone bucketize share.

Per row: range match -> decision key per tree -> decision-table read ->
vote count or payload sum. The TPU wrote each lookup as a one-hot matmul
because Pallas has no gather; on Hopper both selects gather from the
tables, staged in shared memory when they fit (``SMEM_BUDGET_BYTES``) and
read through the read-only cache otherwise (``stage_mode``: every table,
the edges and feature table only, or none). Both selects are one kernel
design that differs only in its last step: a block takes ``tile_n`` rows
with several threads a row (``launch_plan``), the range match from group
summaries, one thread per (row, feature), while the tables are copied in
behind it, then the row's trees split over its threads and their votes or
sums met by shuffles. A key outside [0, Sp) matches no decision entry, as
in the reference: the matmul select adds nothing for it, the compare
select reads leaf 0.

Bound: memory. Each call must read x and the tables once and write the
output. At the serving shape (N=2048, F=5, U~40, T=10, Sp~136, Co=2) that is
about 75 KB — about 22 ns at 3.35 TB/s, far below a launch — so the design
keeps to one launch per classify. PERF.md holds the measured times (device
time per launch: the chain of dependent steps, not bytes).

The per-feature-loop kernel (B7, ``ensemble_lookup_loop``) replaces the
reference's ``_loop_kernel`` (:249, reached from
``ensemble_lookup_pallas_loop`` :289), the tile autotune's
``impl='loop'`` candidate. Its source is ``csrc/ensemble_loop.cu`` (the same
range match); it reads the unflattened tables and sums each tree's key in
f32 feature by feature, as the reference does, with the same lanes a row.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (``ensemble_lookup_fused_ref`` on the same flat tables,
``ensemble_lookup_loop_ref`` for B7). Every value is an integer carried in
f32 below 2^24, so the two agree bit for bit. ``LAUNCHES`` counts kernel
launches per select ('matmul', 'compare') and of B7 ('loop'), and nothing
else.
"""

from __future__ import annotations

import torch

from repro_torch.core.artifact import build_dtable_flat, flatten_ftable, pad_dtable
from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.ref import bucketize_ref, ensemble_lookup_loop_ref
from repro_torch.kernels.tuning import DEFAULT_TILES

# select='auto' crossover, kept from the reference (ensemble_lookup.py:63)
# so the port routes every artifact to the same strategy as repro. On this
# card both selects are gathers, so the crossover costs nothing either way.
SELECT_MATMUL_MAX = 8192

# Dynamic shared memory one Hopper block can use (227 KB, opt-in above 48 KB).
SMEM_BUDGET_BYTES = 232448

MAX_CLASSES = 32        # EL_MAX_CO in the CUDA source: outputs kept in registers
BLOCK_THREADS = 512     # EL_THREADS / LP_THREADS: most threads of a block
RM_GROUP = 8            # RM_GROUP in csrc/range_match.cuh: edges a summary covers

# where the tree lookups read their tables from: the CUDA source's
# STAGE_NONE, STAGE_KEYS (edges and feature table staged) and STAGE_ALL
STAGE_MODES = {"none": 0, "keys": 1, "all": 2}

LAUNCHES = {"matmul": 0, "compare": 0, "loop": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_select(select: str, t: int, s_pad: int, cout: int) -> str:
    if select == "auto":
        return "matmul" if t * s_pad * cout <= SELECT_MATMUL_MAX else "compare"
    if select not in ("matmul", "compare"):
        raise ValueError(f"select must be matmul|compare|auto, got {select!r}")
    return select


def smem_bytes(f: int, u: int, b_pad: int, t_pad: int, t: int, s_pad: int,
               cout: int, select: str, staged: str, tile_n: int) -> int:
    """Dynamic shared memory of one launch (mirrors ``el_layout`` in the
    CUDA source), each part rounded up to 16 bytes: a (min, max) per group
    of ``RM_GROUP`` edges, the block's rows of x and their feature-table
    offsets; from ``staged='keys'`` the edges and the feature table's first
    T columns (rounded up to 4) in rows 4 more than a multiple of 8 apart;
    at ``staged='all'`` also the decision table the select reads, (Co, T,
    Sp) for the matmul select and (T, Sp) for the compare select."""
    if staged not in STAGE_MODES:
        raise ValueError(f"staged must be one of {sorted(STAGE_MODES)}, "
                         f"got {staged!r}")
    words = _up4(2 * f * -(-u // RM_GROUP)) + 2 * _up4(f * tile_n)
    if staged != "none":
        fs = _up4(t) + (0 if _up4(t) % 8 else 4)    # feature-table row stride
        words += _up4(f * u) + f * b_pad * fs
    if staged == "all":
        words += (1 if select == "compare" else cout) * t * s_pad
    return 4 * words


def _up4(words: int) -> int:
    return -(-words // 4) * 4


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def _lanes_threads(t: int, tile_n: int) -> tuple:
    """(lanes, threads): as many lanes a row (a power of two, at most 32)
    as its T trees can use and ``BLOCK_THREADS`` allows, in whole warps."""
    lanes = min(32, 1 << (max(t, 1) - 1).bit_length(),
                _pow2_floor(BLOCK_THREADS // tile_n))
    return lanes, min(BLOCK_THREADS, -(-tile_n * lanes // 32) * 32)


def launch_plan(n: int, f: int, u: int, b_pad: int, t_pad: int, t: int,
                s_pad: int, cout: int, select: str, staged: str,
                tile_n: int) -> dict:
    """How one launch covers N rows: ``tile_n`` rows a block, ``blocks``
    blocks, ``lanes`` threads a row, ``threads`` a block, ``stage`` (the
    CUDA source's STAGE_NONE, STAGE_KEYS or STAGE_ALL) and ``smem`` bytes
    of dynamic shared memory. Both selects give a row as many lanes as its
    trees can use."""
    lanes, threads = _lanes_threads(t, tile_n)
    return {"blocks": -(-n // tile_n), "threads": threads, "lanes": lanes,
            "smem": smem_bytes(f, u, b_pad, t_pad, t, s_pad, cout, select,
                               staged, tile_n),
            "stage": STAGE_MODES[staged]}


def stage_mode(f: int, u: int, b_pad: int, t_pad: int, t: int, s_pad: int,
               cout: int, select: str, tile_n: int) -> str:
    """The shared-memory fit check: 'all' when every table fits one block's
    budget, else 'keys' when the edges and the feature table do (the
    decision entries then come through the read-only cache), else 'none'.
    It picks where the kernel reads from; it never routes away from the
    kernel."""
    for mode in ("all", "keys"):
        if smem_bytes(f, u, b_pad, t_pad, t, s_pad, cout, select, mode,
                      tile_n) <= SMEM_BUDGET_BYTES:
            return mode
    return "none"


def decision_keys(x, edges, ftable_flat, t: int) -> torch.Tensor:
    """(N, T) int64 decision keys from the flat feature table: range match,
    then key[t] = sum_f ftable_flat[f*Bp + bin_f, t] (exact integer sums)."""
    f = x.shape[1]
    b_pad = ftable_flat.shape[0] // f
    bins = bucketize_ref(x, edges).long()                   # (N, F)
    rows = bins + torch.arange(f, device=x.device)[None, :] * b_pad
    return ftable_flat[rows][:, :, :t].sum(dim=1).long()


def ensemble_lookup_fused_ref(x, edges, ftable_flat, dtable_flat, dtable_pad,
                              *, select: str = "auto") -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same flat tables. A key
    outside [0, Sp) matches no decision entry, as in the reference's
    one-hot match: the matmul select adds nothing for that tree, the
    compare select reads leaf 0."""
    cout, t, s_pad = dtable_flat.shape
    select = resolve_select(select, t, s_pad, cout)
    keys = decision_keys(x, edges, ftable_flat, t)          # (N, T)
    inside = (keys >= 0) & (keys < s_pad)
    keys = torch.where(inside, keys, 0)
    t_idx = torch.arange(t, device=x.device)[None, :]
    if select == "matmul":
        vals = torch.where(inside, dtable_flat[:, t_idx, keys], 0.0)
        return vals.sum(dim=2).t().contiguous()
    leaf = torch.where(inside, dtable_pad[t_idx, keys], 0.0)  # (N, T)
    if cout > 1:
        c_iota = torch.arange(cout, dtype=torch.float32, device=x.device)
        return (leaf[:, :, None] == c_iota).to(torch.float32).sum(dim=1)
    return leaf.sum(dim=1, keepdim=True)


def check_operands(x, *tables, dtype=torch.float32) -> None:
    """Raise unless x is float32 and every (name, tensor) of ``tables`` is
    of ``dtype``, contiguous and on x's device — what the kernels take."""
    for name, a in (("x", x),) + tables:
        want = torch.float32 if name == "x" else dtype
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ensemble_lookup_fused(x, edges, ftable_flat, dtable_flat, dtable_pad, *,
                          select: str = "auto", tile_n: int = None,
                          staged: str = None) -> torch.Tensor:
    """Fused pipeline on pre-flattened tables -> (N, Co) f32.

    x (N, F) f32 (any N); edges (F, U) f32; ftable_flat (F*Bp, Tp) f32
    stride-premultiplied (``finalize_artifact``); dtable_flat (Co, T, Sp)
    f32 decision+aggregation table; dtable_pad (T, Sp) f32 raw decision
    table. select: 'matmul' reads dtable_flat, 'compare' reads dtable_pad,
    'auto' keeps the reference's crossover. Returns per-class votes (vote)
    or payload sums (Co == 1). tile_n is the rows a CUDA block covers;
    staged picks which tables live in shared memory ('all', 'keys' or
    'none'; ``STAGE_MODES``); None takes what ``stage_mode`` says fits.
    """
    n, f = x.shape
    u = edges.shape[1]
    fb, t_pad = ftable_flat.shape
    cout, t, s_pad = dtable_flat.shape
    select = resolve_select(select, t, s_pad, cout)
    if not on_kernel_path(x):
        return ensemble_lookup_fused_ref(x, edges, ftable_flat, dtable_flat,
                                         dtable_pad, select=select)
    tile_n = tile_n or DEFAULT_TILES.tile_n
    check_operands(x, ("edges", edges), ("ftable_flat", ftable_flat),
                   ("dtable_flat", dtable_flat), ("dtable_pad", dtable_pad))
    if edges.shape[0] != f or fb % f or t_pad < t or dtable_pad.shape != (t, s_pad):
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, edges "
            f"{tuple(edges.shape)}, ftable_flat {tuple(ftable_flat.shape)}, "
            f"dtable_flat {tuple(dtable_flat.shape)}, dtable_pad "
            f"{tuple(dtable_pad.shape)}")
    if cout > MAX_CLASSES:
        raise ValueError(f"the kernel supports up to {MAX_CLASSES} output "
                         f"columns, got {cout}")
    b_pad = fb // f
    if staged is None:
        staged = stage_mode(f, u, b_pad, t_pad, t, s_pad, cout, select, tile_n)
    plan = launch_plan(n, f, u, b_pad, t_pad, t, s_pad, cout, select, staged,
                       tile_n)
    if plan["smem"] > SMEM_BUDGET_BYTES:
        raise ValueError("launch needs more shared memory than a block has; "
                         "lower tile_n or stage fewer tables")
    out = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    table = dtable_pad if select == "compare" else dtable_flat
    _build.launch("ensemble_lookup", x.device,
                  (x.data_ptr(), edges.data_ptr(), ftable_flat.data_ptr(),
                   table.data_ptr(), out.data_ptr()),
                  (n, f, u, b_pad, t_pad, t, s_pad, cout,
                   int(select == "compare"), plan["stage"], tile_n,
                   plan["lanes"], plan["threads"], plan["smem"]))
    LAUNCHES[select] += 1
    return out


def ensemble_lookup(x, edges, ftable, strides, dtable, *, n_classes: int,
                    vote: bool, select: str = "auto",
                    tile_n: int = None) -> torch.Tensor:
    """Run the fused pipeline from unflattened tables (the counterpart of
    the reference's compat entry ``ensemble_lookup_pallas``).

    Flattens ftable/strides/dtable on the fly (serving uses the artifact's
    pre-flattened copies instead). x (N, F) f32; edges (F, U) f32; ftable
    (F, U+1, T) int32; strides (T, F) int32; dtable (T, S) class ids or
    quantized payloads. Returns (N, n_classes) votes or (N, 1) sums.
    """
    return ensemble_lookup_fused(
        x, edges, flatten_ftable(ftable, strides),
        build_dtable_flat(dtable, n_classes, vote), pad_dtable(dtable),
        select=select, tile_n=tile_n)


# ---------------------------------------------------------------------------
# the per-feature-loop kernel (B7)
# ---------------------------------------------------------------------------

def loop_smem_bytes(f: int, u: int, t: int, s: int, staged: bool,
                    tile_n: int) -> int:
    """Dynamic shared memory of one loop-kernel launch (mirrors
    ``lp_layout`` in ``csrc/ensemble_loop.cu``), each part rounded up to 16
    bytes: a (min, max) per group of ``RM_GROUP`` edges, the block's rows
    of x and their code-row offsets, and when ``staged`` the edges, the
    codes (F, U+1, T), the strides (T, F) and the decision table (T, S)."""
    words = _up4(2 * f * -(-u // RM_GROUP)) + 2 * _up4(f * tile_n)
    if staged:
        words += (_up4(f * u) + _up4(f * (u + 1) * t) + _up4(t * f)
                  + t * s)
    return 4 * words


def loop_launch_plan(n: int, f: int, u: int, t: int, s: int, staged: bool,
                     tile_n: int) -> dict:
    """How one loop-kernel launch covers N rows: as ``launch_plan`` (the
    same lanes a row), with ``loop_smem_bytes``."""
    lanes, threads = _lanes_threads(t, tile_n)
    return {"blocks": -(-n // tile_n), "threads": threads, "lanes": lanes,
            "smem": loop_smem_bytes(f, u, t, s, staged, tile_n)}


def loop_fits_smem(f: int, u: int, t: int, s: int, tile_n: int) -> bool:
    """Stage the loop kernel's tables in shared memory when they fit one
    block's budget, else read them from global memory (same result)."""
    return loop_smem_bytes(f, u, t, s, True, tile_n) <= SMEM_BUDGET_BYTES


def ensemble_lookup_loop(x, edges, ftable, strides, dtable, *, n_classes: int,
                         vote: bool, tile_n: int = None,
                         staged: bool = None) -> torch.Tensor:
    """Per-feature-loop pipeline (B7) on the unflattened tables -> (N, Co).

    The counterpart of the reference's ``ensemble_lookup_pallas_loop``:
    x (N, F) f32 (any N: the kernel masks its ragged last block); edges
    (F, U) f32; ftable (F, U+1, T) int32 codes; strides (T, F) int32;
    dtable (T, S) f32 class ids or quantized payloads. Returns
    (N, n_classes) votes or (N, 1) sums, as ``ensemble_lookup_loop_ref``
    computes them (f32 keys summed feature by feature; a key outside
    [0, S) reads leaf 0). tile_n is the rows a CUDA block covers;
    staged=None stages the tables in shared memory when ``loop_fits_smem``
    says so.
    """
    if not on_kernel_path(x):
        return ensemble_lookup_loop_ref(x, edges, ftable, strides, dtable,
                                        n_classes=n_classes, vote=vote)
    n, f = x.shape
    u = edges.shape[1]
    t, s = dtable.shape
    tile_n = tile_n or DEFAULT_TILES.tile_n
    check_operands(x, ("edges", edges), ("dtable", dtable))
    check_operands(x, ("ftable", ftable), ("strides", strides),
                   dtype=torch.int32)
    if edges.shape[0] != f or ftable.shape != (f, u + 1, t) \
            or strides.shape != (t, f):
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, edges "
            f"{tuple(edges.shape)}, ftable {tuple(ftable.shape)}, strides "
            f"{tuple(strides.shape)}, dtable {tuple(dtable.shape)}")
    cout = n_classes if vote else 1
    if cout > MAX_CLASSES:
        raise ValueError(f"the kernel supports up to {MAX_CLASSES} output "
                         f"columns, got {cout}")
    if staged is None:
        staged = loop_fits_smem(f, u, t, s, tile_n)
    plan = loop_launch_plan(n, f, u, t, s, staged, tile_n)
    if plan["smem"] > SMEM_BUDGET_BYTES:
        raise ValueError("launch needs more shared memory than a block has; "
                         "lower tile_n or pass staged=False")
    out = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    _build.launch("ensemble_loop", x.device,
                  (x.data_ptr(), edges.data_ptr(), ftable.data_ptr(),
                   strides.data_ptr(), dtable.data_ptr(), out.data_ptr()),
                  (n, f, u, t, s, cout, int(vote), int(staged), tile_n,
                   plan["lanes"], plan["threads"], plan["smem"]))
    LAUNCHES["loop"] += 1
    return out
