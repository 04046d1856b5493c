"""Grouped expert GEMM (B9): CUDA kernel + wrapper + plain version.

The routed experts of a dropless MoE layer (DeepSeek-V3's, served with fp8
e4m3 weights in 128 x 128 blocks and bf16 activations), every expert's
tokens in one launch a matrix. It replaces no TPU kernel: the JAX package
runs its capacity-bounded experts as one batched matmul in XLA. The CUDA
source is ``csrc/grouped_gemm.cu``; its header gives the design (wgmma fed
by TMA, warp-specialised, one persistent block an SM) and the bound
(operations: 5.77 TFLOP a layer at the served shape against 11.3 GB of
weights).

``expert_plan(ids, n_experts)`` sorts the (token, choice) pairs by expert
on the device: the sort order, each pair's token (``src``) and row in
token order (``dst``), each expert's ``counts`` and ``offsets`` into the
sorted pairs, the ``walk`` (the experts, most pairs first) and
``tile_start``, the prefix of ceil(counts / ``BM``) along the walk: the
tile list every block of both launches walks. Nothing is read on the host
and no shape depends on the routing, so a CUDA graph captures the plan and
both launches; the grid is one block an SM (at most the tiles any routing
can need, ``max_tiles`` x the column blocks).

``grouped_ffn(x, plan, experts, pair_w, stored=)`` -> (T * K, D)
bf16, the row ``t * K + k`` holding ``pair_w[t, k] * E_e(x[t])`` for the
k-th expert e of token t, ``E_e(x) = (silu(x Wg_e^T) * (x Wu_e^T)) Wd_e^T``
with the weights dequantized and rounded to bf16 (as the kernel dequantizes
each code into its wgmma fragment); the intermediate rounded to bf16, as
the kernel stores it. A CUDA tensor launches the kernel (or raises on
operands it does not take); a CPU tensor takes ``grouped_ffn_ref``, the
plain composition (dequantize, matmul, SiLU, matmul), which reads the
counts on the host. ``stored``, an int64 scalar on x's device, gains in
place the rows the down kernel stored, counted once a ``BLOCK``-column
block of Y (one atomic a row tile and block, on the device): a call that
writes every pair adds P x ``column_blocks(D)``, so a caller holds it
against the routed pairs and sees a tile or a row that was never written.
The plan's ``shapes``, when set to a (4,) int64 on x's device, gains the
row tiles run at each width of ``TILE_WIDTHS`` (an expert's pairs cut into
tiles of ``BM``, each run at its pairs rounded up to 64; ``tile_widths``),
one count a row tile, added by the down kernel. ``LAUNCHES`` counts kernel
launches, two a call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import FP8, dequantize_blocks
from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build

BM = 256           # pairs a row tile at most (csrc: kTile)
TILE_WIDTHS = (64, 128, 192, 256)   # a tile's N: its pairs rounded up to 64
BLOCK = 128        # the scale block, and down's output columns a tile
GATE_UP_COLS = 64  # gate_up's output columns a tile (of Wg and of Wu)

REF_CHUNK = 16     # experts the plain version dequantizes at a time

LAUNCHES = {"grouped_gemm": 0}

BF16 = torch.bfloat16
I32 = torch.int32


def reset_launches() -> None:
    LAUNCHES["grouped_gemm"] = 0


def column_blocks(d: int) -> int:
    """The down kernel's blocks along Y's D columns: each stores its
    rows once into ``stored``."""
    return -(-d // BLOCK)


def tile_widths(counts: torch.Tensor) -> torch.Tensor:
    """(E,) pairs of each expert -> (4,) int64: the row tiles run at each
    of ``TILE_WIDTHS``. An expert's pairs are cut into tiles of ``BM``;
    a tile runs at its pairs rounded up to 64."""
    c = counts.to(torch.int64)
    full = torch.div(c, BM, rounding_mode="floor")
    rest = c - full * BM
    out = torch.zeros(len(TILE_WIDTHS), dtype=torch.int64,
                      device=counts.device)
    out[-1] = full.sum()
    tail = torch.div(rest + 63, 64, rounding_mode="floor") - 1
    return out.index_add_(0, tail[rest > 0],
                          torch.ones_like(tail[rest > 0]))


@dataclasses.dataclass
class ExpertPlan:
    order: torch.Tensor         # (P,) int64: pairs (t * K + k) by expert
    src: torch.Tensor           # (P,) int32: the token of each sorted pair
    dst: torch.Tensor           # (P,) int32: its row in token order
    counts: torch.Tensor        # (E,) int32: pairs of each expert
    offsets: torch.Tensor       # (E,) int32: its first sorted pair
    walk: torch.Tensor          # (E,) int32: the experts, most pairs first
    tile_start: torch.Tensor    # (E + 1,) int32: first row tile of each
                                # walk place
    max_tiles: int              # ceil(P / BM) + E: the most row tiles
    top_k: int                  # K: choices a token
    shapes: torch.Tensor = None  # (4,) int64 or None: gains the row tiles
                                 # run at each of TILE_WIDTHS


def expert_plan(ids: torch.Tensor, n_experts: int) -> ExpertPlan:
    """ids (T, K) integer expert of each (token, choice) -> the pairs
    sorted by expert (stable: a token's pairs keep their order), all on
    ids' device."""
    t, k = ids.shape
    eid = ids.reshape(-1).to(torch.int64)
    sorted_e, order = torch.sort(eid, stable=True)
    edges = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=ids.device))
    counts = (edges[1:] - edges[:-1]).to(I32)
    walk = torch.sort(counts, descending=True, stable=True).indices
    tiles = torch.div(counts[walk] + (BM - 1), BM, rounding_mode="floor")
    tile_start = torch.cat([torch.zeros(1, dtype=I32, device=ids.device),
                            torch.cumsum(tiles, 0).to(I32)])
    return ExpertPlan(order=order, src=torch.div(
        order, k, rounding_mode="floor").to(I32), dst=order.to(I32),
        counts=counts, offsets=edges[:-1].to(I32), walk=walk.to(I32),
        tile_start=tile_start, max_tiles=-(-(t * k) // BM) + n_experts,
        top_k=k)


def check_operands(x, plan: ExpertPlan, experts, pair_w,
                   stored=None) -> None:
    """Raise unless the operands are what the kernel takes: x (T, D) bf16
    contiguous; gate / up (E, F, D) and down (E, D, F) e4m3 contiguous
    with scales (E, F/128, D/128) and (E, D/128, F/128) f32; D and F
    multiples of 128; pair_w (T, K) f32, K the plan's; stored None or one
    int64; the plan's shapes None or (4,) int64; all on x's device."""
    if x.dim() != 2 or x.dtype != BF16 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (T, D) bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    d = x.shape[1]
    gate = experts["gate"]
    e, f = gate.shape[0], gate.shape[1]
    if d % BLOCK or f % BLOCK:
        raise ValueError(f"D = {d} and F = {f} must be multiples of {BLOCK}")
    want = {"gate": (e, f, d), "up": (e, f, d), "down": (e, d, f),
            "gate_scale": (e, f // BLOCK, d // BLOCK),
            "up_scale": (e, f // BLOCK, d // BLOCK),
            "down_scale": (e, d // BLOCK, f // BLOCK)}
    for name, shape in want.items():
        a = experts[name]
        dtype = torch.float32 if name.endswith("scale") else FP8
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if pair_w.dtype != torch.float32 or pair_w.device != x.device \
            or tuple(pair_w.shape) != (x.shape[0], plan.top_k):
        raise ValueError(f"pair_w must be float32 (T, K) = ({x.shape[0]}, "
                         f"{plan.top_k}) on {x.device}, got {pair_w.dtype} "
                         f"{tuple(pair_w.shape)} on {pair_w.device}")
    if stored is not None and (stored.dtype != torch.int64
                               or stored.numel() != 1
                               or stored.device != x.device):
        raise ValueError(f"stored must be one int64 on {x.device}, got "
                         f"{stored.dtype} {tuple(stored.shape)} on "
                         f"{stored.device}")
    shapes = plan.shapes
    if shapes is not None and (shapes.dtype != torch.int64
                               or tuple(shapes.shape) != (len(TILE_WIDTHS),)
                               or shapes.device != x.device
                               or not shapes.is_contiguous()):
        raise ValueError(f"shapes must be ({len(TILE_WIDTHS)},) int64 on "
                         f"{x.device}, got {shapes.dtype} "
                         f"{tuple(shapes.shape)} on {shapes.device}")


def grouped_ffn(x: torch.Tensor, plan: ExpertPlan, experts: dict,
                pair_w: torch.Tensor, stored=None) -> torch.Tensor:
    """x (T, D) bf16, the plan of ``ids`` (T, K), the fp8 experts (``gate``,
    ``up``, ``down`` and their ``*_scale``), pair_w (T, K) f32 -> (T * K, D)
    bf16, row t * K + k the weighted output of token t's k-th expert;
    ``stored`` (int64 scalar or None) gains the rows written, once a
    column block; the plan's ``shapes`` the row tiles at each of
    ``TILE_WIDTHS``."""
    if not on_kernel_path(x):
        return grouped_ffn_ref(x, plan, experts, pair_w, stored)
    check_operands(x, plan, experts, pair_w, stored)
    p = plan.order.numel()
    d = x.shape[1]
    e, f = experts["gate"].shape[:2]
    h = torch.empty((p, f), dtype=BF16, device=x.device)
    y = torch.empty((p, d), dtype=BF16, device=x.device)
    w_sorted = pair_w.reshape(-1)[plan.order].contiguous()
    sms = _build.sm_count(x.device)
    _build.launch("grouped_gemm", x.device,
                  (x.data_ptr(), plan.src.data_ptr(),
                   plan.offsets.data_ptr(), plan.counts.data_ptr(),
                   plan.tile_start.data_ptr(), plan.walk.data_ptr(),
                   experts["gate"].data_ptr(), experts["up"].data_ptr(),
                   experts["gate_scale"].data_ptr(),
                   experts["up_scale"].data_ptr(), h.data_ptr()),
                  (e, f, d, p,
                   min(sms, plan.max_tiles * (f // GATE_UP_COLS))),
                  entry="gate_up")
    launch_down(h, plan, experts, w_sorted, y, stored, sms)
    LAUNCHES["grouped_gemm"] += 2
    return y


def launch_down(h, plan: ExpertPlan, experts: dict, w_sorted, y,
                stored=None, sms=None) -> None:
    """The down launch alone: H (P, F) bf16 in expert order, w_sorted (P,)
    f32 -> Y (P, D) bf16 in token order, written in place (``grouped_ffn``'s
    second launch; a check may feed it an H of its own)."""
    e, d = experts["down"].shape[:2]
    sms = sms or _build.sm_count(h.device)
    _build.launch("grouped_gemm", h.device,
                  (h.data_ptr(), plan.offsets.data_ptr(),
                   plan.counts.data_ptr(), plan.tile_start.data_ptr(),
                   plan.walk.data_ptr(), experts["down"].data_ptr(),
                   experts["down_scale"].data_ptr(), w_sorted.data_ptr(),
                   plan.dst.data_ptr(), y.data_ptr(),
                   0 if stored is None else stored.data_ptr(),
                   0 if plan.shapes is None else plan.shapes.data_ptr()),
                  (e, d, h.shape[1], h.shape[0],
                   min(sms, plan.max_tiles * column_blocks(d))),
                  entry="down")


def kernel_info(device) -> dict:
    """Each kernel's resources on ``device``'s card: {"gate_up" | "down":
    {"registers": at launch, a thread, "smem_bytes": dynamic shared memory
    a block, "local_bytes": spilled bytes a thread, "threads": a block}}."""
    import ctypes
    lib = _build.load("grouped_gemm")
    fn = lib.grouped_gemm_info
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = {}
    with torch.cuda.device(device):
        for name, nmat in (("gate_up", 2), ("down", 1)):
            vals = (ctypes.c_int * 4)()
            err = fn(nmat, ctypes.cast(vals, ctypes.c_void_p))
            if err:
                raise RuntimeError(f"grouped_gemm_info failed: {err}")
            out[name] = dict(zip(("registers", "smem_bytes", "local_bytes",
                                  "threads"), list(vals)))
    return out


def grouped_ffn_ref(x, plan: ExpertPlan, experts: dict, pair_w,
                    stored=None) -> torch.Tensor:
    """The plain composition: each expert's weights dequantized and
    rounded to bf16 (``REF_CHUNK`` experts at a time), its pairs' rows
    gathered, SiLU(x Wg^T) * (x Wu^T) in float32 rounded to bf16 (the
    kernel's H), then times Wd^T and the pair's weight, rounded to bf16
    and written at the pair's row in token order; ``stored`` gains each
    expert's rows written times ``column_blocks(D)``, the plan's
    ``shapes`` its row tiles at each width (``tile_widths``). Reads the counts on the host;
    the scale block is read from the scales' shape."""
    p, d = plan.order.numel(), x.shape[1]
    gate = experts["gate"]
    block = -(-gate.shape[2] // experts["gate_scale"].shape[2])
    y = torch.zeros((p, d), dtype=BF16, device=x.device)
    w_sorted = pair_w.reshape(-1)[plan.order].to(torch.float32)
    xs = x[plan.src.long()].to(torch.float32)
    dst = plan.dst.long()
    counts = plan.counts.tolist()
    offsets = plan.offsets.tolist()
    for lo in range(0, len(counts), REF_CHUNK):
        hi = lo + REF_CHUNK
        if not any(counts[lo:hi]):
            continue
        wg, wu, wd = (dequantize_blocks(experts[k][lo:hi],
                                        experts[k + "_scale"][lo:hi], block,
                                        BF16).to(torch.float32)
                      for k in ("gate", "up", "down"))
        for e in range(lo, min(hi, len(counts))):
            rows = slice(offsets[e], offsets[e] + counts[e])
            if counts[e] == 0:
                continue
            xe = xs[rows]
            h = (F.silu(xe @ wg[e - lo].T) * (xe @ wu[e - lo].T)).to(BF16)
            ye = (h.to(torch.float32) @ wd[e - lo].T) * w_sorted[rows, None]
            y[dst[rows]] = ye.to(BF16)
            if stored is not None:
                stored += counts[e] * column_blocks(d)
    if plan.shapes is not None:
        plan.shapes += tile_widths(plan.counts).to(plan.shapes.device)
    return y
