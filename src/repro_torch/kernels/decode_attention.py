"""Int8-KV GQA decode attention (B8): CUDA kernel + wrapper.

Replaces the Pallas TPU kernel of ``repro/kernels/decode_attention.py``:
``_decode_attn_kernel`` (:32), reached from
``decode_attention_int8_pallas`` (:63). The reference's quantized
``gqa_decode`` computes the same function in plain XLA
(``repro/models/attention.py:241-261``); the port's ``gqa_decode`` calls
this kernel for it through ``ops.decode_attention_int8``. The CUDA source
is ``csrc/decode_attention.cu``.

    q (B,G,M,hd) f32; k_q/v_q (B,S,G,hd) int8; k_s/v_s (B,S,G,1) f32;
    valid (B,S) f32 (> 0.5 = live slot) -> out (B,G,M,hd) f32

The kernel reads the cache in its native (B, S, G, hd) layout through its
strides (a layer's view of the stacked decode cache needs no copy) and
turns the int8 codes into f16 in registers, so a decode step moves the int8
bytes only. S is split across CTAs (flash-decoding): one CTA per (chunk of
slots, batch row, up to 8 kv heads, group of at most ``GROUP_M`` query
heads), a warp for each kv head (a single kv head: all ``WARPS`` taking
tiles of ``TILE`` slots in turn), each keeping its next tiles in flight
in its own ring of shared memory, then a second kernel merges the chunks'
partial softmax states. q.k and p.v run on the
tensor cores (``mma.sync`` m16n8k16, f16 operands, f32 sums): an int8 code
is exact in f16, and q and the weights p * v_s are each split into two f16
terms after an exact power-of-two scale, which fill the MMA rows the query
heads leave empty. M > 8 (recurrentgemma's local attention has M = 10)
splits into ceil(M / 8) equal groups over the grid. ``launch_plan`` picks
the chunk from B, G, M, S and the card's SM count so that the grid fills
the card; it is not a knob of the caller. The wrapper allocates the scratch
of partials with ``torch.empty`` on q's device (so a call can be captured
in a CUDA graph, whose pool then holds it).

Bound: memory (the int8 K/V, the scales and the mask read once: 0.165 ms
at B=8, S=32768, G=8, hd=128 on 3.35 TB/s). PERF.md holds the measured
time.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``decode_attention_int8_ref``. The kernel's online softmax sums in another
order than the dense softmax of the plain version, and its two f16 terms
keep 22 bits of q and of the weights: the two agree to ``RTOL``/``ATOL``,
the reference's own Pallas-against-oracle tolerance (one f16 term would
not; ``tests/test_torch_decode_attention.py`` emulates the split).
``LAUNCHES`` counts kernel launches: one per call that launches, though a
call with more than one chunk launches the split kernel and the combine.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_int8_ref

RTOL, ATOL = 2e-4, 2e-5     # repro tests/test_decode_attention_kernel.py:40

DIMS_PER_THREAD = 8         # the head dim's granule: an 8-byte copy
GROUP_M = 8                 # query heads a CTA takes (csrc: kRows)
MAX_GRID_Z = 65535          # B x query groups ride the grid's z dimension
MAX_GRID_Y = 65535          # the kv heads ride its y dimension

WARPS = 8                   # warps of a CTA (csrc: kWarps)
THREADS = 32 * WARPS
TILE = 16                   # slots a warp takes per step (csrc: kTile)
CTA_SMEM = 230400           # a CTA's dynamic shared memory (csrc: kCtaSmem):
                            # one CTA an SM
WAVES = 1                   # the grid's target, in waves of a CTA an SM
MIN_TILES = 2               # a warp takes at least this many tiles a chunk

LAUNCHES = {"decode_attention": 0}

_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def check_operands(q, k_q, k_s, v_q, v_s, valid) -> None:
    """Raise unless the operands are what the kernel takes: q (B,G,M,hd)
    f32 contiguous, any M >= 1 (B x ceil(M / 8) <= 65535); k_q/v_q
    (B,S,G,hd) int8 with a contiguous head dim and 8-byte-aligned rows;
    k_s/v_s (B,S,G,1) f32; valid (B,S) f32 (any strides, a broadcast batch
    dim included); hd a multiple of 8 from 8 to 256; all on q's device."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, G, M, hd), got {tuple(q.shape)}")
    b, g, m, hd = q.shape
    if k_q.dim() != 4:
        raise ValueError(f"k_q must be (B, S, G, hd), got {tuple(k_q.shape)}")
    s = k_q.shape[1]
    want = {"k_q": (b, s, g, hd), "v_q": (b, s, g, hd),
            "k_s": (b, s, g, 1), "v_s": (b, s, g, 1), "valid": (b, s)}
    ops = {"q": q, "k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
           "valid": valid}
    for name, a in ops.items():
        dtype = torch.int8 if name in ("k_q", "v_q") else torch.float32
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if name in want and tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(a.shape)}")
        if any(st < 0 or st > _INT_MAX for st in a.stride()):
            raise ValueError(f"{name} has strides the kernel cannot take: "
                             f"{a.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if m < 1:
        raise ValueError(f"M = {m} query heads per kv head; the kernel "
                         f"takes M >= 1")
    if b * _m_groups(m)[1] > MAX_GRID_Z:
        raise ValueError(f"B = {b} rows x {_m_groups(m)[1]} query groups "
                         f"exceed the grid's {MAX_GRID_Z}")
    if g > MAX_GRID_Y:
        raise ValueError(f"G = {g} kv heads exceed the grid's {MAX_GRID_Y}")
    if hd % DIMS_PER_THREAD or not 1 <= hd // DIMS_PER_THREAD <= 32:
        raise ValueError(f"head dim {hd}: the kernel takes a multiple of "
                         f"{DIMS_PER_THREAD} from 8 to 256")
    if s == 0:
        raise ValueError("the cache has no slots (S = 0)")
    for name in ("k_q", "v_q"):
        a = ops[name]
        if a.stride(3) != 1 or a.data_ptr() % 8 or any(
                st % 8 for st in a.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous head dim and "
                             f"8-byte-aligned rows, got strides "
                             f"{a.stride()} at offset {a.data_ptr() % 8}")


def _m_groups(m: int):
    """(heads a CTA takes, groups): M split into ceil(M / 8) groups as
    equal as may be, the last one short where they cannot be equal."""
    groups = -(-m // GROUP_M)
    m_group = -(-m // groups)
    return m_group, -(-m // m_group)


def ring_geometry(hd: int) -> dict:
    """A warp's ring of shared memory, as ``csrc/decode_attention.cu``'s
    ``Ring<NV>`` lays it out: NV = ceil(hd / 32) words of V a lane, ``nk``
    = ceil(hd / 16) q.k steps, a slot row of 32 NV bytes (hd zero-padded)
    at a stride of 32 NV + 16, a stage of 16 slots' K and V rows and their
    k_s, v_s and mask, as many stages (at most 4) as the CTA's budget holds
    beside 8 kv heads' q fragments; ``smem`` in all, the CTA's 8 warps'
    rings included."""
    nv = -(-hd // 32)
    stride = 32 * nv + 16
    stage = 2 * TILE * stride + 3 * TILE * 4
    frag = WARPS * 2 * nv * 32 * 16
    stages = min(4, (CTA_SMEM - frag) // (WARPS * stage))
    return {"nv": nv, "nk": -(-hd // 16), "row_bytes": 32 * nv,
            "stride": stride, "stage_bytes": stage, "stages": stages,
            "smem": WARPS * stages * stage + frag}


def heads_per_cta(g: int) -> int:
    """kv heads a CTA takes: the largest power of two up to 8 and G, so a
    slot's rows of those heads (contiguous in the cache) come in together;
    their warps take the chunk's tiles in turn (8 / hpc phases)."""
    hpc = 1
    while hpc * 2 <= min(g, WARPS):
        hpc *= 2
    return hpc


def launch_plan(b: int, s: int, g: int, m: int, hd: int, *, wide: bool,
                sms: int) -> dict:
    """How the kernel splits a call: the query heads a CTA takes
    (``m_group``, at most 8) and ``m_groups`` = ceil(M / m_group), the kv
    heads a CTA takes (``hpc``, ``heads_per_cta``), the bytes a row copy
    moves (``vec``: 16 when ``wide`` and 16 divides hd, else 8), the ring
    (``ring_geometry``), the chunk of slots a CTA walks and ``n_split`` =
    ceil(S / chunk), and the grid (n_split, ceil(G / hpc), B x m_groups).
    The chunk is a whole number of the CTA's sweeps (its 8 / hpc phases of
    ``TILE`` slots), at least ``MIN_TILES`` a warp, and no smaller than it
    takes to keep the grid within ``WAVES`` waves of ``sms`` CTAs (a CTA
    an SM)."""
    m_group, m_groups = _m_groups(m)
    hpc = heads_per_cta(g)
    vec = 16 if wide and hd % 16 == 0 else 8
    ring = ring_geometry(hd)
    sweep = WARPS // hpc * TILE
    units = b * -(-g // hpc) * m_groups
    n_want = max(1, WAVES * sms // units)
    chunk = -(-s // n_want)
    chunk = max(MIN_TILES, -(-chunk // sweep)) * sweep
    n_split = -(-s // chunk)
    return {"vec": vec, "m_group": m_group, "m_groups": m_groups,
            "hpc": hpc, "chunk": chunk, "n_split": n_split,
            "grid": (n_split, -(-g // hpc), b * m_groups),
            "threads": THREADS, **ring}


def _wide_ok(k_q, v_q, hd: int) -> bool:
    """16-byte copies need 16-byte-aligned rows of K and V."""
    return hd % 16 == 0 and all(
        a.data_ptr() % 16 == 0 and all(st % 16 == 0 for st in a.stride()[:3])
        for a in (k_q, v_q))


def plan_for(q, k_q, v_q) -> dict:
    """``launch_plan`` for these operands on their card."""
    b, g, m, hd = q.shape
    return launch_plan(b, k_q.shape[1], g, m, hd,
                       wide=_wide_ok(k_q, v_q, hd),
                       sms=_build.sm_count(q.device))


def decode_attention_int8(q, k_q, k_s, v_q, v_s, valid, *,
                          scale: float) -> torch.Tensor:
    """q (B,G,M,hd) f32; k_q/v_q (B,S,G,hd) int8; k_s/v_s (B,S,G,1) f32;
    valid (B,S) f32 -> (B,G,M,hd) f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and raises on operands it does not take. A ``meta`` tensor (or a
    ``DTensor`` over meta tensors: the dry run, where only shapes flow) takes
    the plain version too, which then computes shapes and nothing else."""
    if q.device.type == "meta" or not on_kernel_path(q):
        return decode_attention_int8_ref(q, k_q, k_s, v_q, v_s, valid,
                                         scale=scale)
    check_operands(q, k_q, k_s, v_q, v_s, valid)
    b, g, m, hd = q.shape
    s = k_q.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = plan_for(q, k_q, v_q)
    n_split = plan["n_split"]
    # the chunks' partials: acc (B, n_split, G, M, hd), then (m, l) pairs
    part = (torch.empty(b * n_split * g * m * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    strides = []
    for a in (k_q, k_s, v_q, v_s):
        strides += list(a.stride()[:3])
    _build.launch("decode_attention", q.device,
                  (q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(),
                   v_q.data_ptr(), v_s.data_ptr(), valid.data_ptr(),
                   out.data_ptr(), None if part is None else part.data_ptr()),
                  (b, s, g, m, plan["m_group"], hd, *strides,
                   *valid.stride(),
                   _build.float_bits(scale), plan["vec"], plan["chunk"],
                   n_split, plan["hpc"]))
    LAUNCHES["decode_attention"] += 1
    return out
