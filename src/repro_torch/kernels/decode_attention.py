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
turns the int8 codes into f32 in registers, so a decode step moves the int8
bytes only. S is split across CTAs (flash-decoding): one CTA per (batch
row, chunk of slots), covering every kv head, then a second kernel merges
the chunks' partial softmax states. A CTA takes at most ``GROUP_M`` of the
M query heads a kv head serves; M > 8 (recurrentgemma's local attention
has M = 10) splits into ceil(M / 8) equal groups over the grid, each
re-reading the K/V rows its sibling has just brought into L2, so the
registers a thread holds do not grow with M. ``launch_plan`` picks the
chunk from B, G, M, S and the card's SM count so that the grid fills the
card; it is not a knob of the caller. The wrapper allocates the scratch of
partials with ``torch.empty`` on q's device (so a call can be captured in
a CUDA graph, whose pool then holds it).

Bound: memory (the int8 K/V, the scales and the mask read once: 0.165 ms
at B=8, S=32768, G=8, hd=128 on 3.35 TB/s). PERF.md holds the measured
time.

Routing: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
``decode_attention_int8_ref``. The kernel's online softmax sums in another
order than the dense softmax of the plain version: the two agree to
``RTOL``/``ATOL``, the reference's own Pallas-against-oracle tolerance.
``LAUNCHES`` counts kernel launches: one per call that launches, though a
call with more than one chunk launches the split kernel and the combine.
"""

from __future__ import annotations

import torch

from repro_torch.device import on_kernel_path
from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_int8_ref

RTOL, ATOL = 2e-4, 2e-5     # repro tests/test_decode_attention_kernel.py:40

DIMS_PER_THREAD = 8         # the head dim's granule: one 8-byte load
GROUP_M = 8                 # query heads a CTA takes (csrc: the template M)
WIDE_MAX_M = 4              # 16-byte loads (16 dims a lane) up to this group
MAX_GRID_Z = 65535          # B x query groups ride the grid's z dimension

THREADS = 256               # threads of a CTA (csrc: kThreads)
SLOTS_PER_STAGE = 4         # slots a row takes per ring stage (csrc: kSlots)
CTAS_PER_SM = 2             # the grid's target, in CTAs per SM
MIN_ITERS = 4               # a chunk takes at least this many ring stages

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


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def launch_plan(b: int, s: int, g: int, m: int, hd: int, *, wide: bool,
                sms: int) -> dict:
    """How the kernel splits a call: the query heads a CTA takes
    (``m_group``, at most 8) and ``m_groups`` = ceil(M / m_group), dims a
    lane takes (``kd``: 16 with 16-byte loads when ``wide`` and m_group <=
    4, else 8), lanes a (slot, head) group takes, kv heads a CTA takes,
    its rows, the chunk of slots a CTA walks and ``n_split`` =
    ceil(S / chunk), and the grid (n_split, head groups, B x m_groups).
    The chunk is a whole number of the CTA's sweeps, at least
    ``MIN_ITERS`` of them, and small enough that the grid
    reaches ``CTAS_PER_SM * sms`` CTAs where S allows (so n_split stays
    within that count, far below the combine's limit of 8192)."""
    m_group, m_groups = _m_groups(m)
    kd = 16 if wide and m_group <= WIDE_MAX_M and hd % 16 == 0 else 8
    lps = _pow2_at_least(hd // kd)
    hpc = min(g, THREADS // lps)
    hgroups = -(-g // hpc)
    rows = THREADS // (hpc * lps)
    sweep = rows * SLOTS_PER_STAGE
    n_want = max(1, -(-CTAS_PER_SM * sms // (b * hgroups * m_groups)))
    chunk = -(-s // n_want)
    chunk = max(MIN_ITERS, -(-chunk // sweep)) * sweep
    n_split = -(-s // chunk)
    return {"kd": kd, "m_group": m_group, "m_groups": m_groups,
            "lanes_per_head": lps, "heads_per_cta": hpc,
            "rows": rows, "chunk": chunk, "n_split": n_split,
            "grid": (n_split, hgroups, b * m_groups), "threads": THREADS}


def _wide_ok(k_q, v_q, hd: int) -> bool:
    """16-byte loads need 16-byte-aligned rows of K and V."""
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
                   _build.float_bits(scale), plan["kd"], plan["chunk"],
                   n_split))
    LAUNCHES["decode_attention"] += 1
    return out
