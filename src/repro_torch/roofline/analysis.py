"""Three-term roofline of one step on one device.

Port of ``repro/roofline/analysis.py``:

  compute    = flops_per_device / peak_flops
  memory     = bytes_per_device / hbm_bw
  collective = wire_bytes_per_device / link_bw

The reference reads its collectives from compiled HLO text; the port's
dry run (``launch.dryrun``) records each collective a step issues (its
kind, the bytes of its result on one device, its group's size), and
``collective_bytes_from_ops`` sums their wire bytes with the reference's
ring multipliers over the group size G:

  all-gather         (G-1)/G * result_bytes
  all-reduce       2*(G-1)/G * result_bytes
  reduce-scatter     (G-1)   * result_bytes     (operand = G * result)
  all-to-all         (G-1)/G * result_bytes
  collective-permute          result_bytes

Hardware model (``HW``), one NVIDIA H100 SXM5 at its 700 W limit, the rates
of the port's own arithmetic (f32, TF32 off):
  peak_flops  67e12 FLOP/s: f32 FFMA outside the tensor cores (NVIDIA H100
              data sheet, SXM5, FP32 67 TFLOPS);
  hbm_bw      3.35e12 B/s: HBM3 (the same data sheet);
  link_bw     50e9 B/s: one 400 Gb/s NDR InfiniBand port per GPU (NVIDIA
              DGX H100 user guide: eight ConnectX-7 ports, one per GPU). A
              16-wide mesh axis crosses two 8-GPU NVLink nodes, so this is
              the slowest hop of its ring.
"""

from __future__ import annotations

HW = {
    "peak_flops": 67e12,     # f32 / GPU (H100 SXM5)
    "hbm_bw": 3.35e12,       # bytes/s / GPU
    "link_bw": 50e9,         # bytes/s / GPU, across nodes
}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _wire_multiplier(op: str, g: int) -> float:
    if op == "collective-permute":     # pairs, not groups: always moves data
        return 1.0
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return (g - 1) / g
    if op == "all-reduce":
        return 2 * (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)
    if op == "all-to-all":
        return (g - 1) / g
    return 1.0


def collective_bytes_from_ops(calls) -> dict:
    """calls: (kind, result bytes on one device, group size) a collective,
    ``kind`` one of ``KINDS`` -> {"total": wire bytes/device, "by_op":
    {kind: bytes}, "count": int}."""
    by_op: dict[str, float] = {}
    count = 0
    for op, result_bytes, g in calls:
        by_op[op] = by_op.get(op, 0.0) + result_bytes * _wire_multiplier(op, g)
        count += 1
    return {"total": sum(by_op.values()), "by_op": by_op, "count": count}


def roofline_terms(cost: dict, coll: dict, *, hw: dict = HW) -> dict:
    """Seconds per step for each roofline term + the dominant one."""
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    bytes_link = float(coll["total"])
    terms = {
        "compute_s": flops / hw["peak_flops"],
        "memory_s": bytes_hbm / hw["hbm_bw"],
        "collective_s": bytes_link / hw["link_bw"],
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {**terms, "dominant": dominant,
            "flops_per_dev": flops, "hbm_bytes_per_dev": bytes_hbm,
            "link_bytes_per_dev": bytes_link,
            # fraction of ideal: if perfectly overlapped, step time = max term
            "overlap_roofline_frac": bound / total if total > 0 else 0.0}


def model_flops(cfg, n_params_total: int, n_params_active: int,
                shape_kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params.

    D = processed tokens: seq*batch for train/prefill, batch for decode."""
    n = n_params_active
    if shape_kind == "train":
        return 6.0 * n * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch          # decode: one token per request
