"""Render the dry run's roofline tables from the per-cell JSON records
that ``launch.dryrun`` writes.

Port of ``repro/roofline/report.py``; the table's header names the card
and ``HW``'s figures.

    PYTHONPATH=src python -m repro_torch.roofline.report artifacts/dryrun_torch
"""

from __future__ import annotations

import json
import os
import sys

from repro_torch.roofline.analysis import HW

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(d, refresh_analytic=True):
    recs = {}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(d, fn)) as f:
            r = json.load(f)
        if refresh_analytic and "skipped" not in r:
            _refresh(r)
        recs[fn[:-5]] = r
    return recs


def _refresh(r):
    """Recompute analytic flops/bytes terms with the current analytic
    model (decoupled from the sweep: the stored collective correction —
    the expensive part — stays)."""
    try:
        from repro_torch.configs import get_config
        from repro_torch.roofline.analysis import roofline_terms
        from repro_torch.roofline.analytic import (cell_flops_per_device,
                                                   cell_hbm_bytes_per_device,
                                                   decode_cache_bytes)
        cfg = get_config(r["arch"])
        n_chips = r["chips"]
        an_flops = cell_flops_per_device(cfg, r["shape"], n_chips,
                                         remat=r.get("remat", True))
        cache_b = (decode_cache_bytes(cfg, r["shape"],
                                      int8_kv=r.get("int8_kv", False))
                   if r["kind"] == "decode" else 0)
        an_bytes = cell_hbm_bytes_per_device(
            cfg, r["shape"], n_chips, r["params_total"], cache_b,
            remat=r.get("remat", True))
        coll = (r.get("collective_bytes_corrected")
                or r.get("collectives", {}).get("total", 0.0))
        roof = roofline_terms({"flops": an_flops,
                               "bytes accessed": an_bytes},
                              {"total": coll})
        r["roofline"] = {k: roof[k] for k in
                         ("compute_s", "memory_s", "collective_s",
                          "dominant", "overlap_roofline_frac")}
        r["analytic"] = {"flops_per_dev": an_flops,
                         "hbm_bytes_per_dev": an_bytes}
        mf = r.get("model_flops_global")
        if mf:
            r["useful_flops_ratio"] = mf / (an_flops * n_chips)
    except (KeyError, TypeError, ValueError, ZeroDivisionError):
        # roofline augmentation is best-effort decoration of a report
        # row: malformed/partial rows keep their measured fields
        pass


def _fmt_bytes(b):
    if b >= 1 << 30:
        return f"{b / (1 << 30):.1f}G"
    return f"{b / (1 << 20):.0f}M"


def _improvement_hint(r):
    d = r["roofline"]["dominant"]
    kind = r["kind"]
    if d == "collective_s":
        if kind == "train":
            return ("bf16 FSDP gathers / grad compression would halve the "
                    "dominant DP+TP collective bytes")
        return "replicate small weights (skip TP gathers) for this step"
    if d == "memory_s":
        if kind != "train":
            return ("KV/state cache reads dominate; quantized (int8) cache "
                    "or wider batch amortizes weight reads")
        return "activation remat policy / microbatching trades HBM for FLOPs"
    return "MoE/attn FLOPs dominate; better — push batch or drop remat"


def render(recs, mesh_tag="16x16"):
    lines = []
    lines.append(f"\n### Roofline table — mesh {mesh_tag} "
                 f"(per GPU, NVIDIA H100 SXM5: "
                 f"{HW['peak_flops'] / 1e12:.0f} TFLOP/s f32, "
                 f"{HW['hbm_bw'] / 1e9:.0f} GB/s HBM, "
                 f"{HW['link_bw'] / 1e9:.0f} GB/s link)\n")
    hdr = ("| arch | shape | compute_s | memory_s | collective_s | "
           "dominant | peak B/dev | useful FLOPs | note |")
    lines.append(hdr)
    lines.append("|" + "---|" * 9)
    for key, r in sorted(recs.items()):
        if not key.endswith("__" + mesh_tag):
            continue
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                         f"skipped | - | - | {r['skipped']} |")
            continue
        roof = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {roof['compute_s']:.4g} | {roof['memory_s']:.4g} "
            f"| {roof['collective_s']:.4g} "
            f"| {roof['dominant'].replace('_s', '')} "
            f"| {_fmt_bytes(r['memory']['peak_per_device'])} "
            f"| {r['useful_flops_ratio'] * 100:.0f}% "
            f"| {_improvement_hint(r)} |")
    return "\n".join(lines)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun_torch"
    recs = load_records(d)
    print(f"{len(recs)} records from {d}")
    print(render(recs, "16x16"))
    print(render(recs, "2x16x16"))


if __name__ == "__main__":
    main()
