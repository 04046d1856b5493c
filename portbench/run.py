"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell from its configuration file, its traffic mix
(``portbench/traffic/<mix>.json``) and the seed, stands up the program's
server and warms up the shapes the cell serves. The window then serves
requests for ``--seconds`` in a closed loop. With ``--trace 1`` a slice of
further requests runs under ``torch.profiler``. Once the window has closed
the program is freed and the plain reference checks everything it
answered. The last line of standard output is the result (JSON); the last
lines of standard error give each compared number beside its limit.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, without the program beside the benchmark, or when a JAX
module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name: str) -> tuple:
    """-> (manifest, workload entry, configuration, traffic mix)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(args, device: str, err=sys.stderr) -> dict:
    """The cell ``args.workload`` on ``device``. -> the result line's
    object."""
    bench, _, cfg, mix = load_cell(args.workload)
    return measure(bench, args.workload, cfg, mix, args.seed, args.seconds,
                   args.trace, device, err)


def measure(bench: dict, name: str, cfg: dict, mix: dict, seed: int,
            seconds: float, trace_on: int, device: str,
            err=sys.stderr) -> dict:
    """Set-up, the window, the traced slice, the check and the metrics of
    cell ``name`` (its configuration ``cfg`` and mix ``mix``) on
    ``device``. -> the result line's object."""
    import numpy as np
    import torch

    from portbench import harness

    kind = importlib.import_module(f"portbench.kinds.{cfg['kind']}")
    cuda = torch.device(device).type == "cuda"
    t_cell = time.perf_counter()
    if cuda:
        torch.cuda.init()
    t_init = time.perf_counter()
    cell = kind.Cell(cfg, mix, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    # what set-up made is left out of the collector's passes; the window
    # runs with the collector on, as the program runs in service
    gc.collect()
    gc.freeze()
    loop = harness.closed_loop(cell, seconds, cell.depth)
    traced, trace = None, None
    if trace_on:
        traced = (loop.issued, mix["trace_requests"])
        if cuda:
            trace = harness.traced_slice(cell, *traced, cell.depth)
        else:
            harness.run_count(cell, *traced, cell.depth)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = cell.counters()
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = cell.check(traced)
    t_check = time.perf_counter() - t_check
    correct = all(v <= lim for v, lim in checks.values())

    readings = harness.Readings(
        call_s=cell.call_s[:loop.issued], counters=counters, trace=trace,
        bounds=cell.bounds, least_s_per_request=cell.least_s,
        window_s_per_request=(loop.seconds / loop.completed
                              if loop.completed else None),
        loop=loop, rows_per_request=cell.rows_per_request, setup_s=setup_s)
    wanted = bench["per_layer"] if trace_on else bench["end_to_end"]
    metrics = harness.per_layer([m for m in wanted if applies(m, name)],
                                readings)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    print(f"requests: {loop.completed} answered in the {loop.seconds} s "
          f"window, {len(cell.preds)} served in all; the program's "
          f"counters: {json.dumps(cell.program_counters)}", file=err)
    lat = 1e3 * np.asarray(loop.latencies)
    call = 1e3 * np.asarray(cell.call_s[:loop.issued])
    q = lambda a: (", ".join(f"p{p} {np.percentile(a, p):.4f}"
                             for p in (50, 90, 95, 99, 99.9))
                   + f", max {a.max():.4f}") if a.size else "none"
    print(f"latency ms: {q(lat)}; host call ms: {q(call)}", file=err)
    tenths = [slice(i * loop.completed // 10, (i + 1) * loop.completed // 10)
              for i in range(10)] if loop.completed >= 10 else []
    if tenths:
        print("by tenth of the window: latency ms p50 "
              + " ".join(f"{np.percentile(lat[s], 50):.4f}" for s in tenths)
              + "; handled share " + " ".join(
                  f"{cell.frac[s].mean():.5f}" for s in tenths)
              + "; backend rows a request " + " ".join(
                  f"{cell.rows[s].mean():.2f}" for s in tenths), file=err)
    phases = {"imports": t_cell - T0, "device": t_init - t_cell,
              **cell.setup_phases}
    print(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; the reference's check {t_check:.3f} s", file=err)
    for key, (value, limit) in checks.items():
        print(f"check {key}: {value} (limit {limit})", file=err)
    result = {"correct": correct, "attempted": len(cell.preds),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    chips = load_cell(args.workload)[1]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    try:
        importlib.import_module("repro_torch")
    except ImportError as exc:
        print(f"portbench: the program is not beside the benchmark: {exc}",
              file=sys.stderr)
        return 4
    torch.set_num_threads(2)
    result = run(args, "cuda")
    found = forbidden_modules()          # what this process loaded
    if found:
        print("portbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 5
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
