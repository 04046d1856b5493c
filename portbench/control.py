"""The control of the comparison that decides ``correct``: the reference
computed in bfloat16, one step below the configuration's float32, put in
the program's place and compared as a run compares the program.

    python3 portbench/control.py --workload <cell> --requests N \
        --seeds 1 2 3

``--requests``: how many requests the control serves; give as many as a
run of the cell serves in its window. Prints one JSON line a seed with
each compared number; the control has to come out above its limit in at
least one of them for the comparison to separate a lower precision from
the program. The benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(workload: str, seed: int, device: str, requests: int) -> dict:
    from portbench.run import load_cell
    _, _, cfg, mix = load_cell(workload)
    kind = importlib.import_module(f"portbench.kinds.{cfg['kind']}")
    cell = kind.Cell.offline(cfg, mix, seed, device)
    t = time.perf_counter()
    out = cell.control(requests)
    return {"workload": workload, "seed": seed, "requests": requests,
            "numbers": {k: v for k, (v, _) in out.items()},
            "limits": {k: lim for k, (_, lim) in out.items()},
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.device,
                                 args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
