"""A reader of the servers' phase marks in a ``torch.profiler`` trace.

Tests use it to hold the marks against the device's own events: each
graph replay's device ops, in order of start, split by the marks of its
graph. It is a test helper, not part of the program: the benchmark's
harness defines what its metrics read.
"""

import bisect
import collections
from typing import Optional

from repro_torch.obs.profiling import ENTRY, ENTRY_INPUT, ENTRY_OUTPUT

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def phase_breakdown(events: list, phases: dict) -> dict:
    """Device time by graph phase and by the entry's own work in a Chrome
    trace of ``torch.profiler`` (``export_chrome_trace``'s
    ``traceEvents``) recorded with the CPU and CUDA activities.

    ``phases`` maps graph keys to marks (a server's ``graph_phases()``).
    Each graph replay's device events (those with the correlation of one
    ``cudaGraphLaunch``) are ordered by start and split by the marks of
    the graph whose total they equal; a replay no graph's marks total
    raises ValueError with both counts. Every other device op counts
    where the runtime call that launched it ran: inside
    ``repro_torch.entry.input`` or ``.output`` (the entry's copies), in
    another program span, or in none (the caller's own work). Each idle
    gap between device events takes the name of the innermost range open
    on the host where it starts ("other" for none).

    -> {"replays", "phases": {phase: s}, "phase_ops": {phase: {device op:
    (count, s)}}, "entry_copies_s", "entry_copy_ops", "entry_other_s",
    "outside_s", "outside_ops", "busy_s", "idle_gaps": {label: s}}."""
    launch, spans, dev = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e["ts"])
        dur = float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, dur, e.get("args", {}).get("correlation"),
                        e["name"]))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["name"], ts)
        elif cat == "user_annotation":
            spans.append((ts, ts + dur, e["name"]))
    dev.sort(key=lambda d: d[0])
    spans.sort(key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]

    def innermost(t: float) -> Optional[str]:
        # ranges nest, so the latest-starting one still open is innermost
        i = bisect.bisect_right(starts, t)
        while i:
            i -= 1
            if t < spans[i][1]:
                return spans[i][2]
        return None

    replays = collections.defaultdict(list)
    ops = collections.defaultdict(dict)
    out = {
        "phases": collections.Counter(), "entry_copies_s": 0.0,
        "entry_copy_ops": 0, "entry_other_s": 0.0, "outside_s": 0.0,
        "outside_ops": 0}
    for ts, dur, corr, op in dev:
        name, at = launch.get(corr, (None, None))
        if name in GRAPH_LAUNCH:
            replays[corr].append((dur, op))
            continue
        where = None if at is None else innermost(at)
        if where in (ENTRY_INPUT, ENTRY_OUTPUT):
            out["entry_copies_s"] += dur * 1e-6
            out["entry_copy_ops"] += 1
        elif where is not None and where.startswith(ENTRY):
            out["entry_other_s"] += dur * 1e-6
        else:
            out["outside_s"] += dur * 1e-6
            out["outside_ops"] += 1
    by_total = collections.defaultdict(set)
    for marks in phases.values():
        by_total[sum(n for _, n in marks)].add(tuple(marks))
    for corr, evs in replays.items():
        fits = by_total.get(len(evs), ())
        if len(fits) != 1:
            raise ValueError(
                f"a graph replay ran {len(evs)} device ops; the captured "
                f"graphs' marks total {sorted(by_total)}"
                + (" (more than one layout)" if fits else ""))
        i = 0
        for name, n in next(iter(fits)):
            for dur, op in evs[i:i + n]:
                out["phases"][name] += dur * 1e-6
                n_op, s = ops[name].get(op, (0, 0.0))
                ops[name][op] = (n_op + 1, s + dur * 1e-6)
            i += n
    # the union of device time and its gaps, summed as the benchmark's
    # harness sums them (``portbench.harness.read_trace``)
    busy, gaps, end = 0.0, collections.Counter(), None
    for ts, dur, _, _ in dev:
        if end is None:
            busy, end = dur, ts + dur
        elif ts > end:
            gaps[innermost(end) or "other"] += (ts - end) * 1e-6
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    out.update(replays=len(replays), phases=dict(out["phases"]),
               phase_ops=dict(ops), busy_s=busy * 1e-6,
               idle_gaps=dict(gaps))
    return out
