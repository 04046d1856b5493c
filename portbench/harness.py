"""What every cell shares: the serving scaffold, the closed loop of the
measured window, the traced slice and its reading, and the per-layer
metrics' readers.

A cell (``portbench/kinds/<kind>.py``, a ``Served``) serves one request at
a time through ``issue(j)`` (start request j) and ``finish(j)`` (block
until its answers are readable on the host and keep them). The loop keeps
``depth`` requests in flight: a closed loop of one client whose next
request goes out as soon as its oldest one is answered.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import tempfile
import time
from collections import deque
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

# the host's spans a traced slice records, which label its idle gaps
SPAN_CALL = "portbench.call"      # the program's entry, inside issue()
SPAN_WAIT = "portbench.wait"      # the host waiting for answers
SPAN_KEEP = "portbench.keep"      # the host keeping the answers
LOG_BLOCK = 1024                  # requests a block of the logs holds


class HostLog:
    """Each request's predictions as int8 rows, in blocks of ``LOG_BLOCK``
    requests, so that keeping them makes no Python object a request."""

    def __init__(self, rows: int):
        self.rows, self.blocks, self.n = rows, [], 0

    def put(self, j: int, a: np.ndarray) -> None:
        b, i = divmod(j, LOG_BLOCK)
        while b >= len(self.blocks):
            self.blocks.append(np.empty((LOG_BLOCK, self.rows), np.int8))
        self.blocks[b][i] = a
        self.n = max(self.n, j + 1)

    def __getitem__(self, j: int) -> np.ndarray:
        b, i = divmod(j, LOG_BLOCK)
        return self.blocks[b][i]

    def __len__(self) -> int:
        return self.n


class StatLog:
    """Each request's telemetry (handled share, backend rows) as one f32
    pair, written on the device by one op a request."""

    def __init__(self, device):
        self.device, self.blocks, self.n = device, [], 0

    def put(self, j: int, stats: tuple) -> None:
        b, i = divmod(j, LOG_BLOCK)
        while b >= len(self.blocks):
            self.blocks.append(torch.empty((LOG_BLOCK, 2),
                                           dtype=torch.float32,
                                           device=self.device))
        torch.stack(stats, out=self.blocks[b][i])
        self.n = max(self.n, j + 1)

    def read(self) -> tuple:
        """-> (handled share (n,) f32, backend rows (n,) int64), numpy."""
        if not self.blocks:
            return np.zeros(0, np.float32), np.zeros(0, np.int64)
        a = torch.cat(self.blocks)[:self.n].cpu().numpy()
        return a[:, 0].copy(), a[:, 1].astype(np.int64)


class Served:
    """The serving scaffold of every kind. A kind supplies

    * ``configure(cfg, mix, seed, device)``: the seeded inputs and sizes,
      with ``depth`` (requests in flight) and ``rows_per_request``; all
      the control needs;
    * ``build()``: the program's server;
    * ``prepare(j)``: request j's inputs put in place, outside the timed
      call; -> the entry's arguments;
    * ``entry(*args)``: the program's entry; -> (pred, (handled share,
      backend rows)) on the device;
    * ``check``, ``control`` and ``counters`` against its reference.

    ``issue(j)`` copies the predictions to a pinned slot and the telemetry
    to the device's log; ``finish(j)`` waits for the copy and keeps the
    predictions in the host's log.
    """

    WARM_UP = 3                  # the probe, the capture, a replay

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        t = time.perf_counter()
        self.configure(cfg, mix, seed, torch.device(device))
        self.setup_phases = {"inputs": time.perf_counter() - t}
        t = time.perf_counter()
        self.build()
        cuda = self.device.type == "cuda"
        self.slots = [torch.empty(self.rows_per_request, dtype=torch.int64,
                                  pin_memory=cuda)
                      for _ in range(self.depth)]
        self.slot_np = [s.numpy() for s in self.slots]
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(self.depth)]
        self.setup_phases["server"] = time.perf_counter() - t
        t = time.perf_counter()
        self.restart()
        for j in range(self.WARM_UP):
            self.finish(self.issue(j))
        self.restart()
        self.setup_phases["warm-up"] = time.perf_counter() - t

    @classmethod
    def offline(cls, cfg: dict, mix: dict, seed: int, device):
        """The cell's inputs without the program: for the control."""
        cell = cls.__new__(cls)
        cell.configure(cfg, mix, seed, torch.device(device))
        return cell

    def restart(self) -> None:
        """Empty logs: the window's first request is request 0."""
        self.preds = HostLog(self.rows_per_request)
        self.stat_log = StatLog(self.device)
        self.call_s = []

    def issue(self, j: int, spans=None) -> int:
        args = self.prepare(j)
        t = time.perf_counter()
        with spans(SPAN_CALL) if spans else nullcontext():
            pred, stats = self.entry(*args)
        self.call_s.append(time.perf_counter() - t)
        k = j % self.depth
        self.slots[k].copy_(pred.view(-1), non_blocking=True)
        self.stat_log.put(j, stats)
        if self.events[k] is not None:
            self.events[k].record()
        return j

    def finish(self, j: int, spans=None) -> None:
        k = j % self.depth
        if self.events[k] is not None:
            with spans(SPAN_WAIT) if spans else nullcontext():
                self.events[k].synchronize()
        with spans(SPAN_KEEP) if spans else nullcontext():
            self.preds.put(j, self.slot_np[k])

    def release(self) -> None:
        """The program's telemetry to the host, then the program freed."""
        self.frac, self.rows = self.stat_log.read()
        del self.server, self.stat_log, self.slots, self.slot_np
        del self.events


@dataclasses.dataclass
class Loop:
    latencies: list          # seconds, each request answered in the window
    completed: int           # requests answered in the window
    issued: int              # requests issued in all (drained ones too)
    seconds: float           # the window's length


def closed_loop(cell, seconds: float, depth: int, first: int = 0) -> Loop:
    """Requests ``first, first + 1, ...`` for ``seconds``: a request
    counts when its answers reach the host before the window closes, and
    its latency runs on the host's clock from just before its issue to
    the moment its answers are kept; the ones in flight at the close are
    drained and not counted."""
    inflight = deque()
    lat = []
    j = first
    t_end = time.perf_counter() + seconds
    for _ in range(depth):
        inflight.append((time.perf_counter(), cell.issue(j)))
        j += 1
    while inflight:
        t_issue, tok = inflight.popleft()
        cell.finish(tok)
        t = time.perf_counter()
        if t <= t_end:
            lat.append(t - t_issue)
            inflight.append((time.perf_counter(), cell.issue(j)))
            j += 1
    return Loop(lat, len(lat), j - first, seconds)


def run_count(cell, first: int, count: int, depth: int) -> None:
    """Serve exactly ``count`` requests from ``first``, ``depth`` in
    flight, with the spans the trace reads."""
    from torch.profiler import record_function
    inflight = deque()
    j = first
    while j < first + min(depth, count):
        inflight.append(cell.issue(j, spans=record_function))
        j += 1
    while inflight:
        tok = inflight.popleft()
        cell.finish(tok, spans=record_function)
        if j < first + count:
            inflight.append(cell.issue(j, spans=record_function))
            j += 1


def traced_slice(cell, first: int, count: int, depth: int) -> dict:
    """``count`` requests under ``torch.profiler`` (CPU and CUDA), after
    and before a full synchronize. -> the device's intervals and kernels,
    the host's spans and the slice's length."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_count(cell, first, count, depth)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    out = read_trace(events, t1 - t0)
    out["requests"] = count
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list, at
    most 120 letters."""
    name = name.replace("(anonymous namespace)", "anon").strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:120].strip() or "?"


def read_trace(events: list, window_s: float) -> dict:
    """Kernels, memory copies and fills on the device; the harness's spans
    on the host. -> {"kernels": [(name, start_us, dur_us)], "busy_s",
    "window_s", "device_ops", "idle_gaps"}."""
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            spans.append((e["name"], float(e["ts"]),
                          float(e["ts"]) + float(e.get("dur", 0.0))))
    dev.sort(key=lambda d: d[1])
    busy, gaps = 0.0, {}
    end = None
    spans.sort(key=lambda s: s[1])
    for name, ts, dur in dev:
        if end is None:
            busy, end = dur, ts + dur
            continue
        if ts > end:
            label = next((s[0] for s in spans if s[1] <= end < s[2]),
                         "portbench.other")
            gaps[label] = gaps.get(label, 0.0) + (ts - end) * 1e-6
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    ops = {}
    for name, _, dur in dev:
        ops[_short(name)] = ops.get(_short(name), 0.0) + dur * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"kernels": [d for d in dev], "busy_s": busy * 1e-6,
            "window_s": window_s, "device_ops": top(ops),
            "idle_gaps": top(gaps)}


@dataclasses.dataclass
class Readings:
    """What the per-layer metrics' readers read."""
    call_s: list                     # host time inside the program's entry
    counters: dict                   # "rows", "backend_rows" (program's)
    trace: Optional[dict] = None     # ``read_trace`` of the traced slice
    bounds: dict = dataclasses.field(default_factory=dict)
    # {"b1": (least seconds summed over the slice's launches, launches)}
    least_s_per_request: Optional[float] = None
    window_s_per_request: Optional[float] = None
    loop: Optional[Loop] = None          # the measured window
    rows_per_request: int = 0
    setup_s: Optional[float] = None


def per_layer(metrics: list, readings: Readings) -> dict:
    """Each metric's reader (``portbench/metrics/<name>.py``, ``read``),
    those that find something to read."""
    out = {}
    for m in metrics:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def kernel_share(readings: Readings, key: str, name_part: str):
    """A kernel's share of its roofline: the least time a launch needs
    over the mean device time of its launches in the traced slice, in
    percent; None where the slice holds no such launch."""
    if readings.trace is None or key not in readings.bounds:
        return None
    durs = [d for n, _, d in readings.trace["kernels"] if name_part in n]
    least, launches = readings.bounds[key]
    if not durs or not launches:
        return None
    return 100.0 * (least / launches) / (sum(durs) * 1e-6 / len(durs))
