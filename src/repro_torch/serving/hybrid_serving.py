"""Hybrid serving tier: the paper's §2.2.1 deployment, end to end.

Port of ``repro/serving/hybrid_serving.py``. Request path:
  1. feature extraction produced a feature vector per request;
  2. the SWITCH TIER — the fused IIsy table pipeline (the CUDA kernel on the
     card) — classifies the whole batch and yields (class, confidence);
  3. confidence >= tau  -> answered at the switch;
  4. confidence <  tau  -> the low-confidence subset is compacted into a
     fixed-capacity buffer and only that buffer hits the BACKEND, so the
     expensive model runs on capacity-many rows, not on the full batch.

``classify`` enqueues its work on the current CUDA stream and never waits
on the device: telemetry comes back in a lazy ``HybridStats`` holding
device tensors, and only reading a statistic (or the predictions)
synchronizes.

Single-dispatch path (``fuse``): the reference jits switch + dispatch +
backend + combine into one function. Its counterpart here is a CUDA graph
of the whole step, captured once per input shape and replayed per call, so
a classify costs a handful of launches instead of a few hundred. The
threshold lives in a device scalar filled per call (sweeping tau never
re-captures), x is copied into the graph's input buffer, and the outputs
are cloned, so an earlier call's preds and stats stay valid. A backend that
syncs the host (numpy, ``.item()``, ``.cpu()``) cannot be captured: the
first classify probes for that and serves such a backend by the eager
two-phase path from then on. ``update_tables`` copies new contents into
the served tensors in place, so a captured graph reads them.

``autotune`` sweeps the kernels' launch configurations once per artifact
shape and card (``kernels.tuning.autotune_tiles``). The reference's
``donate`` has no counterpart: its step's outputs cannot alias the input
batch, and a graph's buffers are its own. The reference defaults to
``use_pallas=False`` (its XLA gather path); this server defaults to the
kernel for CUDA tensors — bit-identical by contract.
"""

from __future__ import annotations

from typing import Callable, Optional

import dataclasses

import torch

from repro_torch.core.artifact import TableArtifact, finalize_artifact
from repro_torch.core.hybrid import combine, dispatch
from repro_torch.device import mean, resolve_device
from repro_torch.kernels.ops import fused_classify
from repro_torch.kernels.tuning import DEFAULT_TILES, TileConfig, autotune_tiles
from repro_torch.obs.profiling import (ENTRY_CAPTURE, ENTRY_EAGER,
                                       ENTRY_INPUT, ENTRY_OUTPUT, ENTRY_PROBE,
                                       ENTRY_REPLAY, annotation,
                                       capture_phases, entry_call, phase,
                                       tracing)


class HybridStats:
    """Per-batch telemetry holding device tensors; converts lazily.

    Reading .fraction_handled / .backend_rows is the only point that
    blocks on the device — constructing or returning HybridStats never does.
    """

    __slots__ = ("_fraction_handled", "_backend_rows", "capacity")

    def __init__(self, fraction_handled, backend_rows, capacity: int):
        self._fraction_handled = fraction_handled
        self._backend_rows = backend_rows
        self.capacity = capacity

    @property
    def fraction_handled(self) -> float:
        return float(self._fraction_handled)

    @property
    def backend_rows(self) -> int:
        return int(self._backend_rows)

    def as_tensors(self):
        """(fraction_handled, backend_rows) as device tensors — no sync."""
        return self._fraction_handled, self._backend_rows

    as_arrays = as_tensors          # the reference's name

    def __repr__(self):
        return (f"HybridStats(fraction_handled={self.fraction_handled:.3f}, "
                f"backend_rows={self.backend_rows}, "
                f"capacity={self.capacity})")


class HybridServer:
    # What the analysis gate (``repro_torch.analysis.hotpath``) audits: the
    # step ``_replay`` captures, run on a "batch" probe as ``_step(x, tau)``.
    # It keeps no carry (the reference's ``donate`` is empty too); on the
    # card its graph's input buffer and outputs must stay put across
    # replays. ``reference`` names the reference's row.
    AUDIT_CONTRACTS = (
        {"attr": "_step", "reference": "_step", "probe": "batch",
         "carries": (), "graph": True, "collectives": {}},
    )

    def __init__(self, artifact: TableArtifact, backend_fn: Callable, *,
                 threshold: float = 0.7, capacity: int = 256,
                 use_kernel: Optional[bool] = None, autotune: bool = False,
                 tiles: Optional[TileConfig] = None,
                 fuse: Optional[bool] = None, device=None):
        """backend_fn: (rows (capacity, F) tensor) -> class predictions
        (capacity,), on the server's device.

        device=None serves on CUDA and raises without a card; pass
        device="cpu" for the plain path. use_kernel=None means "the kernel
        for CUDA tensors"; False runs the plain gather version on the
        server's device (``TileConfig(impl='ref')``); True on the CPU is an
        error, since the kernel exists only on the card.

        tiles picks the kernel's launch configuration and realization
        (fused B1/B2, or the per-feature-loop B7); autotune=True sweeps
        them once for this artifact shape (cached per shape and card) when
        tiles is not given and the server runs the kernel (CUDA, use_kernel
        not False), and does nothing otherwise.

        fuse (CUDA only; a CPU server ignores it): None probes on the first
        classify whether backend_fn syncs the host, and captures the step in
        a CUDA graph if it does not; True captures without probing; False
        forces the eager two-phase path. Backends that read mutable
        side-channels (per-batch state on the function object) MUST pass
        fuse=False — a graph would replay the first batch's state.
        """
        self.device = resolve_device(device)
        if use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device")
        # the server owns its tables: update_tables writes into them in place
        self.artifact = finalize_artifact(artifact).to(self.device, copy=True)
        # capacity and backend_fn are baked into a captured step: frozen.
        # threshold is read per call, so it stays tunable.
        self._backend_fn = backend_fn
        self._capacity = capacity
        self.threshold = threshold
        self.use_kernel = use_kernel
        runs_kernel = self.device.type == "cuda" and use_kernel is not False
        if tiles is None:
            tiles = (autotune_tiles(self.artifact) if autotune and runs_kernel
                     else DEFAULT_TILES)
        if use_kernel is False:
            tiles = dataclasses.replace(tiles, impl="ref")
        self.tiles = tiles
        # None = not yet probed; a CPU server always serves eagerly
        self._fused_ok = fuse if self.device.type == "cuda" else False
        self._graphs = {}        # x shape -> (graph, x, outputs, marks)
        self._tau = torch.zeros((), dtype=torch.float32, device=self.device)

    @property
    def capacity(self) -> int:
        """Backend buffer size: the backend always sees this many rows.
        Frozen: it fixes a captured step's shapes."""
        return self._capacity

    @property
    def backend_fn(self):
        """Frozen: captured into the fused step."""
        return self._backend_fn

    def _step(self, x, tau):
        """Switch, dispatch, backend, combine -> (pred, frac, rows)."""
        phase("switch")
        sw_pred, conf = fused_classify(self.artifact, x, tiles=self.tiles,
                                       device=self.device)
        phase("dispatch")
        fwd = conf < tau
        buf, idx, valid = dispatch(x, fwd, self._capacity)
        phase("backend")
        be_pred = torch.as_tensor(self._backend_fn(buf), device=self.device)
        phase("combine")
        pred = combine(sw_pred, be_pred, idx, valid)
        frac = 1.0 - mean(fwd.to(torch.float32))
        rows = valid.to(torch.int32).sum()
        return pred, frac, rows

    def _probe(self, x):
        """One eager step with host syncs turned into errors: a backend
        that syncs cannot be captured, so it is served eagerly from now on.
        The step also builds the kernels before any capture."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self._step(x, self.threshold)
        except RuntimeError:
            self._fused_ok = False
            return None
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self._fused_ok = True
        return out

    def _replay(self, x, traced: bool = False):
        """The step for x's shape as a CUDA graph (captured at its first
        call), replayed on x; outputs cloned out of the graph's buffers."""
        key = tuple(x.shape)
        entry = self._graphs.get(key)
        if entry is None:
            with annotation(ENTRY_CAPTURE, traced):
                entry = self._graphs[key] = self._capture(
                    lambda c, s: self._step(s, self._tau), None, x.clone())
        return self._run_graph(entry, self._load_batch, x, traced)

    def _capture(self, body, carries, static, mode: str = "global"):
        """``body(carries, static)`` warmed up on a side stream, then
        captured in ``capture_error_mode=mode`` with its phase marks. -> the
        graph entry (graph, static input, outputs, marks). ``carries`` is
        what the capture writes; the warm-up gets a clone (None: the body
        keeps none). Both run at the served threshold."""
        self._tau.fill_(self.threshold)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):           # warm-up, outside capture
            body(None if carries is None else carries.clone(), static)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode=mode), \
                capture_phases() as marks:
            outs = body(carries, static)
        return graph, static, outs, marks.result

    def _load_batch(self, static_x, x) -> None:
        self._tau.fill_(self.threshold)
        static_x.copy_(x)

    def _run_graph(self, entry, load, inp, traced: bool):
        """``load(static input, inp)``, the replay, then the outputs cloned
        out of the graph's buffers (so an earlier call's outputs stay
        valid); each in its span while traced. The untraced call opens no
        context at all: on an H100 machine's host three null contexts add
        1.7-2.3 us to a call, the branch 0.07-0.38 us."""
        graph, static, outs, _ = entry
        if not traced:
            load(static, inp)
            graph.replay()
            return tuple(o.clone() for o in outs)
        with annotation(ENTRY_INPUT):
            load(static, inp)
        with annotation(ENTRY_REPLAY):
            graph.replay()
        with annotation(ENTRY_OUTPUT):
            return tuple(o.clone() for o in outs)

    def graph_phases(self) -> dict:
        """Each captured graph's phase marks, ``((phase, device nodes),
        ...)`` in capture order, keyed as its graph."""
        return {key: entry[3] for key, entry in self._graphs.items()}

    def classify(self, x):
        """x (N, F) -> (pred (N,), HybridStats). Nothing here waits on the
        device when x is already a tensor on it (the first call may, to
        probe the backend and capture); read the stats (or the preds) to
        sync."""
        if tracing():
            return entry_call(self._classify_entry, x)
        return self._classify_entry(x, False)

    def _classify_entry(self, x, traced: bool):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        out = None
        if self._fused_ok is None:
            with annotation(ENTRY_PROBE, traced):
                out = self._probe(x)
        elif self._fused_ok:
            out = self._replay(x, traced)
        if out is None:
            with annotation(ENTRY_EAGER, traced):
                out = self._step(x, self.threshold)
        pred, frac, rows = out
        return pred, HybridStats(frac, rows, self._capacity)

    def update_tables(self, artifact: TableArtifact):
        """§4.4: retraining swaps table *contents*; the shapes (the model
        constraints) must stay as they are. The new contents are copied
        into the served tensors in place, so a captured step serves them
        without re-capture."""
        self.artifact.copy_(finalize_artifact(artifact))
