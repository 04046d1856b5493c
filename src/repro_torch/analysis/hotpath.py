"""Hot-path auditor (rule section ``hotpath``).

Port of ``repro/analysis/hotpath.py``. Builds small instances of every
serving tier (``HybridServer``, ``StreamingHybridServer`` per window,
chunked and deferred, and ``ShardedStreamingServer`` on a one-rank group,
gloo on the CPU and NCCL on the card) and proves, on the step bodies their
``AUDIT_CONTRACTS`` name, the contracts the code and ROADMAP C3 claim:

* **donation** — the reference counts aliases in compiled HLO; a PyTorch
  step "donates" a carry by writing it in place. Every carry tensor (the
  register file, each ``StreamStats`` tensor, the deferral buffer and the
  pending set) keeps its ``data_ptr()`` through an eager body and, on the
  card, through the capture and two replays of its CUDA graph, whose
  static input buffers and outputs stay put too; each carry a row names is
  written (its contents or its version counter move), not returned fresh.
* **zero-sync** — ``dispatch_utils.OpRecorder`` finds no host-sync op in
  any contracted body; on the card the eager body and the replays also run
  under ``torch.cuda.set_sync_debug_mode("error")``.
* **dtype layout** — the dtypes the recorder sees lie in
  ``ALLOWED_DTYPES``; float64 is always a finding.
* **collectives** — each sharded step's census (``distributed.
  collectives``' per-call records) equals its contracted row, with
  exactly the contracted rank >= 2 readout psums and reduce-scatters.

Each body runs once eagerly on its probe (``probe_window``,
``probe_chunk``, or a batch of rows) with the kernels' launches and the
collectives recorded; ``audit`` returns those records, which
``chip_smoke.py`` also reads at the streaming cell's full width.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import dispatch_utils as DU
from repro_torch.analysis.registry import Finding, Rule, RULES, register
from repro_torch.device import resolve_device

# Every dtype a serving step may produce. The reference's three
# (``repro/analysis/hotpath.py:45``: f32 registers and conf_sum, i32
# counters, bool masks), and only what ROADMAP C3 documents on top:
ALLOWED_DTYPES = frozenset({
    "float32", "int32", "bool",
    # C3 "Streaming server": "Predictions keep the switch's dtype: int64
    # for votes"; and the index tensors PyTorch's argsort, gather and
    # scatter take (the reference's are i32 under jit)
    "int64",
    # C3 / distributed.collectives: "NCCL has no bool: a bool tensor
    # crosses as uint8"
    "uint8",
})

# The reference's probe geometry (window 32, 64 buckets, capacity 8, K=4,
# tau 0.7), plus the deferral cycle the deferred rows need (flush_every*
# capacity divides over 4 devices) and an aging horizon, so the sweep runs
# in every audited step.
PROBE = dict(window=32, n_buckets=64, capacity=8, chunk_windows=4,
             threshold=0.7, seed=0, flush_every=2, evict_age=0.5)

# which server knob a row's probe needs
_VARIANTS = {"batch": None, "window": None, "chunk": "chunked",
             "defer": "deferred", "flush": "deferred"}

_SETTINGS = {"device": None}


def set_device(device) -> None:
    """The device the registered rules audit on (None: CUDA)."""
    _SETTINGS["device"] = device


def traceable_backend(rows: torch.Tensor) -> torch.Tensor:
    """A backend a graph can capture (all-zeros answers), the reference's
    ``_traceable_backend``."""
    return torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)


@functools.lru_cache(maxsize=None)
def probe_artifact(device: str):
    """Tiny mapped RF over the FLOW_FEATURES readout layout (the streaming
    tiers' rows are that wide), fitted on ``device``."""
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.ml.trees import fit_random_forest
    from repro_torch.netsim.stream import FLOW_FEATURES
    rng = np.random.RandomState(0)
    x = rng.rand(256, FLOW_FEATURES).astype(np.float32) * 1500.0
    y = (x[:, 0] > x[:, 1]).astype(np.int32)
    m = fit_random_forest(x, y, n_classes=2, n_trees=3, max_depth=3,
                          device=device)
    return map_tree_ensemble(m, FLOW_FEATURES)


@dataclasses.dataclass
class Target:
    label: str
    server: object
    row: dict


@dataclasses.dataclass
class Record:
    """What one contracted body did on its probe."""
    label: str
    row: dict
    n_ops: int = 0
    dtypes: frozenset = frozenset()
    syncs: Tuple = ()            # (op, reason) from the recorder
    sync_errors: Tuple = ()      # RuntimeErrors under the sync debug mode
    calls: Tuple = ()            # collectives: (kind, output ndim)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    donation: Tuple = ()         # donation violations, as messages
    graph: bool = False          # whether the graph route was audited


# -- the carries ------------------------------------------------------------


def carry_tensors(carries: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """{"group.field": tensor} over a mapping group -> carry (a tensor, or
    a dataclass of tensors); None groups are skipped."""
    out = {}
    for group, obj in carries.items():
        if obj is None:
            continue
        if isinstance(obj, torch.Tensor):
            out[group] = obj
            continue
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor):
                out[f"{group}.{f.name}"] = t
    return out


def snapshot(carries: Dict[str, object]) -> Dict[str, tuple]:
    """{"group.field": (data_ptr, version, copy)} of every carry tensor."""
    return {k: (t.data_ptr(), t._version, t.clone())
            for k, t in carry_tensors(carries).items()}


def _written(t: torch.Tensor, snap: tuple) -> bool:
    return t._version != snap[1] or not torch.equal(t, snap[2])


def donation_violations(before: Dict[str, tuple],
                        carries: Dict[str, object],
                        written=()) -> List[str]:
    """Every carry tensor still at its address, and every tensor of each
    group in ``written`` written in place (its contents changed or its
    version counter moved): a step that computed a fresh carry and left
    the old one untouched fails the second, one that moved the storage the
    first."""
    now = carry_tensors(carries)
    out = []
    for k, snap in before.items():
        t = now.get(k)
        if t is None or t.data_ptr() != snap[0]:
            out.append(f"carry {k} moved from its buffer (a fresh tensor "
                       "took its place)")
        elif k.split(".")[0] in written and not _written(t, snap):
            out.append(f"carry {k} was not written in place (the step "
                       "returned a fresh one)")
    return out


def server_carries(srv) -> Dict[str, object]:
    if not hasattr(srv, "_carries"):
        return {}
    return srv._carries()._asdict()


# -- targets ----------------------------------------------------------------


@contextlib.contextmanager
def own_group():
    """Destroys, on the way out, a default process group started inside
    (the one-rank group ``_default_mesh`` starts when none runs), so the
    audit leaves the process as it found it; a group that was running
    before is left alone."""
    import torch.distributed as dist
    had_group = dist.is_initialized()
    try:
        yield
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _default_mesh(dev: torch.device):
    """The one-rank group's mesh (started when no group exists), or at
    four ranks the (2, 2) mesh, or every rank on 'shard'. -> (mesh,
    label suffix)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import flow_shard_mesh
    if dist.is_initialized() and dist.get_world_size() == 4:
        return flow_shard_mesh(2, 2, device=dev), "[2x2]"
    return flow_shard_mesh(device=dev), ""


TIERS = ("HybridServer", "StreamingHybridServer", "ShardedStreamingServer")


def build_targets(geometry: Optional[dict] = None, *, device=None,
                  artifact=None, backend=None, mesh=None,
                  tiers=TIERS) -> List[Target]:
    """(label, server, row) for every contracted row of every serving tier
    in ``tiers`` at ``geometry`` (default ``PROBE``). ``artifact`` and
    ``backend`` default to the probe's tiny RF and all-zeros backend;
    ``mesh`` to the one-rank group's (at four ranks the (2, 2) mesh)."""
    from repro_torch.serving.hybrid_serving import HybridServer
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import StreamingHybridServer
    dev = resolve_device(device)
    g = dict(PROBE, **(geometry or {}))
    art = artifact if artifact is not None else probe_artifact(str(dev))
    be = backend if backend is not None else traceable_backend
    fuse = dev.type == "cuda"            # graphs on the card (a CPU ignores)
    stream_kw = dict(n_buckets=g["n_buckets"], window=g["window"],
                     capacity=g["capacity"], threshold=g["threshold"],
                     evict_age=g["evict_age"], fuse=fuse, device=dev)
    variant_kw = {None: {}, "chunked": {"chunk_windows": g["chunk_windows"]},
                  "deferred": {"flush_every": g["flush_every"]}}
    makers = {
        "HybridServer": lambda v: HybridServer(
            art, be, threshold=g["threshold"], capacity=g["capacity"],
            fuse=fuse, device=dev),
        "StreamingHybridServer": lambda v: StreamingHybridServer(
            art, be, **stream_kw, **variant_kw[v])}
    classes = {"HybridServer": HybridServer,
               "StreamingHybridServer": StreamingHybridServer,
               "ShardedStreamingServer": ShardedStreamingServer}
    names = {t: t for t in tiers}
    if "ShardedStreamingServer" in tiers:
        suffix = ""
        if mesh is None:
            mesh, suffix = _default_mesh(dev)
        names["ShardedStreamingServer"] += suffix
        makers["ShardedStreamingServer"] = lambda v: ShardedStreamingServer(
            art, be, mesh=mesh, **stream_kw, **variant_kw[v])
    tiers = [(names[t], makers[t], classes[t]) for t in tiers]
    targets = []
    for name, make, cls in tiers:
        servers = {}
        for row in cls.AUDIT_CONTRACTS:
            v = _VARIANTS[row["probe"]]
            if v not in servers:
                servers[v] = make(v)
            label = name if v is None else f"{name}[{v}]"
            targets.append(Target(f"{label}.{row['attr']}", servers[v], row))
    return targets


def _probe_input(srv, row, g: dict):
    from repro_torch.serving.stream_serving import probe_chunk, probe_window
    p = row["probe"]
    if p == "batch":
        x = np.random.RandomState(g["seed"]).rand(
            g["window"], srv.artifact.n_features).astype(np.float32)
        return torch.as_tensor(x, device=srv.device)
    if p == "chunk":
        return probe_chunk(g["window"], g["chunk_windows"], g["n_buckets"],
                           g["seed"], device=srv.device)
    if p == "flush":
        return None
    return probe_window(g["window"], g["n_buckets"], g["seed"],
                        device=srv.device)


def _call(srv, row, inp):
    fn = getattr(srv, row["attr"])
    if row["probe"] == "batch":
        return fn(inp, srv._tau)
    if row.get("tau"):
        return fn(srv._carries(), inp, srv._tau)
    return fn(srv._carries(), inp)


@contextlib.contextmanager
def _sync_errors(dev: torch.device, on: bool = True):
    """On the card, turn a host sync into a RuntimeError for the block."""
    if dev.type != "cuda" or not on:
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _graph_buffers(srv, row, key) -> Dict[str, int]:
    """data_ptr of the static input buffers and outputs of the graph a
    row's body was captured into."""
    if row["probe"] == "batch":
        _, static_x, outs, _ = srv._graphs[key]
        ins = {"x": static_x}
    else:
        _, static, outs, _ = srv._step_graphs[key]
        ins = {} if static is None else {
            f.name: getattr(static, f.name)
            for f in dataclasses.fields(static)}
    ptrs = {f"input.{k}": t.data_ptr() for k, t in ins.items()}
    ptrs.update({f"output.{i}": t.data_ptr() for i, t in enumerate(outs)})
    return ptrs


def _audit_graph(srv, row, inp, dev) -> Tuple[List[str], List[str]]:
    """Capture the row's body as the server does and replay it twice
    (``_replay_step``; ``HybridServer._replay`` for a batch row), the
    replays under the sync debug mode: every carry and the graph's own
    buffers stay put, and each call writes the carries. -> (donation
    violations, sync errors)."""
    before = snapshot(server_carries(srv))
    bad, errors, buffers = [], [], None
    for i in range(3):                  # the capture (and a replay), two more
        snap = snapshot(server_carries(srv))
        try:
            with _sync_errors(dev, on=i > 0):
                if row["probe"] == "batch":
                    srv._fused_ok = True
                    key = tuple(inp.shape)
                    srv._replay(inp)
                else:
                    key = ("audit", row["attr"], None if inp is None
                           else tuple(inp.bucket.shape))
                    srv._replay_step(key, getattr(srv, row["attr"]), inp)
        except RuntimeError as exc:
            errors.append(f"graph call {i}: {exc}")
            break
        carries = server_carries(srv)
        moved = donation_violations(before, carries)
        if carries and not moved and not any(
                _written(t, snap[k])
                for k, t in carry_tensors(carries).items()):
            moved.append("the replay wrote no carry")
        bad += [f"graph call {i}: {m}" for m in moved]
        now = _graph_buffers(srv, row, key)
        if buffers is not None and now != buffers:
            bad.append(f"graph call {i}: the graph's input or output "
                       "buffers moved between replays")
        buffers = now
    return bad, errors


def audit_target(t: Target, geometry: Optional[dict] = None) -> Record:
    """Run one contracted body eagerly under the recorder (and on the card
    under the sync debug mode), then, for a captured body on the card,
    through its graph. -> its Record."""
    from repro_torch.distributed import collectives
    g = dict(PROBE, **(geometry or {}))
    srv, row = t.server, t.row
    rec = Record(label=t.label, row=row)
    if not hasattr(srv, row["attr"]):
        rec.donation = ("contracted step attribute is missing on the "
                        "server",)
        return rec
    dev = srv.device
    srv._tau.fill_(srv.threshold)
    inp = _probe_input(srv, row, g)
    if row["probe"] in ("defer", "flush"):
        srv._pos.fill_(0)
    if row["probe"] == "flush":         # a cycle to flush
        srv._deferred_step(srv._carries(),
                           _probe_input(srv, dict(row, probe="window"), g))
    before = snapshot(server_carries(srv))
    collectives.reset_counts()
    launched = DU.kernel_launches()
    recorder = DU.OpRecorder()
    errors = []
    try:
        with _sync_errors(dev), recorder:
            _call(srv, row, inp)
    except RuntimeError as exc:
        if dev.type != "cuda" or "synchroniz" not in str(exc):
            raise
        errors.append(f"eager body: {exc}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.n_ops = len(recorder.ops)
    rec.dtypes = frozenset(recorder.dtypes)
    rec.syncs = tuple(recorder.syncs)
    rec.calls = tuple(collectives.calls())
    rec.launches = DU.launch_delta(launched, DU.kernel_launches())
    donation = donation_violations(before, server_carries(srv),
                                   row.get("carries", ()))
    if dev.type == "cuda" and row.get("graph") and not errors:
        bad, graph_errors = _audit_graph(srv, row, inp, dev)
        donation += bad
        errors += graph_errors
        rec.graph = True
    rec.donation = tuple(donation)
    rec.sync_errors = tuple(errors)
    return rec


def audit(targets: Optional[List[Target]] = None, *, geometry=None,
          device=None, **kw) -> List[Record]:
    """Records for ``targets`` (default: ``build_targets(geometry,
    device=device, **kw)``, whose one-rank group, when it starts one, is
    destroyed before this returns)."""
    if targets is not None:
        return [audit_target(t, geometry) for t in targets]
    with own_group():
        targets = build_targets(geometry, device=device, **kw)
        return [audit_target(t, geometry) for t in targets]


@functools.lru_cache(maxsize=None)
def _records(device: Optional[str]) -> Tuple[Record, ...]:
    return tuple(audit(device=device))


def _gate_records() -> Tuple[Record, ...]:
    dev = _SETTINGS["device"]
    return _records(None if dev is None else str(dev))


# -- rules ------------------------------------------------------------------


def donation_findings(records) -> List[Finding]:
    return [Finding(rule="hotpath-donation", message=f"{r.label}: {m}")
            for r in records for m in r.donation]


def zero_sync_findings(records) -> List[Finding]:
    out = []
    for r in records:
        if r.syncs:
            out.append(Finding(
                rule="hotpath-zero-sync",
                message=(f"{r.label}: host-sync ops in the step body: "
                         f"{sorted({f'{op} ({why})' for op, why in r.syncs})}"
                         )))
        out += [Finding(rule="hotpath-zero-sync",
                        message=f"{r.label}: host sync under the sync debug "
                                f"mode: {e}") for e in r.sync_errors]
    return out


def dtype_findings(records) -> List[Finding]:
    out = []
    for r in records:
        bad = sorted(set(r.dtypes) - ALLOWED_DTYPES)
        if bad:
            out.append(Finding(
                rule="hotpath-dtype",
                message=(f"{r.label}: dtypes outside the register layout "
                         f"{sorted(ALLOWED_DTYPES)}: {bad}")))
    return out


def collective_findings(records) -> List[Finding]:
    out = []
    for r in records:
        census = DU.collective_census(r.calls)
        want = dict(r.row.get("collectives", {}))
        if census != want:
            out.append(Finding(
                rule="hotpath-collectives",
                message=f"{r.label}: collective census {census} != "
                        f"contracted {want}"))
        for key, kind in (("readout_psums", "psum"),
                          ("readout_scatters", "reduce_scatter")):
            promised = r.row.get(key)
            if promised is None:
                continue
            got = DU.readout_count(r.calls, kind)
            if got != promised:
                out.append(Finding(
                    rule="hotpath-collectives",
                    message=f"{r.label}: {got} rank>=2 readout {kind}s, "
                            f"contract promises exactly {promised}"))
    return out


def check_donation() -> List[Finding]:
    return donation_findings(_gate_records())


def check_zero_sync() -> List[Finding]:
    return zero_sync_findings(_gate_records())


def check_dtypes() -> List[Finding]:
    return dtype_findings(_gate_records())


def check_collectives() -> List[Finding]:
    return collective_findings(_gate_records())


# -- seeded-violation self-tests --------------------------------------------


def _selftest_device() -> torch.device:
    return resolve_device(_SETTINGS["device"])


def _selftest_donation() -> List[Finding]:
    """A step that returns a fresh register file, and one that swaps the
    carry's storage, must both be caught."""
    from repro_torch.netsim.stream import FlowTableState, init_flow_table
    dev = _selftest_device()
    out = []

    def fresh(c):                     # computes the new carry, returns it
        return FlowTableState(c["table"].regs + 1.0)

    def swapped(c):                   # rebinds the carry's storage
        c["table"].regs.set_(c["table"].regs + 1.0)

    for name, body in (("fresh", fresh), ("swapped", swapped)):
        carries = {"table": init_flow_table(16, device=dev)}
        before = snapshot(carries)
        body(carries)
        out += [Finding(rule="hotpath-donation",
                        message=f"selftest[{name}]: {m}")
                for m in donation_violations(before, carries, ("table",))]
    return out


def _selftest_zero_sync() -> List[Finding]:
    """A body that calls ``.item()`` (and one that indexes by a mask)."""
    dev = _selftest_device()
    x = torch.arange(8, dtype=torch.float32, device=dev)
    out = []
    for name, body in (("item", lambda: x.sum().item()),
                       ("mask", lambda: x[x > 3.0])):
        rec = DU.OpRecorder()
        with rec:
            body()
        out += [Finding(rule="hotpath-zero-sync",
                        message=f"selftest[{name}]: {op} ({why})")
                for op, why in rec.syncs]
    return out


def _selftest_dtypes() -> List[Finding]:
    """A body that casts to float64."""
    rec = DU.OpRecorder()
    with rec:
        torch.cumsum(torch.zeros(4, device=_selftest_device())
                     .to(torch.float64), 0)
    bad = sorted(rec.dtypes - ALLOWED_DTYPES)
    return [Finding(rule="hotpath-dtype", message=f"selftest: {bad}")] \
        if bad else []


def _selftest_collectives() -> List[Finding]:
    """Seeded census violations: a doubled psum, a doubled reduce-scatter,
    and a rank-1 scatter that must not count as the lane-slab readout."""
    with own_group():
        return _seeded_census_findings(_selftest_device())


def _seeded_census_findings(dev: torch.device) -> List[Finding]:
    from repro_torch.distributed import collectives as C
    mesh, _ = _default_mesh(dev)
    grp = mesh.get_group("shard")
    n = 4 * mesh.size(0) ** 2          # rows that scatter over 'shard' twice
    x = torch.zeros((n, 4), device=dev)
    cases = (
        ("doubled psum", {"collectives": {"psum": 1}},
         lambda: C.psum(C.psum(x, grp), grp)),
        ("doubled reduce_scatter", {"collectives": {"reduce_scatter": 1}},
         lambda: C.psum_scatter(C.psum_scatter(x, grp), grp)),
        ("rank-1 scatter", {"collectives": {"reduce_scatter": 1},
                            "readout_scatters": 1},
         lambda: C.psum_scatter(torch.zeros(n, device=dev), grp)))
    out = []
    for name, row, body in cases:
        C.reset_counts()
        body()
        rec = Record(label=f"selftest[{name}]", row=row,
                     calls=tuple(C.calls()))
        out += collective_findings([rec])
    C.reset_counts()
    return out


def register_rules() -> None:
    rules = (
        Rule(name="hotpath-donation", section="hotpath",
             doc="every carry a contracted step names is written in place "
                 "and keeps its buffer (eager, and through the capture and "
                 "replays of its CUDA graph on the card)",
             check=check_donation, selftest=_selftest_donation),
        Rule(name="hotpath-zero-sync", section="hotpath",
             doc="no host-sync op (item, cross-device copy, data-dependent "
                 "shape) in a contracted step; on the card none under the "
                 "sync debug mode either",
             check=check_zero_sync, selftest=_selftest_zero_sync),
        Rule(name="hotpath-dtype", section="hotpath",
             doc="contracted steps produce only the register layout's "
                 "dtypes (ALLOWED_DTYPES; no float64)",
             check=check_dtypes, selftest=_selftest_dtypes),
        Rule(name="hotpath-collectives", section="hotpath",
             doc="sharded steps send exactly the contracted collective "
                 "census, with its rank>=2 readout psums and scatters",
             check=check_collectives, selftest=_selftest_collectives))
    for rule in rules:
        if rule.name not in RULES:
            register(rule)
