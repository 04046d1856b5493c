"""Packets through the streaming form: ``StreamingHybridServer.step_chunk``.

Set-up cuts the mix's first ``pool_chunks`` whole chunks (K windows of W
packets) and holds them on the device. Request j serves pool chunk
``j % pool_chunks`` in pass ``j // pool_chunks``; each pass moves on in
data time by the pool's ``span`` (an integer number of seconds past its
last packet), so the stream's data time only moves forward and no packet
is served twice at the same time: the way a classifier fed by the NIC
straight into device memory receives packets. Passes go in epochs of
``epoch_passes`` (as many as ``EPOCH_PACKETS`` packets hold): within an
epoch pass q's timestamps are the pool's plus ``q * span``; as an epoch
starts, the register file's two timestamp rows move back by the epoch's
span instead, outside the timed call. So data time stays below one
epoch's span, where float32 keeps it to tens of microseconds, on the
first pass of the window and on the last. The server's register file and
counters carry from each chunk to the next; the answers of each chunk are
copied to the host. Once the window has closed the reference replays
every chunk served, an epoch a block, from an empty register file, and
every prediction, every chunk's telemetry, the register file and the
counters are held against it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import flows, harness, laws, roofline, trees
from portbench.reference import EXACT, Precision
from portbench.reference.stream import COUNTERS, StreamReplay
from portbench.reference.trees import Trees

EPOCH_PACKETS = 1 << 18       # packets of an epoch's passes, at most


def fit(cfg: dict, mix: dict, seed: int) -> dict:
    """The seeded inputs (numpy): the pool's columns, its span and the two
    forests, fitted on the pool's flows (each flow's bucket's registers
    over the whole pool, labeled by the flow); the packets drawn by the
    mix's packet law."""
    rngs = laws.streams(seed, laws.STREAMS + 2)
    trace = laws.find(mix).packets(rngs[:laws.STREAMS], mix)
    r_sw, r_be = rngs[laws.STREAMS:]
    per_chunk = cfg["chunk_windows"] * cfg["window"]
    n = mix["pool_chunks"] * per_chunk
    if len(trace["ts"]) < n:
        raise ValueError(f"the mix made {len(trace['ts'])} packets, the "
                         f"pool needs {n}")
    cols = flows.columns(trace, cfg["n_buckets"], n)
    x, y = flows.flow_rows(cols, trace["flow_id"][:n], trace["flow_label"],
                           cfg["n_buckets"])
    sw, be = cfg["switch"], cfg["backend"]
    switch = trees.fit_forest(x, y, r_sw, n_trees=sw["trees"],
                              depth=sw["depth"])
    backend = trees.fit_forest(x, y, r_be, n_trees=be["trees"],
                               depth=be["depth"])
    span = float(np.floor(float(cols["ts"][-1])) + 1.0)
    shape = (mix["pool_chunks"], cfg["chunk_windows"], cfg["window"])
    return dict(cols={k: v.reshape(shape) for k, v in cols.items()},
                span=span, switch=switch, backend=backend)


class Cell(harness.Served):
    def configure(self, cfg: dict, mix: dict, seed: int, device) -> None:
        self.cfg, self.mix, self.device = cfg, mix, device
        self.inputs = fit(cfg, mix, seed)
        self.depth = mix["in_flight"]
        self.k, self.w = cfg["chunk_windows"], cfg["window"]
        self.rows_per_request = self.k * self.w
        self.n_pool = mix["pool_chunks"]
        self.epoch_passes = max(1, EPOCH_PACKETS
                                // (self.n_pool * self.rows_per_request))
        self.epoch = self.epoch_passes * self.n_pool      # chunks
        # exact in float32: whole seconds below 2^24
        self.shift = float(np.float32(self.epoch_passes
                                      * self.inputs["span"]))

    def offset(self, j: int) -> float:
        """Request j's time offset within its epoch."""
        q = (j % self.epoch) // self.n_pool
        return float(np.float32(q * self.inputs["span"]))

    def build(self) -> None:
        from repro_torch.core.mapping import map_tree_ensemble
        from repro_torch.ml.trees import (ensemble_from_arrays,
                                          predict_tree_ensemble)
        from repro_torch.netsim.stream import REGISTER_FIELDS, PacketChunk
        from repro_torch.serving.stream_serving import StreamingHybridServer

        cfg, dev = self.cfg, self.device
        sw, be = self.inputs["switch"], self.inputs["backend"]
        art = map_tree_ensemble(
            ensemble_from_arrays(sw.feat, sw.thresh, sw.leaf, "rf",
                                 device="cpu"), 8)
        big = ensemble_from_arrays(be.feat, be.thresh, be.leaf, "rf",
                                   device=dev)
        self.server = StreamingHybridServer(
            art, lambda rows: predict_tree_ensemble(big, rows),
            n_buckets=cfg["n_buckets"], window=self.w,
            threshold=cfg["tau"], capacity=cfg["capacity"],
            chunk_windows=self.k, evict_age=cfg["evict_age"], fuse=None,
            device=dev)
        self.time_rows = [REGISTER_FIELDS.index("t_min"),
                          REGISTER_FIELDS.index("t_max")]
        self.pool = {k: torch.as_tensor(v, device=dev)
                     for k, v in self.inputs["cols"].items()}
        self.ts = torch.empty((self.k, self.w), dtype=torch.float32,
                              device=dev)
        self.valid = torch.ones((self.k, self.w), dtype=torch.bool,
                                device=dev)
        self.chunk = PacketChunk

    def restart(self) -> None:
        """The window starts from an empty register file."""
        super().restart()
        self.server.reset()

    # -- serving -------------------------------------------------------------

    def prepare(self, j: int) -> tuple:
        if j and j % self.epoch == 0:
            regs = self.server.state.regs
            for r in self.time_rows:
                regs[r].sub_(self.shift)
        c = j % self.n_pool
        torch.add(self.pool["ts"][c], self.offset(j), out=self.ts)
        return (self.chunk(bucket=self.pool["bucket"][c], ts=self.ts,
                           length=self.pool["length"][c],
                           is_fwd=self.pool["is_fwd"][c], valid=self.valid),)

    def entry(self, chunk):
        pred, st = self.server.step_chunk(chunk)
        return pred, st.as_tensors()

    # -- after the window ----------------------------------------------------

    def counters(self) -> dict:
        st = self.server.stats
        return {"rows": int(st.packets), "backend_rows": int(st.backend_rows)}

    def release(self) -> None:
        """The program's state and telemetry to the host, then the program
        freed."""
        st = self.server.stats
        self.program_counters = {k: int(getattr(st, k)) for k in COUNTERS}
        self.program_regs = self.server.state.regs.cpu().clone()
        super().release()
        del self.pool, self.ts

    def replay(self, n_chunks: int, each, prec: Precision = EXACT):
        """The reference over chunks [0, n_chunks), an epoch a block:
        ``each(first chunk, predictions, shares, backend rows, replay)`` a
        block. -> the replay (its registers and counters at the end)."""
        dev = self.device
        ref = StreamReplay(self.cfg, Trees(self.inputs["switch"], dev, prec),
                           Trees(self.inputs["backend"], dev, prec), dev,
                           prec)
        pool = {k: torch.as_tensor(v, device=dev)
                for k, v in self.inputs["cols"].items()}
        for first in range(0, n_chunks, self.epoch):
            if first:
                ref.rebase(self.shift)
            js = range(first, min(first + self.epoch, n_chunks))
            cs = torch.as_tensor([j % self.n_pool for j in js], device=dev)
            off = torch.as_tensor([self.offset(j) for j in js],
                                  dtype=torch.float32, device=dev)
            ts = pool["ts"][cs] + off[:, None, None]
            out = ref.feed(pool["bucket"][cs].reshape(-1), ts.reshape(-1),
                           pool["length"][cs].reshape(-1),
                           pool["is_fwd"][cs].reshape(-1))
            each(first, *out, ref)
        return ref

    def check(self, traced=None) -> tuple:
        """-> ({name: (value, limit)}, chunks failed). ``traced`` (first,
        count): also the bounds of those chunks' B1, B5 and B6 launches
        and their mean least time (``self.bounds``, ``self.least_s``)."""
        tally = Tally(self.preds, self.frac, self.rows)
        work = Work(self, traced)

        def each(first, pred, frac, rows, ref):
            tally(first, pred, frac, rows)
            work(first, pred.shape[0], ref)

        ref = self.replay(len(self.preds), each)
        self.bounds, self.least_s = work.result()
        return numbers(ref, tally, self.program_regs, self.program_counters)

    def control(self, n_chunks: int) -> dict:
        """The reference in bfloat16 in the program's place for chunks
        [0, n_chunks), compared as the program is."""
        low = []

        def keep(first, pred, frac, rows, ref):
            low.append((pred.cpu().numpy().astype(np.int8),
                        frac.cpu().numpy(), rows.cpu().numpy()))

        lo = self.replay(n_chunks, keep, Precision(True))
        tally = Tally([p.reshape(-1) for b in low for p in b[0]],
                      np.concatenate([b[1] for b in low]),
                      np.concatenate([b[2] for b in low]))
        ref = self.replay(n_chunks, lambda f, p, fr, r, _: tally(f, p, fr, r))
        return numbers(ref, tally, lo.regs.cpu(), lo.counters)[0]


class Tally:
    """Served answers against the reference's, chunk by chunk: rows whose
    prediction differs, chunks whose telemetry differs, chunks with
    either."""

    def __init__(self, preds, frac, rows):
        self.preds, self.frac, self.rows = preds, frac, rows
        self.pred = self.chunk = self.failed = 0

    def __call__(self, first, pred, frac, rows):
        p = pred.cpu().numpy().astype(np.int8)
        f, r = frac.cpu().numpy(), rows.cpu().numpy()
        for i in range(p.shape[0]):
            j = first + i
            wrong = int((self.preds[j] != p[i].reshape(-1)).sum())
            stat = (np.float32(self.frac[j]) != np.float32(f[i])
                    or int(self.rows[j]) != int(r[i]))
            self.pred += wrong
            self.chunk += int(stat)
            self.failed += int(wrong > 0 or stat)


def numbers(ref, tally: Tally, regs, counters) -> tuple:
    """-> ({name: (value, limit)}, chunks failed): every compared number,
    each exact (limit 0)."""
    r = ref.regs.cpu()
    words = int((r.view(torch.int32) != regs.view(torch.int32)).sum())
    off = sum(int(counters[k] != ref.counters[k]) for k in COUNTERS)
    return ({"pred_mismatch": (tally.pred, 0),
             "chunk_stats_mismatch": (tally.chunk, 0),
             "register_words_mismatch": (words, 0),
             "counter_mismatch": (off, 0)}, tally.failed)


class Work:
    """The least time of the traced chunks' launches, from the replay's
    per-window counts and features (``portbench.roofline``)."""

    def __init__(self, cell, traced):
        self.cell, self.traced = cell, traced
        self.acc = {"b1": 0.0, "b5": 0.0, "b6": 0.0}
        self.per_chunk = []

    def __call__(self, first, n, ref):
        if self.traced is None:
            return
        t0, count = self.traced
        cell = self.cell
        k, w, n_b = cell.k, cell.w, cell.cfg["n_buckets"]
        sw, be = cell.inputs["switch"], cell.inputs["backend"]
        named, changed, evicted = (v.cpu().numpy() for v in ref.windows)
        u = roofline.union_edges(sw, 8)
        walk = roofline.walk_work(k * cell.cfg["capacity"], 8, be.n_trees,
                                  be.depth, 2)
        answers = (8 * k * w, 0)
        for i in range(n):
            if not t0 <= first + i < t0 + count:
                continue
            sl = slice(i * k, (i + 1) * k)
            b5 = [roofline.b5_work(n_b, w, w, int(a), int(c))
                  for a, c in zip(named[sl], changed[sl])]
            b6 = [roofline.b6_work(n_b, w, w, int(e)) for e in evicted[sl]]
            x = ref.x[i * k * w:(i + 1) * k * w].cpu().numpy()
            b1 = roofline.b1_work(k * w, 8, u, sw.n_trees, 2,
                                  roofline.decision_pairs(sw, x))
            self.acc["b1"] += roofline.least_s(*b1)
            self.acc["b5"] += sum(roofline.least_s(*v) for v in b5)
            self.acc["b6"] += sum(roofline.least_s(*v) for v in b6)
            self.per_chunk.append(roofline.least_s(
                *roofline.total(b1, walk, answers, *b5, *b6)))

    def result(self):
        if self.traced is None or not self.per_chunk:
            return {}, None
        count, k = self.traced[1], self.cell.k
        return ({"b1": (self.acc["b1"], count),
                 "b5": (self.acc["b5"], count * k),
                 "b6": (self.acc["b6"], count * k)},
                float(np.mean(self.per_chunk)))
