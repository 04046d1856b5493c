"""The streaming switch, replayed: per-flow registers window by window,
the timeout sweep, the 2^24 guard, then the hybrid step on every packet.

Semantics (the configuration's, DESIGN of the streaming tier):

* a window of W packets folds into the (8, N) register file: per bucket
  the packet and byte counts, forward and reverse splits, first and last
  timestamp; every count register is clamped at 2^24 after the window,
  and a register slot that reaches the limit in this window (below it
  before) counts one overflow;
* each packet reads its bucket's registers as they stand after its
  window's fold, derived into 8 features (count, bytes, duration, mean
  inter-arrival, the four splits);
* after the fold, every occupied bucket last seen before
  ``min(newest - evict_age, oldest)`` of the window is reset and counts
  one eviction;
* a chunk of K windows is classified, and in each window the first
  ``capacity`` packets under ``tau`` go to the backend.

The replay is exact and block by block: within a block of windows it
sorts the packets by bucket and sums each flow's run since its last reset
in float64 (every count below 2^24 is exact in float32, and a clamp of a
running sum of non-negative terms is the clamp of the total), so a block
of a million packets costs a few dozen tensor operations. It needs the
stream's timestamps in order, which the traffic guarantees (each trace is
sorted, and each pass of the pool starts after the last ended). The
sweep's cutoffs then never fall, so a bucket is reset between two of its
packets exactly when the cutoff of the window before the later one passes
the earlier one's timestamp.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import EXACT, Precision
from portbench.reference.hybrid import first_forwarded

LIMIT = float(np.float32(1 << 24))
N_REGS = 8
COUNT_ROWS = (0, 1, 4, 5, 6, 7)
COUNTERS = ("windows", "packets", "handled", "backend_rows", "deferred",
            "flushes", "evicted", "overflow")


def empty_registers(n_buckets: int, device) -> torch.Tensor:
    regs = torch.zeros((N_REGS, n_buckets), dtype=torch.float32,
                       device=device)
    regs[2] = float("inf")
    regs[3] = float("-inf")
    return regs


def features(rows: torch.Tensor) -> torch.Tensor:
    """(8, n) register rows -> (n, 8) features: count, bytes, duration,
    mean inter-arrival time, forward and reverse packets and bytes."""
    cnt, byt, t_min, t_max, fp, rp, fb, rb = rows
    dur = torch.where(cnt > 0, t_max - t_min, 0.0)
    iat = torch.where(cnt > 1, dur / torch.clamp(cnt - 1.0, min=1.0), 0.0)
    return torch.stack([cnt, byt, dur, iat, fp, rp, fb, rb], dim=1)


class StreamReplay:
    """The register file and the counters of a stream served from empty.

    ``feed`` takes whole chunks in stream order and returns what the
    switch answered for them; ``regs`` and ``counters`` are the state
    after the last one."""

    def __init__(self, cfg: dict, switch, backend, device,
                 prec: Precision = EXACT):
        self.n_buckets = cfg["n_buckets"]
        self.window = cfg["window"]
        self.k = cfg["chunk_windows"]
        self.evict_age = cfg["evict_age"]
        self.tau = cfg["tau"]
        self.capacity = cfg["capacity"]
        self.switch, self.backend = switch, backend
        self.device = device
        self.prec = prec
        self.regs = empty_registers(self.n_buckets, device)
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.windows = None      # the last block's (named, changed, evicted)
        self.x = None            # the last block's features

    def rebase(self, shift: float) -> None:
        """Move the timestamp registers back by ``shift`` seconds (in
        float32), as the stream's epochs do between blocks."""
        self.regs[2:4] = self.prec(self.regs[2:4] - shift)

    def registers(self, bucket, ts, length, is_fwd):
        """Fold a block of whole windows. -> ((8, n) each packet's
        register row after its window, evictions, overflows); ``regs``
        advances past the block."""
        dev, w = self.device, self.window
        n = bucket.numel()
        nw = n // w
        ar = torch.arange(n, device=dev)
        win = ar // w
        tsw = ts.view(nw, w)
        cutoff = self.prec(torch.minimum(
            tsw.max(dim=1).values - float(np.float32(self.evict_age)),
            tsw.min(dim=1).values))
        bs, perm = torch.sort(bucket.long(), stable=True)
        tss, ws = ts[perm], win[perm]
        ln, fw = length[perm].double(), is_fwd[perm].double()
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = bs[1:] != bs[:-1]
        last = torch.ones(n, dtype=torch.bool, device=dev)
        last[:-1] = first[1:]
        newgrp = first.clone()
        newgrp[1:] |= ws[1:] != ws[:-1]
        carry = self.regs[:, bs]                              # (8, n)
        prev_t = torch.where(first, carry[3], torch.roll(tss, 1))
        prev_occ = ~first | (carry[0] > 0)
        swept = cutoff[(ws - 1).clamp(min=0)]
        evicted_before = newgrp & prev_occ & (ws >= 1) & (swept > prev_t)
        cont = first & prev_occ & ~evicted_before     # continues the carry
        run_start = first | evicted_before
        vals = torch.stack([torch.ones_like(ln), ln, fw, 1.0 - fw,
                            ln * fw, ln * (1.0 - fw)])        # (6, n)
        cs = torch.cumsum(vals, dim=1)
        start = torch.cummax(torch.where(run_start, ar, 0), dim=0).values
        incl = cs - (cs[:, start] - vals[:, start])
        grp = torch.cumsum(newgrp.long(), 0) - 1
        grp_end = torch.zeros(int(grp[-1]) + 1, dtype=torch.long,
                              device=dev).scatter_reduce_(
            0, grp, ar, "amax", include_self=False)[grp]
        grp_start = torch.cummax(torch.where(newgrp, ar, 0), dim=0).values
        carried = cont[start]
        base = torch.where(carried,
                           carry[list(COUNT_ROWS)].double()[:, start], 0.0)
        after = torch.clamp(base + incl[:, grp_end], max=LIMIT)
        before = torch.clamp(base + incl[:, grp_start]
                             - vals[:, grp_start], max=LIMIT)
        n_over = ((after >= LIMIT) & (before < LIMIT))[:, newgrp].sum()
        t_first = tss[start]
        t_min = torch.where(carried, torch.minimum(carry[2][start], t_first),
                            t_first)
        t_max = torch.where(carried, torch.maximum(carry[3][start],
                                                   tss[grp_end]),
                            tss[grp_end])
        a = after.float()
        rows_sorted = torch.stack([a[0], a[1], t_min, t_max,
                                   a[2], a[3], a[4], a[5]])
        # what each window's fold writes: the buckets its lanes name, and
        # the register words whose bits change (for the roofline)
        fresh = run_start & ~carried
        t_before = torch.where(grp_start == start,
                               torch.where(carried, carry[3][start],
                                           float("-inf")),
                               tss[(grp_start - 1).clamp(min=0)])
        words = ((after != before).sum(0) + fresh.long()
                 + (t_max != t_before).long())
        named = torch.bincount(ws[newgrp], minlength=nw)
        changed = torch.bincount(ws[newgrp], words[newgrp].double(),
                                  minlength=nw)
        rows_sorted = self.prec(rows_sorted)
        rows = torch.empty_like(rows_sorted)
        rows[:, perm] = rows_sorted
        # the sweeps after each bucket's last packet of the block, and of
        # the buckets the block never names
        end_cut = cutoff[-1]
        lb = bs[last]
        last_rows = rows_sorted[:, last]
        gone = last_rows[3] < end_cut
        touched = torch.zeros(self.n_buckets, dtype=torch.bool, device=dev)
        touched[lb] = True
        idle_gone = ~touched & (self.regs[0] > 0) & (self.regs[3] < end_cut)
        fills = empty_registers(1, dev)
        regs = self.regs.clone()
        regs[:, lb] = torch.where(gone[None, :], fills, last_rows)
        regs[:, idle_gone] = fills
        n_ev = evicted_before.sum() + gone.sum() + idle_gone.sum()
        at = lambda t: torch.searchsorted(cutoff, t.contiguous(), right=True)
        evicted = (torch.bincount(at(prev_t[evicted_before]), minlength=nw)
                   + torch.bincount(at(last_rows[3][gone]), minlength=nw)
                   + torch.bincount(at(self.regs[3][idle_gone]),
                                    minlength=nw))
        self.windows = (named, changed.long(), evicted)
        self.regs = regs
        return rows, int(n_ev), int(n_over)

    def feed(self, bucket, ts, length, is_fwd):
        """Serve whole chunks (flat, stream order). -> (pred (C, K, W),
        handled share per chunk (C,) f32, backend rows per chunk (C,))."""
        ts = self.prec(ts)
        rows, n_ev, n_over = self.registers(bucket, ts, self.prec(length),
                                            is_fwd)
        x = self.prec(features(rows))
        self.x = x
        sw_pred, conf = self.switch.vote(x)
        k, w = self.k, self.window
        fwd = (conf < self.tau).view(-1, w)
        served = first_forwarded(fwd, self.capacity).view(-1)
        pred = sw_pred.clone()
        if bool(served.any()):
            pred[served] = self.backend.predict(x[served]).to(pred.dtype)
        n_chunks = bucket.numel() // (k * w)
        fwd_c = fwd.view(n_chunks, k * w)
        handled = (~fwd_c).sum(dim=1)
        per_chunk = torch.full((), float(k * w), dtype=torch.float32,
                               device=self.device)
        frac = handled.to(torch.float32) / per_chunk
        rows_c = served.view(n_chunks, k * w).sum(dim=1)
        c = self.counters
        c["windows"] += n_chunks * k
        c["packets"] += bucket.numel()
        c["handled"] += int(handled.sum())
        c["backend_rows"] += int(rows_c.sum())
        c["deferred"] += int(fwd_c.sum()) - int(rows_c.sum())
        c["flushes"] += n_chunks
        c["evicted"] += n_ev
        c["overflow"] += n_over
        return pred.view(n_chunks, k, w), frac, rows_c
