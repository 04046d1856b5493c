"""Flow records through the batch form: ``HybridServer.classify``.

A request is a batch of flow records from a pool of distinct batches in
pinned host memory, served in turn: its rows are copied to the card, the
server classifies them (on the card the whole step is one CUDA graph) and
its predictions are copied back to the host. Once the window has closed,
every request's predictions and telemetry are held against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness, laws, roofline, trees
from portbench.reference import EXACT, Precision
from portbench.reference.hybrid import handled_share, hybrid_rows
from portbench.reference.trees import Trees


def fit(cfg: dict, mix: dict, seed: int) -> dict:
    """The seeded inputs: training rows, the two ensembles and the pool of
    request batches (numpy), the rows drawn by the mix's record law."""
    law = laws.find(mix)
    r_train, r_pool, r_forest = laws.streams(seed, 3)
    nf = cfg["n_features"]
    x, y = law.rows(r_train, mix, mix["train_rows"])
    x = x[:, :nf]
    sw, be = cfg["switch"], cfg["backend"]
    switch = trees.fit_forest(x, y, r_forest, n_trees=sw["trees"],
                              depth=sw["depth"])
    backend = trees.fit_boosting(x, y, n_trees=be["trees"],
                                 depth=be["depth"],
                                 learning_rate=be["learning_rate"])
    pool, _ = law.rows(r_pool, mix, mix["pool_batches"] * mix["batch"])
    return dict(switch=switch, backend=backend,
                pool=np.ascontiguousarray(pool[:, :nf]).reshape(
                    mix["pool_batches"], mix["batch"], nf))


class Cell(harness.Served):
    def configure(self, cfg: dict, mix: dict, seed: int, device) -> None:
        self.cfg, self.mix, self.device = cfg, mix, device
        self.inputs = fit(cfg, mix, seed)
        self.depth = mix["in_flight"]
        self.batch = self.rows_per_request = mix["batch"]

    def build(self) -> None:
        from repro_torch.core.mapping import map_tree_ensemble
        from repro_torch.ml.trees import (ensemble_from_arrays,
                                          predict_tree_ensemble)
        from repro_torch.serving.hybrid_serving import HybridServer

        cfg = self.cfg
        sw, be = self.inputs["switch"], self.inputs["backend"]
        art = map_tree_ensemble(
            ensemble_from_arrays(sw.feat, sw.thresh, sw.leaf, "rf",
                                 device="cpu"), cfg["n_features"])
        big = ensemble_from_arrays(be.feat, be.thresh, be.leaf, "xgb",
                                   base_score=be.base_score,
                                   learning_rate=be.learning_rate,
                                   device=self.device)
        self.server = HybridServer(
            art, lambda rows: predict_tree_ensemble(big, rows),
            threshold=cfg["tau"], capacity=cfg["capacity"], fuse=None,
            device=self.device)
        pool = torch.as_tensor(self.inputs["pool"])
        self.pool = pool.pin_memory() if self.device.type == "cuda" else pool
        # a request's rows land in its slot's buffer on the device
        self.x = torch.empty((self.depth,) + pool.shape[1:],
                             dtype=pool.dtype, device=self.device)

    # -- serving -------------------------------------------------------------

    def prepare(self, j: int) -> tuple:
        x = self.x[j % self.depth]
        x.copy_(self.pool[j % len(self.pool)], non_blocking=True)
        return (x,)

    def entry(self, x):
        pred, st = self.server.classify(x)
        return pred, st.as_tensors()

    # -- after the window ----------------------------------------------------

    def counters(self) -> dict:
        """The program's telemetry summed over the requests served."""
        rows = self.stat_log.read()[1]
        return {"rows": len(rows) * self.batch,
                "backend_rows": int(rows.sum())}

    def release(self) -> None:
        super().release()
        self.program_counters = {"requests": len(self.rows),
                                 "backend_rows": int(self.rows.sum())}
        del self.pool, self.x

    def _reference(self, prec: Precision = EXACT):
        """Per pool batch: (pred, handled share, backend rows)."""
        sw = Trees(self.inputs["switch"], self.device, prec)
        be = Trees(self.inputs["backend"], self.device, prec)
        out = []
        for xb in self.inputs["pool"]:
            x = torch.as_tensor(xb, device=self.device)
            pred, fwd, served = hybrid_rows(x, sw, be, self.cfg["tau"],
                                            self.cfg["capacity"])
            out.append((pred.cpu().numpy(), float(handled_share(fwd)),
                        int(served.sum())))
        return out

    def check(self, traced=None) -> tuple:
        """-> ({name: (value, limit)}, requests failed). ``traced`` (first,
        count): also the bounds of those requests' B1 launches and a
        request's mean least time (``self.bounds``, ``self.least_s``)."""
        self.bounds, self.least_s = ({}, None) if traced is None \
            else self.work(*traced)
        return compare(self.preds, self.frac, self.rows, self._reference())

    def control(self, requests: int) -> dict:
        """The reference in bfloat16 in the program's place for requests
        [0, requests), compared as the program is."""
        ref = self._reference()
        low = self._reference(Precision(True))
        n = len(low)
        preds = [low[j % n][0].astype(np.int8) for j in range(requests)]
        frac = np.array([low[j % n][1] for j in range(requests)],
                        np.float32)
        rows = np.array([low[j % n][2] for j in range(requests)])
        return compare(preds, frac, rows, ref)[0]

    def work(self, first: int, count: int) -> tuple:
        """-> (bounds of the B1 launches of requests [first, first +
        count), mean least time of a request)."""
        sw, be = self.inputs["switch"], self.inputs["backend"]
        nf = self.cfg["n_features"]
        u = roofline.union_edges(sw, nf)
        pool = self.inputs["pool"]
        b1 = [roofline.b1_work(self.batch, nf, u, sw.n_trees, 2,
                               roofline.decision_pairs(sw, xb)) for xb in pool]
        walk = roofline.walk_work(self.cfg["capacity"], nf, be.n_trees,
                                  be.depth, 1)
        io = (8 * self.batch, 0)                # the answers written
        least = [roofline.least_s(*roofline.total(w, walk, io)) for w in b1]
        b1_s = sum(roofline.least_s(*b1[j % len(pool)])
                   for j in range(first, first + count))
        return {"b1": (b1_s, count)}, float(np.mean(least))


def compare(preds, frac, rows, ref: list) -> tuple:
    """Request j (``preds[j]``, ``frac[j]``, ``rows[j]``) against its
    batch's reference answers: rows whose prediction differs, requests
    whose handled share or backend rows differ. -> ({name: (value, limit
    0)}, requests that differ)."""
    n_pool = len(ref)
    bad_rows = bad_frac = bad_backend = failed = 0
    for j in range(len(preds)):
        p = preds[j]
        r_pred, r_frac, r_rows = ref[j % n_pool]
        wrong = int((p != r_pred).sum())
        f_wrong = np.float32(frac[j]) != np.float32(r_frac)
        b_wrong = int(rows[j]) != r_rows
        bad_rows += wrong
        bad_frac += int(f_wrong)
        bad_backend += int(b_wrong)
        failed += int(wrong > 0 or f_wrong or b_wrong)
    return ({"pred_mismatch": (bad_rows, 0),
             "handled_share_mismatch": (bad_frac, 0),
             "backend_rows_mismatch": (bad_backend, 0)}, failed)
