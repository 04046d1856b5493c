"""Flow records through the batch form with a language model as the
backend: ``HybridServer.classify`` over DeepSeek-V3 (``launch.serve``'s
``lm_backend``), the whole step one CUDA graph.

A request is a batch of flow records from a pool of distinct batches in
pinned host memory, as in the ``records`` kind: the switch's forest
answers what it is sure of, and the first ``capacity`` rows it is not sure
of (the buffer is always ``capacity`` rows: the forwarded ones, then the
others) go to the backend as 8 tokens a row; its class is logit 0 > logit
1 at the last position. The backend keeps each call's two class logits of
every buffer row and, a MoE layer each, the chosen experts of every token
and counters summed in place (each expert's tokens, the rows the grouped
GEMM B9 stored).
The kind copies the logits and the choices out after each request.

``correct`` is decided on the card once the window has closed and the
program is freed, against ``portbench/reference/deepseek_v3.py`` (float32,
the weights drawn again from the seed) run per pool batch on the rows the
plain switch forwards:

* each request's handled share and backend rows: exact (limit 0);
* ``logit_error``: the largest distance of a row's two class logits from
  the reference's, over the reference's RMS logit of its batch (limit
  ``LOGIT_TOL``);
* ``pred_mismatch``: rows whose class differs, where the reference's
  margin |l0 - l1| exceeds twice that tolerance (limit 0);
* the routing, per token and MoE layer. The reference runs on the
  program's expert sets (of its pool batch's first request), so that the
  layers after see the same tokens on both sides, and holds each set to
  its own choice: one that differs away from a near tie is
  ``route_apart`` (limit 0); at a tie (the reference's 8th and 9th
  s + b, or its 4th and 5th group scores, within ``ROUTE_GAP``) it counts
  in ``route_ties_taken`` (a share of the (token, layer) pairs, limit
  ``TIES_LIMIT``); a request whose choices differ from its pool batch's
  first request is ``route_unstable`` (limit 0);
* ``routed_pairs_mismatch``: the pairs whose rows B9 stored in each layer
  (its down kernel's count, one atomic a block, over its column blocks)
  against 8 x the tokens it was sent (limit 0): nothing dropped.

Off the card the cell is served at ``CARDLESS``'s widths, capacity and
precision: the harness's tests run every cell of BENCHMARK.json on the
CPU, where 52 GB of weights do not fit; the card serves the configuration
file as it stands.

``build`` splits the set-up's ``server`` phase into ``server.imports``
(the program's modules), ``server.weights`` (the served params drawn on
the device) and ``server.hybrid`` (the forest's tables, the backend and
the server).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import laws, lm_roofline, roofline, trees
from portbench.kinds import records
from portbench.reference import EXACT as TREE_EXACT
from portbench.reference import deepseek_v3 as ref_lm
from portbench.reference.hybrid import handled_share
from portbench.reference.trees import Trees

# The limits of the comparison, each with its reason (the readings: my
# chip runs, two seeds, the 8 pool batches of the cell on an H100):
# - LOGIT_TOL: the program computes in bf16 (every product's inputs and
#   outputs, the residual stream, the logits themselves) against the
#   reference's float32, the routing held alike; over 5 layers a class
#   logit moves by up to 0.064-0.075 of the logits' RMS. The control, the
#   reference with fp8 (e4m3, 1 x 128 groups) at every product's input,
#   moves them by 0.460-0.465.
# - ROUTE_GAP: where the program's expert set differs from the
#   reference's, the reference's own choice lay within 0.0062-0.0115 of a
#   tie (its 8th and 9th s + b, or its 4th and 5th group scores): the
#   scores of 256 experts crowd the top (half the tokens have a gap under
#   0.005), and bf16 moves a score by up to ~1e-3. The control's
#   differing tokens reach 0.035-0.050.
# - TIES_LIMIT: the share of (token, MoE layer) pairs where the program
#   chose another set at such a tie: 0.073-0.124 a layer for the program,
#   0.43-0.62 for the control.
LOGIT_TOL = 0.2
ROUTE_GAP = 0.02
TIES_LIMIT = 0.25
LOG_BLOCK = 64          # requests a block of the device logs holds

# a card-less run's DeepSeek-V3: the published mechanisms (8 groups, top-4
# groups, top-8, YaRN, fp8 blocks) at small widths, 32 experts, 32 rows
CARDLESS = {"capacity": 32, "hidden_size": 64, "intermediate_size": 96,
            "kv_lora_rank": 16, "moe_intermediate_size": 32,
            "n_routed_experts": 32, "num_attention_heads": 4,
            "num_key_value_heads": 4, "q_lora_rank": 32,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
            "vocab_size": 512,
            "precision": {"weights": "float8_e4m3fn", "block": 16,
                          "activations": "float32"}}


def fit(cfg: dict, mix: dict, seed: int) -> dict:
    """The seeded inputs: the switch's forest and the pool of request
    batches (numpy), drawn as the ``records`` kind draws them."""
    law = laws.find(mix)
    r_train, r_pool, r_forest = laws.streams(seed, 3)
    nf = cfg["n_features"]
    x, y = law.rows(r_train, mix, mix["train_rows"])
    sw = cfg["switch"]
    switch = trees.fit_forest(x[:, :nf], y, r_forest, n_trees=sw["trees"],
                              depth=sw["depth"])
    pool, _ = law.rows(r_pool, mix, mix["pool_batches"] * mix["batch"])
    return dict(switch=switch,
                pool=np.ascontiguousarray(pool[:, :nf]).reshape(
                    mix["pool_batches"], mix["batch"], nf))


def program_config(lm: dict):
    """The program's ``ArchConfig`` of the cell: the registry's id cut to
    the config's depth (``launch.serve.lm_config``), at the config's
    widths; raises where the registry disagrees with the config file."""
    from repro_torch.launch.serve import lm_config
    from repro_torch.models.config import MLAConfig, PrecisionConfig
    cfg = lm_config(lm["arch"], lm["num_hidden_layers"])
    cfg = dataclasses.replace(
        cfg, d_model=lm["hidden_size"], d_ff=lm["intermediate_size"],
        n_heads=lm["num_attention_heads"],
        n_kv_heads=lm["num_key_value_heads"], vocab_size=lm["vocab_size"],
        mla=MLAConfig(lm["q_lora_rank"], lm["kv_lora_rank"],
                      lm["qk_nope_head_dim"], lm["qk_rope_head_dim"],
                      lm["v_head_dim"]),
        moe=dataclasses.replace(
            cfg.moe, n_experts=lm["n_routed_experts"],
            d_expert=lm["moe_intermediate_size"],
            n_dense_layers=lm["first_k_dense_replace"]),
        precision=PrecisionConfig(**lm["precision"]))
    m = cfg.moe
    want = (m.top_k, m.n_group, m.topk_group, m.routed_scale, m.n_shared,
            m.scoring, cfg.rope_theta, cfg.rope_scaling.factor)
    got = (lm["num_experts_per_tok"], lm["n_group"], lm["topk_group"],
           lm["routed_scaling_factor"], lm["n_shared_experts"],
           lm["scoring_func"], lm["rope_theta"], lm["rope_scaling"]["factor"])
    if want != got:
        raise ValueError(f"the registry's {lm['arch']} {want} is not the "
                         f"config file's {got}")
    return cfg


class TensorLog:
    """Each request's copy of a program buffer, in blocks of
    ``LOG_BLOCK`` requests on the device: one copy a request."""

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.blocks, self.n = [], 0

    def slot(self, j: int) -> torch.Tensor:
        b, i = divmod(j, LOG_BLOCK)
        while b >= len(self.blocks):
            self.blocks.append(torch.empty((LOG_BLOCK,) + self.shape,
                                           dtype=self.dtype,
                                           device=self.device))
        self.n = max(self.n, j + 1)
        return self.blocks[b][i]

    def read(self) -> np.ndarray:
        if not self.blocks:
            return np.zeros((0,) + self.shape)
        return torch.cat(self.blocks)[:self.n].cpu().numpy()


class Cell(records.Cell):
    def configure(self, cfg: dict, mix: dict, seed: int, device) -> None:
        self.lm = self.cfg = cfg if device.type == "cuda" \
            else {**cfg, **CARDLESS}
        self.mix, self.device, self.seed = mix, device, seed
        self.inputs = fit(cfg, mix, seed)
        self.depth = mix["in_flight"]
        self.batch = self.rows_per_request = mix["batch"]
        self.tokens = self.cfg["capacity"] * cfg["backend"]["tokens_per_row"]
        self.n_moe = self.lm["num_hidden_layers"] \
            - self.lm["first_k_dense_replace"]

    def build(self) -> None:
        t = time.perf_counter()
        from repro_torch.core.mapping import map_tree_ensemble
        from repro_torch.launch.serve import lm_backend
        from repro_torch.ml.trees import ensemble_from_arrays
        from repro_torch.models import model as M
        from repro_torch.serving.hybrid_serving import HybridServer
        t = self._phase("server.imports", t)

        cfg = self.cfg
        pcfg = program_config(self.lm)
        params = M.init_serving_model(pcfg, self.seed, device=self.device)
        t = self._phase("server.weights", t)
        sw = self.inputs["switch"]
        art = map_tree_ensemble(
            ensemble_from_arrays(sw.feat, sw.thresh, sw.leaf, "rf",
                                 device="cpu"), cfg["n_features"])
        self.backend = lm_backend(pcfg, params)
        self.server = HybridServer(
            art, self.backend, threshold=cfg["tau"],
            capacity=cfg["capacity"], fuse=None, device=self.device)
        self._phase("server.hybrid", t)
        pool = torch.as_tensor(self.inputs["pool"])
        self.pool = pool.pin_memory() if self.device.type == "cuda" else pool
        self.x = torch.empty((self.depth,) + pool.shape[1:],
                             dtype=pool.dtype, device=self.device)

    def _phase(self, name: str, t: float) -> float:
        """Time since ``t`` kept as set-up phase ``name`` (the card's
        work synchronised first). -> now."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.setup_phases[name] = now - t
        return now

    def restart(self) -> None:
        super().restart()
        k = self.lm["num_experts_per_tok"]
        self.logit_log = TensorLog((self.cfg["capacity"], 2), torch.float32,
                                   self.device)
        self.ids_log = TensorLog((self.n_moe, self.tokens, k), torch.uint8,
                                 self.device)
        if self.backend.routes:
            self.backend.reset_counters()

    def issue(self, j: int, spans=None) -> int:
        super().issue(j, spans)
        self.logit_log.slot(j).copy_(self.backend.logits)
        self.ids_log.slot(j).copy_(self.backend.chosen())
        return j

    # -- after the window ----------------------------------------------------

    def counters(self) -> dict:
        out = super().counters()
        out["expert_tokens"] = self.backend.expert_tokens().cpu().numpy()
        out["routed_pairs"] = self.backend.routed_pairs().cpu().numpy()
        self.routed = out["routed_pairs"]
        return out

    def release(self) -> None:
        self.logits = self.logit_log.read()
        self.ids = self.ids_log.read()
        fused = self.server._fused_ok
        del self.logit_log, self.ids_log
        super().release()
        self.program_counters["fused"] = fused
        del self.backend

    def _reference(self, prec=ref_lm.EXACT, follow=None):
        """Per pool batch: the plain switch's answers, the buffer and the
        LM reference on it. -> (list of dicts, the LM's routes)."""
        dev = self.device
        sw = Trees(self.inputs["switch"], dev, TREE_EXACT)
        cap, tau = self.cfg["capacity"], self.cfg["tau"]
        out, toks = [], []
        for xb in self.inputs["pool"]:
            x = torch.as_tensor(xb, device=dev)
            pred, conf = sw.vote(x)
            fwd = conf < tau
            n = torch.arange(x.shape[0], device=dev)
            idx = torch.cat([n[fwd], n[~fwd]])[:cap]
            valid = fwd[idx]
            tok = (x[idx, :8].abs() * 7).to(torch.int32) \
                % self.lm["vocab_size"]
            tok = torch.nn.functional.pad(tok, (0, max(0, 8 - tok.shape[1])))
            toks.append(tok)
            out.append(dict(pred=pred, idx=idx, valid=valid,
                            frac=float(handled_share(fwd)),
                            rows=int(valid.sum())))
        weights = ref_lm.Weights(self.lm, self.seed, dev,
                                 self.lm["precision"]["block"])
        logits, routes = ref_lm.forward(weights, self.lm, toks, prec,
                                        follow, ROUTE_GAP)
        for o, lg in zip(out, logits):
            o["logits"] = lg
            o["lm_pred"] = (lg[:, 0] > lg[:, 1]).to(o["pred"].dtype)
            full = o["pred"].clone()
            full[o["idx"][o["valid"]]] = o["lm_pred"][o["valid"]]
            o["full_pred"] = full
        return out, routes

    def _follow(self, ids: np.ndarray) -> list:
        """The program's choices for each pool batch, from its first
        request in the logs (None for a batch it did not serve)."""
        return [None if b >= len(ids) else
                [torch.as_tensor(ids[b][m], device=self.device).long()
                 for m in range(self.n_moe)]
                for b in range(len(self.inputs["pool"]))]

    def check(self, traced=None) -> tuple:
        """-> ({name: (value, limit)}, requests failed); ``traced`` (first,
        count): also the bounds of those requests' B1 and B9 launches and
        a request's mean least time (``self.bounds``, ``self.least_s``)."""
        ref, routes = self._reference(follow=self._follow(self.ids))
        self.bounds, self.least_s = ({}, None) if traced is None \
            else self.work(ref, routes, *traced)
        return compare(self.preds, self.frac, self.rows, self.logits,
                       self.ids, ref, routes, self.routed,
                       self.lm["num_experts_per_tok"] * self.tokens)

    def control(self, requests: int) -> dict:
        """The reference with its activations in fp8 in the program's
        place for requests [0, requests), compared as the program is."""
        low, low_routes = self._reference(ref_lm.Precision("fp8"))
        ids = np.stack([np.stack([r["ids"].cpu().numpy() for r in rb])
                        for rb in low_routes])
        ref, routes = self._reference(follow=self._follow(ids))
        n = len(low)
        preds = [low[j % n]["full_pred"].cpu().numpy().astype(np.int8)
                 for j in range(requests)]
        frac = np.array([low[j % n]["frac"] for j in range(requests)],
                        np.float32)
        rows = np.array([low[j % n]["rows"] for j in range(requests)])
        logits = np.stack([low[j % n]["logits"].cpu().numpy()
                           for j in range(requests)])
        pairs = self.lm["num_experts_per_tok"] * self.tokens
        return compare(preds, frac, rows, logits, ids[np.arange(requests)
                                                      % n], ref, routes,
                       np.full(self.n_moe, pairs * requests), pairs)[0]

    def work(self, ref, routes, first: int, count: int) -> tuple:
        """-> (bounds {"b1", "b9"} of the launches of requests [first,
        first + count), the mean least time of a request)."""
        sw = self.inputs["switch"]
        nf = self.cfg["n_features"]
        u = roofline.union_edges(sw, nf)
        pool = self.inputs["pool"]
        lm, block = self.lm, self.lm["precision"]["block"]
        cap, seq = self.cfg["capacity"], self.cfg["backend"]["tokens_per_row"]
        b1 = [roofline.b1_work(self.batch, nf, u, sw.n_trees, 2,
                               roofline.decision_pairs(sw, xb))
              for xb in pool]
        active = [[int(torch.unique(r["ids"]).numel()) for r in rb]
                  for rb in routes]
        least, b1_s, b9_s = [], 0.0, 0.0
        for j, xb in enumerate(pool):
            nb, mo, oo = lm_roofline.request_work(lm, cap, seq, active[j],
                                                  block)
            io = 4 * self.batch * nf + 8 * self.batch
            least.append(lm_roofline.least_s(nb + b1[j][0] + io, mo,
                                             oo + b1[j][1]))
        for j in range(first, first + count):
            p = j % len(pool)
            b1_s += roofline.least_s(*b1[p])
            for a in active[p]:
                for nbytes, ops in lm_roofline.b9_work(lm, self.tokens, a,
                                                       block):
                    b9_s += lm_roofline.least_s(nbytes, ops)
        return ({"b1": (b1_s, count),
                 "b9": (b9_s, count * 2 * self.n_moe)},
                float(np.mean(least)))


def compare(preds, frac, rows, logits, ids, ref: list, routes: list,
            routed, pairs: int) -> tuple:
    """Request j (its predictions, telemetry, class logits and chosen
    experts) against its pool batch's reference (see the module's
    docstring). -> ({name: (value, limit)}, requests that differ)."""
    n_pool = len(ref)
    bad = dict.fromkeys(("pred_mismatch", "handled_share_mismatch",
                         "backend_rows_mismatch", "route_apart",
                         "route_unstable"), 0)
    err, failed, taken, seen = 0.0, 0, 0, 0
    per_batch = []
    for b, o in enumerate(ref):
        lg = o["logits"].cpu().numpy()
        scale = float(np.sqrt(np.mean(lg.astype(np.float64) ** 2)))
        sure = np.ones(len(o["full_pred"]), bool)
        idx, valid = o["idx"].cpu().numpy(), o["valid"].cpu().numpy()
        margin = np.abs(lg[:, 0] - lg[:, 1]) > 2 * LOGIT_TOL * scale
        sure[idx[valid]] = margin[valid]
        own = np.stack([np.sort(r["own"].cpu().numpy(), -1)
                        for r in routes[b]])
        tie = np.stack([r["near"].cpu().numpy() for r in routes[b]]) \
            <= ROUTE_GAP
        per_batch.append((lg, scale, sure, o["full_pred"].cpu().numpy(),
                          own, tie))
    for j in range(len(preds)):
        b = j % n_pool
        lg, scale, sure, pred, own, tie = per_batch[b]
        e = float(np.abs(logits[j] - lg).max()) / scale
        wrong = int(((preds[j] != pred) & sure).sum())
        f_wrong = np.float32(frac[j]) != np.float32(ref[b]["frac"])
        r_wrong = int(rows[j]) != ref[b]["rows"]
        differ = (np.sort(ids[j], -1) != own).any(-1)      # (layers, T)
        apart = int((differ & ~tie).sum())
        unstable = int((ids[j] != ids[b]).any(-1).sum()) if j >= n_pool \
            else 0
        taken += int((differ & tie).sum())
        seen += differ.size
        bad["pred_mismatch"] += wrong
        bad["handled_share_mismatch"] += int(f_wrong)
        bad["backend_rows_mismatch"] += int(r_wrong)
        bad["route_apart"] += apart
        bad["route_unstable"] += unstable
        err = max(err, e)
        failed += int(wrong > 0 or f_wrong or r_wrong or apart > 0
                      or unstable > 0 or e > LOGIT_TOL)
    want = pairs * len(preds)
    out = {k: (v, 0) for k, v in bad.items()}
    out["logit_error"] = (err, LOGIT_TOL)
    out["route_ties_taken"] = (taken / max(seen, 1), TIES_LIMIT)
    out["routed_pairs_mismatch"] = (float(np.abs(
        np.asarray(routed, np.float64) - want).sum()), 0)
    return out, failed
