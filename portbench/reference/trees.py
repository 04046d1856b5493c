"""Tree ensembles evaluated by walking the trees, in float32 (or in the
control's bfloat16).

* the switch (a forest mapped to tables) votes: each tree answers the
  class with the most training rows at its leaf (the first on a tie), the
  ensemble the class with the most votes (the first on a tie), and its
  confidence is that vote's share of the trees;
* a forest backend answers the arg max of the mean of its trees' class
  distributions, summed tree by tree in float32;
* a boosted backend answers class 1 where ``base + lr * sum of leaf
  weights`` (tree by tree in float32) is above 0.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import EXACT, Precision


class Trees:
    """An ensemble's arrays on ``device``, rounded by ``prec``."""

    def __init__(self, ens, device, prec: Precision = EXACT):
        self.kind = ens.kind
        self.depth = ens.depth
        self.n_trees = ens.n_trees
        self.base_score = ens.base_score
        self.learning_rate = ens.learning_rate
        self.prec = prec
        self.feat = torch.as_tensor(ens.feat, device=device).long()
        self.thresh = prec(torch.as_tensor(ens.thresh, device=device))
        self.leaf = prec(torch.as_tensor(ens.leaf, device=device))

    def leaves(self, x: torch.Tensor) -> torch.Tensor:
        """(T, n) leaf index of each row in each tree."""
        xt = self.prec(x).t().contiguous()
        node = torch.zeros((self.n_trees, x.shape[0]), dtype=torch.long,
                           device=x.device)
        for _ in range(self.depth):
            f = torch.gather(self.feat, 1, node)
            t = torch.gather(self.thresh, 1, node)
            v = torch.gather(xt, 0, f)
            node = 2 * node + 1 + (v > t).long()
        return node - ((1 << self.depth) - 1)

    def vote(self, x: torch.Tensor):
        """The switch: (pred (n,) int64, confidence (n,) f32)."""
        leaf_class = self.leaf.argmax(dim=2)                  # (T, L)
        cls = torch.gather(leaf_class, 1, self.leaves(x))     # (T, n)
        n_cls = self.leaf.shape[2]
        votes = torch.zeros((x.shape[0], n_cls), dtype=torch.float32,
                            device=x.device)
        votes.scatter_add_(1, cls.t(), torch.ones_like(cls.t(),
                                                       dtype=torch.float32))
        conf = votes.max(dim=1).values / torch.full(
            (), float(self.n_trees), dtype=torch.float32, device=x.device)
        return votes.argmax(dim=1), conf

    def _sequential(self, v: torch.Tensor) -> torch.Tensor:
        total = v[0].clone()
        for t in range(1, v.shape[0]):
            total = self.prec(total + v[t])
        return total

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """A backend's class per row: int64 for a forest, int32 for
        boosting."""
        idx = self.leaves(x)                                  # (T, n)
        if self.kind == "rf":
            c = self.leaf.shape[2]
            counts = torch.gather(self.leaf, 1,
                                  idx[:, :, None].expand(-1, -1, c))
            probs = self.prec(counts / torch.clamp(
                counts.sum(-1, keepdim=True), min=1e-9))
            mean = self._sequential(probs) * float(
                np.float32(1.0) / np.float32(self.n_trees))
            return mean.argmax(dim=1)
        w = torch.gather(self.leaf[..., 0], 1, idx)           # (T, n)
        margin = self.base_score + self.learning_rate * self._sequential(w)
        return (margin > 0.0).to(torch.int32)
