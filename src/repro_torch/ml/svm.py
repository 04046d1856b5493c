"""Linear SVM with one-vs-one hyperplanes, trained by hinge-loss subgradient
descent.

Port of ``repro/ml/svm.py``. The training output is exactly what IIsy's SVM
mapping (§A.1) consumes: the hyperplane equations ``a·x + d`` for each of
the m = k(k-1)/2 class pairs. The reference draws a PRNG key and never uses
it, so the fit is deterministic and takes no seed here; its ``lax.scan``
over the epochs is a loop. Port and reference agree up to the association
order of the matrix-vector products (the tests bound the gap). Training
runs where its inputs are: ``device=None`` means CUDA.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.device import mean as f32_mean
from repro_torch.device import resolve_device


@dataclasses.dataclass
class LinearSVM:
    weights: torch.Tensor     # (m, F) hyperplane normals
    bias: torch.Tensor        # (m,)
    pairs: torch.Tensor       # (m, 2) int32 class pair (i, j); sign > 0 votes i
    mean: torch.Tensor        # (F,) feature standardization
    scale: torch.Tensor       # (F,)
    n_classes: int = 2

    def to(self, device) -> "LinearSVM":
        return dataclasses.replace(
            self, weights=self.weights.to(device), bias=self.bias.to(device),
            pairs=self.pairs.to(device), mean=self.mean.to(device),
            scale=self.scale.to(device))


def svm_from_arrays(weights, bias, pairs, mean, scale, *, n_classes: int,
                    device=None) -> LinearSVM:
    """Build a model from plain arrays — how a model trained by the
    reference package (or read from disk) crosses over. device=None means
    CUDA; pass device="cpu" for the CPU."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return LinearSVM(weights=t(weights), bias=t(bias),
                     pairs=t(pairs, torch.int32), mean=t(mean),
                     scale=t(scale), n_classes=n_classes)


def _fit_binary(x, y_pm, epochs, lr, reg):
    """Full-batch subgradient descent on hinge loss. y_pm in {-1, +1}.
    Scalars are float32, as in the reference's jitted loop, where XLA also
    turns the division by n into a product with float32(1/n)."""
    n, f = x.shape
    w = torch.zeros((f,), dtype=torch.float32, device=x.device)
    b = torch.zeros((), dtype=torch.float32, device=x.device)
    lr, reg = np.float32(lr), np.float32(reg)
    inv_n = float(np.float32(1.0) / np.float32(n))
    for i in range(epochs):
        margin = y_pm * (x @ w + b)
        active = (margin < 1.0).to(torch.float32)
        gw = float(reg) * w - ((active * y_pm) @ x) * inv_n
        gb = -f32_mean(active * y_pm)
        eta = float(lr / (np.float32(1.0) + np.float32(0.01) * np.float32(i)))
        w = w - eta * gw
        b = b - eta * gb
    return w, b


def fit_linear_svm(x, y, *, n_classes, epochs=300, lr=0.5, reg=1e-3,
                   device=None) -> LinearSVM:
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.asarray(y), device=dev)
    mean = f32_mean(x, dim=0)
    scale = torch.clamp(x.std(0, correction=0), min=1e-6)
    xs = (x - mean) / scale

    pairs = list(itertools.combinations(range(n_classes), 2))
    ws, bs = [], []
    for (i, j) in pairs:
        m = (y == i) | (y == j)
        y_pm = torch.where(y[m] == i, 1.0, -1.0).to(torch.float32)
        w, b = _fit_binary(xs[m], y_pm, epochs, lr, reg)
        ws.append(w)
        bs.append(b)
    return LinearSVM(weights=torch.stack(ws), bias=torch.stack(bs),
                     pairs=torch.tensor(pairs, dtype=torch.int32, device=dev),
                     mean=mean, scale=scale, n_classes=n_classes)


def svm_decision_values(model: LinearSVM, x) -> torch.Tensor:
    """Raw hyperplane values (N, m) — the quantity IIsy tabulates."""
    x = torch.as_tensor(x, dtype=torch.float32, device=model.weights.device)
    xs = (x - model.mean) / model.scale
    return xs @ model.weights.t() + model.bias


def predict_svm(model: LinearSVM, x) -> torch.Tensor:
    vals = svm_decision_values(model, x)                      # (N, m)
    win_i = vals > 0
    votes = torch.zeros((vals.shape[0], model.n_classes), dtype=torch.float32,
                        device=vals.device)
    votes.index_add_(1, model.pairs[:, 0].long(), win_i.to(torch.float32))
    votes.index_add_(1, model.pairs[:, 1].long(), (~win_i).to(torch.float32))
    return torch.argmax(votes, dim=1)
