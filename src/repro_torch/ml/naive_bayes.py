"""Gaussian naive Bayes (closed-form fit, log-domain prediction).

Port of ``repro/ml/naive_bayes.py``. The fit is closed-form, so the port
and the reference agree up to the association order of the per-class sums
(``y1h.T @ x``); the tests bound the gap. Training runs where its inputs
are: ``device=None`` means CUDA, as every entry point of the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class GaussianNB:
    mu: torch.Tensor          # (C, F)
    var: torch.Tensor         # (C, F)
    log_prior: torch.Tensor   # (C,)
    n_classes: int = 2

    def to(self, device) -> "GaussianNB":
        return dataclasses.replace(self, mu=self.mu.to(device),
                                   var=self.var.to(device),
                                   log_prior=self.log_prior.to(device))


def nb_from_arrays(mu, var, log_prior, *, n_classes: int,
                   device=None) -> GaussianNB:
    """Build a model from plain arrays — how a model trained by the
    reference package (or read from disk) crosses over. device=None means
    CUDA; pass device="cpu" for the CPU."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)

    return GaussianNB(mu=t(mu), var=t(var), log_prior=t(log_prior),
                      n_classes=n_classes)


def fit_gaussian_nb(x, y, *, n_classes, var_smoothing=1e-6,
                    device=None) -> GaussianNB:
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y1h = torch.nn.functional.one_hot(torch.as_tensor(y, device=dev).long(),
                                      n_classes).to(torch.float32)
    count = torch.clamp(y1h.sum(0), min=1.0)                  # (C,)
    mu = (y1h.t() @ x) / count[:, None]                       # (C, F)
    sq = (y1h.t() @ (x * x)) / count[:, None]
    var = (torch.clamp(sq - mu * mu, min=0.0)
           + var_smoothing * x.var(0, correction=0).max())
    log_prior = torch.log(count / count.sum())
    return GaussianNB(mu=mu, var=var, log_prior=log_prior,
                      n_classes=n_classes)


def nb_log_likelihood(model: GaussianNB, x) -> torch.Tensor:
    """Per-class joint log likelihood log P(y) + sum_i log P(x_i|y). (N, C)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=model.mu.device)
    d = x[:, None, :] - model.mu[None, :, :]                  # (N, C, F)
    ll = -0.5 * (torch.log(2 * math.pi * model.var)[None]
                 + d * d / model.var[None])
    return model.log_prior[None, :] + ll.sum(-1)


def predict_nb(model: GaussianNB, x) -> torch.Tensor:
    return torch.argmax(nb_log_likelihood(model, x), dim=1)
