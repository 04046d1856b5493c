"""K-means (k-means++ init, Lloyd iterations).

Port of ``repro/ml/kmeans.py``. The k-means++ draws come from a
``torch.Generator`` seeded with ``seed``; they differ from the reference's
``jax.random`` draws, so a model matches the reference only when its
initial centers are handed across (``fit_kmeans(..., init=...)``). Training
runs where its inputs are: ``device=None`` means CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import mean as f32_mean
from repro_torch.device import resolve_device


@dataclasses.dataclass
class KMeansModel:
    centers: torch.Tensor     # (K, F) in the standardized space
    mean: torch.Tensor        # (F,) standardization applied before clustering
    scale: torch.Tensor       # (F,)

    def to(self, device) -> "KMeansModel":
        return dataclasses.replace(self, centers=self.centers.to(device),
                                   mean=self.mean.to(device),
                                   scale=self.scale.to(device))


def kmeans_from_arrays(centers, mean, scale, *, device=None) -> KMeansModel:
    """Build a model from plain arrays — how a model trained by the
    reference package (or read from disk) crosses over. device=None means
    CUDA; pass device="cpu" for the CPU."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)

    return KMeansModel(centers=t(centers), mean=t(mean), scale=t(scale))


def _sq_dists(xs, centers) -> torch.Tensor:
    return torch.sum((xs[:, None, :] - centers[None, :, :]) ** 2, dim=-1)


def _plusplus_init(xs, k, generator) -> torch.Tensor:
    """k-means++: the first center uniformly, each next one with probability
    proportional to the squared distance to the nearest center so far."""
    n = xs.shape[0]
    i0 = torch.randint(0, n, (1,), generator=generator, device=xs.device)
    centers = [xs[i0[0]]]
    for _ in range(1, k):
        d2 = _sq_dists(xs, torch.stack(centers)).min(dim=1).values
        p = d2 / torch.clamp(d2.sum(), min=1e-9)
        idx = torch.multinomial(p, 1, generator=generator)
        centers.append(xs[idx[0]])
    return torch.stack(centers)


def fit_kmeans(x, *, k, iters=50, seed=0, init=None,
               device=None) -> KMeansModel:
    """``init`` (K, F) standardized centers replaces the k-means++ draws,
    e.g. with the reference's, so both packages run the same Lloyd
    iterations."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    mean = f32_mean(x, dim=0)
    scale = torch.clamp(x.std(0, correction=0), min=1e-6)
    xs = (x - mean) / scale
    if init is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        centers = _plusplus_init(xs, k, gen)
    else:
        centers = torch.as_tensor(np.array(init), dtype=torch.float32,
                                  device=dev)
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(xs, centers), dim=1)
        oh = torch.nn.functional.one_hot(assign, k).to(torch.float32)  # (N, K)
        hits = oh.sum(0)
        new = (oh.t() @ xs) / torch.clamp(hits, min=1.0)[:, None]
        centers = torch.where((hits > 0)[:, None], new, centers)
    return KMeansModel(centers=centers, mean=mean, scale=scale)


def kmeans_sq_dists(model: KMeansModel, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=model.centers.device)
    return _sq_dists((x - model.mean) / model.scale, model.centers)


def predict_kmeans(model: KMeansModel, x) -> torch.Tensor:
    return torch.argmin(kmeans_sq_dists(model, x), dim=1)
