"""Spherical-covariance Gaussian mixture by weighted EM (port of
nerf_emitter_tpu/guiding/gmm.py).

The seeding (K points drawn in proportion to their weights) is split from
the EM iterations, so a caller can give the seed indices itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

N_CLUSTER_DEFAULT = 64


def _log_gauss_sphere(points, means, vars_):
    """log N(x | mu_k, var_k I): points (N, 3), means (K, 3), vars (K,) -> (N, K)."""
    d2 = torch.sum((points[:, None, :] - means[None, :, :]) ** 2, dim=-1)
    return -0.5 * (d2 / vars_[None, :] + 3.0 * torch.log(2.0 * math.pi * vars_[None, :]))


def seed_indices(generator: Optional[torch.Generator], weights: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """K point indices drawn with replacement in proportion to weights."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return torch.multinomial(w + 1e-12, n_clusters, replacement=True, generator=generator)


def fit_spherical_gmm(
    generator: Optional[torch.Generator],
    points: torch.Tensor,
    weights: torch.Tensor,
    n_clusters: int = N_CLUSTER_DEFAULT,
    n_iters: int = 30,
    min_var: float = 1e-6,
    seed_idx: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted EM. points (N, 3), weights (N,) >= 0 -> (means (K, 3),
    mixture weights (K,), stds (K,)). The seeds are `seed_idx` (K,) when
    given, else drawn from `generator` (`seed_indices`). A cluster that
    loses all its weight is re-seeded at the heaviest point."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    if seed_idx is None:
        seed_idx = seed_indices(generator, weights, n_clusters)
    means = points[seed_idx.long()]
    d2 = torch.sum((points[:, None, :] - means[None, :, :]) ** 2, dim=-1)
    var0 = torch.clamp(torch.mean(torch.min(d2, dim=1).values), min=min_var).expand(n_clusters)
    vars_ = var0
    pis = torch.full((n_clusters,), 1.0 / n_clusters, device=points.device)
    heavy = points[torch.argmax(w)]
    for _ in range(n_iters):
        log_p = _log_gauss_sphere(points, means, vars_) + torch.log(pis + 1e-12)[None, :]
        log_r = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
        r = torch.exp(log_r) * w[:, None]
        nk = torch.sum(r, dim=0)
        safe_nk = torch.clamp(nk, min=1e-12)
        new_means = (r.T @ points) / safe_nk[:, None]
        d2 = torch.sum((points[:, None, :] - new_means[None, :, :]) ** 2, dim=-1)
        vars_ = torch.clamp(torch.sum(r * d2, dim=0) / (3.0 * safe_nk), min=min_var)
        pis = nk / torch.clamp(torch.sum(nk), min=1e-12)
        empty = nk < 1e-10
        means = torch.where(empty[:, None], heavy[None, :], new_means)
        vars_ = torch.where(empty, var0, vars_)
    return means, pis, torch.sqrt(vars_)
