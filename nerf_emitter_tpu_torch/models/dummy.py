"""DummyModel: a metrics-only stand-in for SDF-only baselines (port of
nerf_emitter_tpu/models/dummy.py).

The sdf-gt-envmap baseline optimises the SDF under a known envmap and needs
no radiance field; this model returns zeros for the radiance and computes
the eval metrics, so the pipeline and eval plumbing have a model to call.
"""

from __future__ import annotations

import torch
from torch import nn

from ..cameras.rays import RayBundle
from ..engine.train_loop import eval_image_metrics


class DummyModel(nn.Module):
    """Zero radiance everywhere; one unused parameter keeps the optimiser
    groups' machinery shape-compatible."""

    def __init__(self, device=None):
        super().__init__()
        self.unused = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, ray_bundle: RayBundle, **kwargs) -> dict:
        n = ray_bundle.origins.shape[:-1]
        dev = ray_bundle.origins.device
        return {"rgb": torch.zeros((*n, 3), device=dev), "depth": torch.zeros((*n, 1), device=dev),
                "accumulation": torch.zeros((*n, 1), device=dev)}

    @staticmethod
    def get_image_metrics(pred: torch.Tensor, gt: torch.Tensor, is_hdr: bool = True) -> dict:
        return eval_image_metrics(pred, gt, is_hdr=is_hdr)
