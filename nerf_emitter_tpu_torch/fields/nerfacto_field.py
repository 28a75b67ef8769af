"""NerfactoField (HDR) and the proposal density field (port of
nerf_emitter_tpu/fields/nerfacto_field.py), `implementation="freq"` only.

- density = safe_exp(raw - 1), zeroed outside the contracted [0,1]^3
  domain (the selector) and, when `disable_aabb_on`, inside the object box
  (the carve-out);
- HDR rgb = safe_exp(raw + rgb_bias), else sigmoid;
- a per-camera appearance embedding feeds the rgb head.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.spatial_distortions import contracted_to_unit, fake_contraction, scene_contraction_inf
from ..utils.math import safe_exp
from .encodings import nerf_encode, sh_encode
from .mlp import MLP

_HASH_TODO = (
    "implementation='hash' is not ported yet (ROADMAP.md, Queue 1 item 1: "
    "hash_encode); use implementation='freq'"
)


def _contract(positions: torch.Tensor, aabb: torch.Tensor, use_fake_contraction: bool) -> torch.Tensor:
    if use_fake_contraction:
        contracted = fake_contraction(positions, aabb)
    else:
        unit = (positions - aabb[0]) / (aabb[1] - aabb[0])
        contracted = scene_contraction_inf(unit * 2.0 - 1.0)
    return contracted_to_unit(contracted)


def _carve_out(density, flat, disable_aabb, disable_aabb_on):
    """Zero the density strictly inside `disable_aabb` when it is on."""
    if disable_aabb is None or not disable_aabb_on:
        return density
    box = torch.as_tensor(disable_aabb, dtype=flat.dtype, device=flat.device)
    inside = torch.all((flat > box[0]) & (flat < box[1]), dim=-1, keepdim=True)
    return torch.where(inside, 0.0, density)


class NerfactoField(nn.Module):
    """Frequency-encoded radiance field: nerf_encode(F) -> base MLP
    (density + geo features) -> [SH(dirs), geo, appearance] -> rgb head."""

    def __init__(
        self,
        aabb,
        *,
        geo_feat_dim: int = 15,
        hidden_dim_color: int = 64,
        num_layers_color: int = 3,
        appearance_embedding_dim: int = 32,
        num_cameras: int = 128,
        sh_degree: int = 4,
        hdr: bool = True,
        rgb_bias: float = 0.0,
        use_fake_contraction: bool = True,
        average_init_density: float = 1.0,
        implementation: str = "hash",
        freq_num_frequencies: int = 10,
        freq_hidden_dim: int = 256,
        freq_num_layers: int = 6,
        device=None,
    ):
        super().__init__()
        if implementation != "freq":
            raise NotImplementedError(_HASH_TODO)
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32, device=device))
        self.geo_feat_dim = geo_feat_dim
        self.appearance_embedding_dim = appearance_embedding_dim
        self.sh_degree = sh_degree
        self.hdr = hdr
        self.rgb_bias = rgb_bias
        self.use_fake_contraction = use_fake_contraction
        self.average_init_density = average_init_density
        self.freq_num_frequencies = freq_num_frequencies
        self.base_mlp = MLP(
            3 * (2 * freq_num_frequencies + 1), 1 + geo_feat_dim,
            num_layers=freq_num_layers, layer_width=freq_hidden_dim, device=device,
        )
        self.head_mlp = MLP(
            sh_degree**2 + geo_feat_dim + appearance_embedding_dim, 3,
            num_layers=num_layers_color, layer_width=hidden_dim_color, device=device,
        )
        if appearance_embedding_dim > 0:
            self.appearance_embedding = nn.Embedding(num_cameras, appearance_embedding_dim, device=device)
            nn.init.normal_(self.appearance_embedding.weight, std=appearance_embedding_dim**-0.5)

    def get_density(
        self,
        positions: torch.Tensor,
        *,
        disable_aabb=None,
        disable_aabb_on: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """positions (..., 3) world -> (density (...), geo_feat (..., G))."""
        shape = positions.shape[:-1]
        flat = positions.reshape(-1, 3)
        unit = _contract(flat, self.aabb, self.use_fake_contraction)
        selector = torch.all((unit >= 0.0) & (unit <= 1.0), dim=-1, keepdim=True)
        feats = nerf_encode(
            unit * 2.0 - 1.0,
            num_frequencies=self.freq_num_frequencies,
            max_freq_exp=float(self.freq_num_frequencies - 1),
        )
        h = self.base_mlp(feats)
        density = self.average_init_density * safe_exp(h[..., :1] - 1.0)
        density = density * selector.to(density.dtype)
        density = _carve_out(density, flat, disable_aabb, disable_aabb_on)
        return density.reshape(shape), h[..., 1:].reshape(*shape, self.geo_feat_dim)

    def get_rgb(
        self,
        geo_feat: torch.Tensor,
        directions: torch.Tensor,
        camera_indices: Optional[torch.Tensor] = None,
        *,
        use_average_appearance: bool = False,
    ) -> torch.Tensor:
        """geo_feat (..., G), unit directions (..., 3) -> rgb (..., 3)."""
        shape = geo_feat.shape[:-1]
        d_enc = sh_encode(directions.reshape(-1, 3), self.sh_degree)
        h = [d_enc, geo_feat.reshape(-1, self.geo_feat_dim)]
        if self.appearance_embedding_dim > 0:
            table = self.appearance_embedding.weight
            if use_average_appearance:
                emb = table.mean(dim=0).expand(d_enc.shape[0], -1)
            else:
                if camera_indices is None:
                    cam = torch.zeros(d_enc.shape[0], dtype=torch.long, device=d_enc.device)
                else:
                    cam = camera_indices
                    while cam.ndim > len(shape):
                        cam = cam[..., 0]
                    cam = cam.expand(shape).reshape(-1).long()
                emb = table[cam]
            h.append(emb)
        raw = self.head_mlp(torch.cat(h, dim=-1))
        rgb = safe_exp(raw, bias=self.rgb_bias) if self.hdr else torch.sigmoid(raw)
        return rgb.reshape(*shape, 3)


class HashMLPDensityField(nn.Module):
    """Proposal density field: nerf_encode(F) -> one wide hidden layer ->
    density; same contraction and carve-out as the field."""

    def __init__(
        self,
        aabb,
        *,
        use_fake_contraction: bool = True,
        average_init_density: float = 1.0,
        implementation: str = "hash",
        freq_num_frequencies: int = 6,
        freq_hidden_dim: int = 128,
        freq_num_layers: int = 2,
        device=None,
    ):
        super().__init__()
        if implementation != "freq":
            raise NotImplementedError(_HASH_TODO)
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32, device=device))
        self.use_fake_contraction = use_fake_contraction
        self.average_init_density = average_init_density
        self.freq_num_frequencies = freq_num_frequencies
        self.mlp = MLP(
            3 * (2 * freq_num_frequencies + 1), 1,
            num_layers=freq_num_layers, layer_width=freq_hidden_dim, device=device,
        )

    def forward(self, positions: torch.Tensor, *, disable_aabb=None, disable_aabb_on: bool = False):
        shape = positions.shape[:-1]
        flat = positions.reshape(-1, 3)
        unit = _contract(flat, self.aabb, self.use_fake_contraction)
        selector = torch.all((unit >= 0.0) & (unit <= 1.0), dim=-1, keepdim=True)
        feats = nerf_encode(
            unit * 2.0 - 1.0,
            num_frequencies=self.freq_num_frequencies,
            max_freq_exp=float(self.freq_num_frequencies - 1),
        )
        density = self.average_init_density * safe_exp(self.mlp(feats) - 1.0)
        density = density * selector.to(density.dtype)
        return _carve_out(density, flat, disable_aabb, disable_aabb_on).reshape(shape)
