"""NerfactoField (HDR) and the proposal density field (port of
nerf_emitter_tpu/fields/nerfacto_field.py), with both position encodings:
`implementation="hash"` (the multi-resolution hash grid, a `hash_table`
parameter) and `implementation="freq"` (frequency encoding, wider MLPs).

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

from ..ops.hash_grid import hash_grid
from ..ops.spatial_distortions import contracted_to_unit, fake_contraction, scene_contraction_inf
from ..utils.math import safe_exp
from .encodings import HashGridSpec, nerf_encode, sh_encode
from .mlp import MLP


def _contract(positions: torch.Tensor, aabb: torch.Tensor, use_fake_contraction: bool) -> torch.Tensor:
    if use_fake_contraction:
        contracted = fake_contraction(positions, aabb)
    else:
        unit = (positions - aabb[0]) / (aabb[1] - aabb[0])
        contracted = scene_contraction_inf(unit * 2.0 - 1.0)
    return contracted_to_unit(contracted)


def _check_implementation(implementation: str) -> None:
    if implementation not in ("hash", "freq"):
        raise ValueError(f"implementation must be 'hash' or 'freq', got {implementation!r}")


def _encode(module, unit: torch.Tensor) -> torch.Tensor:
    """Contracted unit positions (M, 3) -> the MLP's input features."""
    if module.implementation == "hash":
        return hash_grid(module.hash_table, unit, module.grid_spec)
    return nerf_encode(
        unit * 2.0 - 1.0,
        num_frequencies=module.freq_num_frequencies,
        max_freq_exp=float(module.freq_num_frequencies - 1),
    )


def _carve_out(density, flat, disable_aabb, disable_aabb_on):
    """Zero the density strictly inside `disable_aabb` when it is on."""
    if disable_aabb is None or not disable_aabb_on:
        return density
    box = torch.as_tensor(disable_aabb, dtype=flat.dtype, device=flat.device)
    inside = torch.all((flat > box[0]) & (flat < box[1]), dim=-1, keepdim=True)
    return torch.where(inside, 0.0, density)


class NerfactoField(nn.Module):
    """Radiance field: hash_grid or nerf_encode(F) -> base MLP (density +
    geo features) -> [SH(dirs), geo, appearance] -> rgb head."""

    def __init__(
        self,
        aabb,
        *,
        num_levels: int = 16,
        features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        min_res: int = 16,
        max_res: int = 2048,
        geo_feat_dim: int = 15,
        hidden_dim: int = 64,
        num_layers: int = 2,
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
        _check_implementation(implementation)
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32, device=device))
        self.implementation = implementation
        self.geo_feat_dim = geo_feat_dim
        self.appearance_embedding_dim = appearance_embedding_dim
        self.sh_degree = sh_degree
        self.hdr = hdr
        self.rgb_bias = rgb_bias
        self.use_fake_contraction = use_fake_contraction
        self.average_init_density = average_init_density
        self.freq_num_frequencies = freq_num_frequencies
        if implementation == "hash":
            self.grid_spec = HashGridSpec(num_levels, features_per_level, log2_hashmap_size,
                                          min_res, max_res)
            self.hash_table = nn.Parameter(self.grid_spec.init_table(device=device))
            in_dim, base_layers, base_width = self.grid_spec.out_dim, num_layers, hidden_dim
        else:
            in_dim = 3 * (2 * freq_num_frequencies + 1)
            base_layers, base_width = freq_num_layers, freq_hidden_dim
        self.base_mlp = MLP(
            in_dim, 1 + geo_feat_dim, num_layers=base_layers, layer_width=base_width, device=device,
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
        h = self.base_mlp(_encode(self, unit))
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
    """Proposal density field: a coarse hash grid and a narrow MLP, or
    nerf_encode(F) and one wide hidden layer -> density; same contraction
    and carve-out as the field."""

    def __init__(
        self,
        aabb,
        *,
        num_levels: int = 5,
        features_per_level: int = 2,
        log2_hashmap_size: int = 17,
        min_res: int = 16,
        max_res: int = 128,
        hidden_dim: int = 16,
        num_layers: int = 2,
        use_fake_contraction: bool = True,
        average_init_density: float = 1.0,
        implementation: str = "hash",
        freq_num_frequencies: int = 6,
        freq_hidden_dim: int = 128,
        freq_num_layers: int = 2,
        device=None,
    ):
        super().__init__()
        _check_implementation(implementation)
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32, device=device))
        self.implementation = implementation
        self.use_fake_contraction = use_fake_contraction
        self.average_init_density = average_init_density
        self.freq_num_frequencies = freq_num_frequencies
        if implementation == "hash":
            self.grid_spec = HashGridSpec(num_levels, features_per_level, log2_hashmap_size,
                                          min_res, max_res)
            self.hash_table = nn.Parameter(self.grid_spec.init_table(device=device))
            in_dim, n_layers, width = self.grid_spec.out_dim, num_layers, hidden_dim
        else:
            in_dim, n_layers, width = 3 * (2 * freq_num_frequencies + 1), freq_num_layers, freq_hidden_dim
        self.mlp = MLP(in_dim, 1, num_layers=n_layers, layer_width=width, device=device)

    def forward(self, positions: torch.Tensor, *, disable_aabb=None, disable_aabb_on: bool = False):
        shape = positions.shape[:-1]
        flat = positions.reshape(-1, 3)
        unit = _contract(flat, self.aabb, self.use_fake_contraction)
        selector = torch.all((unit >= 0.0) & (unit <= 1.0), dim=-1, keepdim=True)
        density = self.average_init_density * safe_exp(self.mlp(_encode(self, unit)) - 1.0)
        density = density * selector.to(density.dtype)
        return _carve_out(density, flat, disable_aabb, disable_aabb_on).reshape(shape)
