"""The yardstick's arithmetic: the card's peaks, the NeRF's work per ray
from the configuration's widths, and the least time of a piece of work.
`bound_s` and `mlp_macs` are copies of `chip_smoke.py`'s `bound_ms` and
`mlp_macs`.

The configuration's `model` states every width of the NeRF. The program's
model is built from it (`drivers/common.model_kwargs`), and its Linear
shapes and table rows are held against what these functions derive
(`drivers/common.check_model`): the yardstick describes the model that runs.

Keys of either field:
- `field_width`, `field_hidden_layers`: the field's base MLP, hidden layers
  of that width, 1 + `geo_feat_dim` outputs (density, geometry features);
- `proposal_width`, `proposal_hidden_layers`: each proposal's MLP, one
  density out;
- the head: `sh_coefficients` + `geo_feat_dim` + `appearance_embedding_dim`
  inputs, `head_hidden_layers` layers of `head_width`, rgb out;
- `num_proposal_samples` (one per proposal), `num_nerf_samples`.

The position encoding, by `implementation`:
- `freq`, this repository's frequency-encoded redesign of nerfacto's field:
  `field_frequencies` F gives the base 3 + 6 F inputs; `proposal_frequencies`
  (one per proposal) likewise. It reads no table.
- `hash`, nerfacto's multiresolution hash grid (Instant-NGP): the field's
  `num_levels` levels of `features_per_level` features, at most
  2^`log2_hashmap_size` rows a level, resolutions growing geometrically
  from `min_res` to `max_res`; each proposal's grid from the lists
  `proposal_num_levels`, `proposal_features_per_level`,
  `proposal_log2_hashmap_size`, `proposal_min_res`, `proposal_max_res`
  (one entry per proposal). A level whose (res + 1)^3 corners fit its rows
  is stored densely. An MLP's input is levels x features wide.

At the schedule (256, 96, 48) the freq field is 15.36 M multiply-adds,
30.72 MFLOP, a ray forward (K5's bound at 2^16 rays: 2.036 ms); nerfacto's
published hash field is 0.61 M, 1.22 MFLOP, and 40,448 table lookups.
"""

from __future__ import annotations

import math
from typing import NamedTuple

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
F32 = 4
RAY_BYTES = F32 * (3 + 3 + 3)  # a query ray's origin and direction in, its radiance out
CORNERS = 8  # a trilinear lookup reads a cell's 8 corners


class Grid(NamedTuple):
    """One multiresolution hash grid's sizes."""

    levels: int
    features: int
    log2_hashmap_size: int
    min_res: int
    max_res: int

    def resolutions(self) -> list[int]:
        """Each level's resolution, growing geometrically (Instant-NGP eq. 2)."""
        if self.levels == 1:
            return [self.min_res]
        growth = math.exp((math.log(self.max_res) - math.log(self.min_res)) / (self.levels - 1))
        return [int(math.floor(self.min_res * growth**lv)) for lv in range(self.levels)]

    def rows(self) -> int:
        """The table's rows: each level's (res + 1)^3 corners, at most
        2^log2_hashmap_size."""
        return sum(min((r + 1) ** 3, 2**self.log2_hashmap_size) for r in self.resolutions())


def mlp_macs(dims) -> int:
    """Multiply-adds per evaluation of an MLP with layer widths `dims`
    (input, hidden..., output)."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def hash_grids(config: dict) -> dict:
    """The hash field's grids: {"proposals": [Grid, ...], "field": Grid}."""
    m = config["model"]
    props = zip(m["proposal_num_levels"], m["proposal_features_per_level"], m["proposal_log2_hashmap_size"],
                m["proposal_min_res"], m["proposal_max_res"])
    return {"proposals": [Grid(*g) for g in props],
            "field": Grid(m["num_levels"], m["features_per_level"], m["log2_hashmap_size"], m["min_res"],
                          m["max_res"])}


def _implementation(config: dict) -> str:
    impl = config["model"]["implementation"]
    if impl not in ("freq", "hash"):
        raise ValueError(f"the yardstick knows the fields 'freq' and 'hash', not {impl!r}")
    return impl


def table_rows(config: dict):
    """Each hash table's rows, {"proposals": [...], "field": ...}; None for a
    field whose encoding has no table (`freq`)."""
    if _implementation(config) != "hash":
        return {"proposals": [None] * len(config["model"]["num_proposal_samples"]), "field": None}
    g = hash_grids(config)
    return {"proposals": [p.rows() for p in g["proposals"]], "field": g["field"].rows()}


def nerf_mlp_dims(config: dict) -> dict:
    """The widths of each MLP of the NeRF, from the configuration."""
    m = config["model"]
    if _implementation(config) == "hash":
        g = hash_grids(config)
        prop_in = [p.levels * p.features for p in g["proposals"]]
        base_in = g["field"].levels * g["field"].features
    else:
        prop_in = [3 + 6 * f for f in m["proposal_frequencies"]]
        base_in = 3 + 6 * m["field_frequencies"]
    props = [[i, *([m["proposal_width"]] * m["proposal_hidden_layers"]), 1] for i in prop_in]
    base = [base_in, *([m["field_width"]] * m["field_hidden_layers"]), 1 + m["geo_feat_dim"]]
    head_in = m["sh_coefficients"] + m["geo_feat_dim"] + m["appearance_embedding_dim"]
    head = [head_in, *([m["head_width"]] * m["head_hidden_layers"]), 3]
    return {"proposals": props, "base": base, "head": head}


def _schedule(config: dict, samples=None) -> tuple:
    """The samples a ray of each stage (proposal_0, proposal_1, nerf); None:
    the configuration's."""
    m = config["model"]
    if samples is None:
        return (*m["num_proposal_samples"], m["num_nerf_samples"])
    return tuple(samples)


def ray_flops(config: dict, samples=None) -> float:
    """FLOPs of the NeRF's MLPs for one ray forward at the sample schedule
    (proposal_0, proposal_1, nerf); None: the configuration's."""
    s0, s1, s2 = _schedule(config, samples)
    d = nerf_mlp_dims(config)
    macs = s0 * mlp_macs(d["proposals"][0]) + s1 * mlp_macs(d["proposals"][1])
    macs += s2 * (mlp_macs(d["base"]) + mlp_macs(d["head"]))
    return 2.0 * macs


def encoding_work(config: dict, samples=None) -> dict:
    """The position encoding's work, at the sample schedule (None: the
    configuration's):

    - `lookups`: the table entries one ray forward reads (samples x levels x
      8 corners x features), a count;
    - `bytes`: the least bytes one ray forward moves, each sample's position
      in and features out (f32);
    - `table_bytes`: the tables' bytes (f32), which a forward reads once and
      a backward's table gradient writes once, whatever the rays.

    Lookups are never a bound: L2 holds the coarse levels, so a lookup
    counted at HBM's rate would read over the peak. `freq` reads no table:
    all three are 0."""
    if _implementation(config) != "hash":
        return {"lookups": 0, "bytes": 0, "table_bytes": 0}
    g = hash_grids(config)
    stages = list(zip(_schedule(config, samples), [*g["proposals"], g["field"]]))
    return {"lookups": sum(s * grid.levels * CORNERS * grid.features for s, grid in stages),
            "bytes": sum(s * F32 * (3 + grid.levels * grid.features) for s, grid in stages),
            "table_bytes": sum(F32 * grid.features * grid.rows() for _, grid in stages)}


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of the work: the larger of its operations at the bf16
    peak and its bytes at HBM's rate, and which of the two it is."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
