"""The yardstick's arithmetic: the card's peaks, the MLP work of the NeRF
per ray from the configuration's widths, and the least time of
a piece of work. `bound_s` and `mlp_macs` are copies of `chip_smoke.py`'s
`bound_ms` and `mlp_macs`.

The NeRF's MLPs at the configuration's widths (the `freq` field, this
repository's frequency-encoded redesign of nerfacto's hash-grid field):
- proposal level i: the position's frequency encoding, 3 + 6 F_i inputs
  (F = 4, 6), one hidden layer of 128, one density;
- the field's base: 3 + 6 * 10 = 63 inputs, 5 layers of 256, 16 outputs
  (density and 15 geometry features);
- the head: 16 SH coefficients + 15 features + 32 appearance = 63 inputs,
  2 layers of 64, rgb.
At the schedule (256, 96, 48) that is 15.36 M multiply-adds, 30.72 MFLOP, a
ray forward (K5's bound at 2^16 rays: 2.036 ms).
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
RAY_BYTES = 4 * (3 + 3 + 3)  # a query ray's origin and direction in, its radiance out (f32)


def mlp_macs(dims) -> int:
    """Multiply-adds per evaluation of an MLP with layer widths `dims`
    (input, hidden..., output)."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def nerf_mlp_dims(config: dict) -> dict:
    """The widths of each MLP of the NeRF, from the configuration."""
    m = config["model"]
    props = [[3 + 6 * f, *([m["proposal_width"]] * m["proposal_hidden_layers"]), 1]
             for f in m["proposal_frequencies"]]
    base = [3 + 6 * m["field_frequencies"], *([m["field_width"]] * m["field_hidden_layers"]),
            1 + m["geo_feat_dim"]]
    head_in = m["sh_coefficients"] + m["geo_feat_dim"] + m["appearance_embedding_dim"]
    head = [head_in, *([m["head_width"]] * m["head_hidden_layers"]), 3]
    return {"proposals": props, "base": base, "head": head}


def ray_flops(config: dict, samples=None) -> float:
    """FLOPs of the NeRF's MLPs for one ray forward at the sample schedule
    (proposal_0, proposal_1, nerf); None: the configuration's."""
    m = config["model"]
    s0, s1 = m["num_proposal_samples"] if samples is None else samples[:2]
    s2 = m["num_nerf_samples"] if samples is None else samples[2]
    d = nerf_mlp_dims(config)
    macs = s0 * mlp_macs(d["proposals"][0]) + s1 * mlp_macs(d["proposals"][1])
    macs += s2 * (mlp_macs(d["base"]) + mlp_macs(d["head"]))
    return 2.0 * macs


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of the work: the larger of its operations at the bf16
    peak and its bytes at HBM's rate, and which of the two it is."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

