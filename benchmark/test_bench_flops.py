"""The yardstick's arithmetic: the NeRF's MLP work a ray at the
configuration's widths (the freq field) and the full schedule (256, 96,
48), and K5's bound."""

import json
from pathlib import Path

import pytest

from benchmark import roofline

CONFIG = json.loads((Path(__file__).resolve().parent / "configs" / "sdf-nerfacto-k5.json").read_text())


def test_a_ray_is_30_72_mflop_at_the_configured_widths():
    d = roofline.nerf_mlp_dims(CONFIG)
    assert d["proposals"] == [[27, 128, 1], [39, 128, 1]]
    assert d["base"] == [63, 256, 256, 256, 256, 256, 16]
    assert d["head"] == [63, 64, 64, 3]
    assert roofline.ray_flops(CONFIG) == 2 * (256 * 3584 + 96 * 5120 + 48 * (282368 + 8320)) == 30724096
    assert roofline.ray_flops(CONFIG) / 1e6 == pytest.approx(30.72, abs=5e-3)


def test_k5s_bound_at_2_16_rays():
    s, by = roofline.bound_s(2**16 * roofline.ray_flops(CONFIG), 2**16 * roofline.RAY_BYTES)
    assert by == "operations" and s * 1e3 == pytest.approx(2.036, abs=1e-3)


def test_both_configurations_share_the_widths():
    other = json.loads((Path(__file__).resolve().parent / "configs" / "sdf-nerfacto.json").read_text())
    assert other["model"] == CONFIG["model"]
