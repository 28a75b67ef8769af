"""The hash-emitter takeover cell (`sdf-nerfacto-hashgrid-emitter.takeover`,
traffic `takeover-hash`) at its tiny size on the CPU: each fault planted
under its timed path makes `correct` false, and its driver's reference
emitter answers a row with a non-finite origin or direction NaN, where the
plain hash encoding would read outside its table.

    python -m pytest benchmark/ -q
"""

import json

import pytest
import torch

from benchmark import faults
from benchmark import run as bench_run
from benchmark.drivers import takeover, takeover_hash
from benchmark.test_bench_cells import ROOT, tiny, tiny_run

torch.set_num_threads(1)

CELL = "sdf-nerfacto-hashgrid-emitter.takeover"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "no_backward"])
def test_a_planted_fault_is_not_correct(fault):
    rc, line = tiny_run(CELL, plant=faults.FAULTS[fault]("takeover"))
    assert rc == 0
    assert line["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in line["checks"].values())


def _driver_and_rows(n=40):
    """The cell's driver at its tiny size with its seeded weights, and n
    rays of which rows 3, 17 and 30 have a NaN origin and direction."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = bench_run.Run(CELL, 3000000023, 0.0, False, torch.device("cpu"), bench, tiny(CELL))
    driver = takeover_hash.Driver(run)
    driver.inputs_from_seed()
    g = torch.Generator().manual_seed(2)
    x = 0.5 + (torch.rand((n, 3), generator=g) - 0.5) * 0.6
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    bad = torch.zeros(n, dtype=torch.bool)
    bad[[3, 17, 30]] = True
    x_bad, d_bad = x.clone(), d.clone()
    x_bad[bad] = float("nan")
    d_bad[bad] = float("nan")
    return driver, x, d, x_bad, d_bad, bad


def test_the_reference_answers_non_finite_rows_nan():
    """Rows with a NaN origin or direction: the plain reference's hash
    encoding refuses them (a corner index below the table on a dense level;
    the proposal grids are dense at their coarse levels); while the
    reference renders its own steps, the driver's reference answers them
    NaN with no gradient, and every other row as the plain reference does,
    gradients included. Outside its own render (the program's calls
    answered again) the driver's reference is the plain one."""
    driver, x, d, x_bad, d_bad, bad = _driver_and_rows()
    plain = takeover.Driver._emitter_fn_of(driver, "bf16")(camera_index=1)
    with pytest.raises(IndexError):
        plain(x_bad, d_bad)
    with pytest.raises(IndexError):
        driver._emitter_fn_of("bf16")(camera_index=1)(x_bad, d_bad)
    driver._own_render = True
    xg = x_bad.clone().requires_grad_()
    out = driver._emitter_fn_of("bf16")(camera_index=1)(xg, d_bad)
    out.sum().backward()
    assert torch.isnan(out[bad]).all() and torch.isfinite(out[~bad]).all()
    xk = x[~bad].clone().requires_grad_()
    want = plain(xk, d[~bad])
    want.sum().backward()
    assert torch.equal(out[~bad].detach(), want.detach())
    assert torch.equal(xg.grad[~bad], xk.grad) and not xg.grad[bad].any()


def test_a_non_finite_program_row_is_a_fault():
    """An emitter call the program made with non-finite rows: each such
    row counts in emitter_nonfinite (limit 0), though the reference does
    not answer it again; the same call with every row finite counts none."""
    driver, x, d, x_bad, d_bad, bad = _driver_and_rows()
    with torch.no_grad():
        out = takeover.Driver._emitter_fn_of(driver, "bf16")(camera_index=1)(x, d)
    for xs, ds, want in ((x, d, 0), (x_bad, d_bad, int(bad.sum()))):
        driver.program_snaps = {"emitter": [{"cam": 1, "x": xs, "d": ds, "grad": (), "out": out,
                                             "out_grad": False}]}
        numbers = driver.check(emitter_only=True)
        assert numbers["emitter_nonfinite"] == want
        assert numbers["emitter_ray_gap"] == 0.0
