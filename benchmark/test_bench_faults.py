"""The timed path broken underneath a tiny CPU run: `correct` comes out
false for each fault the cell can have (benchmark/faults.py): a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced; and, in the takeover, an emitter whose backward
gives its rays no gradient. One chip only: no exchange between chips to
leave out."""

import pytest

from benchmark import faults
from benchmark.test_bench_cells import tiny_run

CASES = [
    ("sdf-nerfacto-k5.takeover", "takeover", "unchanged"),
    ("sdf-nerfacto-k5.takeover", "takeover", "half_batch"),
    ("sdf-nerfacto-k5.takeover", "takeover", "altered"),
    ("sdf-nerfacto-k5.takeover", "takeover", "no_backward"),
    ("sdf-nerfacto.pretrain", "pretrain", "unchanged"),
    ("sdf-nerfacto.pretrain", "pretrain", "half_batch"),
    ("sdf-nerfacto.pretrain", "pretrain", "altered"),
]


@pytest.mark.parametrize("cell,kind,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, kind, fault):
    rc, line = tiny_run(cell, plant=faults.FAULTS[fault](kind))
    assert rc == 0
    assert line["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in line["checks"].values())
