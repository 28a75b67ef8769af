"""The control: the reference in the precision below the configuration's
(its MLPs' operands in fp8 where the configuration states bf16) in the
program's place. At a tiny size on the CPU its numbers move off the
program's (which read 0 there: the same plain PyTorch); on the card, at the
cell's own size, it comes out not correct under the cell's limits
(`python -m benchmark.readings --control-seeds ...` reads it on more seeds)."""

import json

import pytest
import torch

from benchmark import readings
from benchmark.test_bench_cells import CELLS, tiny

torch.set_num_threads(1)


def _rows(capsys, cell, args, **kw):
    assert readings.main(["--workload", cell, *args], **kw) == 0
    # the program's own prints share standard output with the rows
    return [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith('{"workload"')]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_moves_off_the_program_on_the_cpu(capsys, cell):
    rows = _rows(capsys, cell, ["--seeds", "11", "--control-seeds", "11"], device="cpu",
                 overrides=tiny(cell))
    program, control = rows[0]["numbers"], rows[1]["numbers"]
    assert rows[1]["side"] == "control"
    assert any(control[k] > 3 * program[k] and control[k] > 0 for k in program)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(capsys, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    limits = json.load(open(f"benchmark/limits/{cell}.json"))
    (row,) = _rows(capsys, cell, ["--control-seeds", "12"])
    assert any(row["numbers"][k] > limit for k, limit in limits.items())
