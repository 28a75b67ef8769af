"""Every cell of BENCHMARK.json at a tiny size on the CPU (benchmark/tiny/<cell>.json):
the run sets up, measures, traces and compares, and prints a last line of
the contract's shape. Run from the repository's root:

    python -m pytest benchmark/ -q
"""

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from benchmark import run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell: str, root: Path = ROOT) -> dict:
    """The cell's tiny sizes, overrides of its configuration's parts and of
    its traffic (`benchmark/tiny/<cell>.json`)."""
    return json.loads((root / "benchmark" / "tiny" / f"{cell}.json").read_text())


def tiny_run(cell: str, trace: int = 0, seed: int = 3000000001, plant=None, root: Path = ROOT,
             err=None) -> tuple[int, dict | None]:
    """The cell at its tiny size on the CPU: (exit code, the last line);
    standard error goes to `err` where given."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), (plant or contextlib.nullcontext()), \
            (contextlib.redirect_stderr(err) if err is not None else contextlib.nullcontext()):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", overrides=tiny(cell, root), root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "tiny" / f"{w['name']}.json").exists()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_tiny_on_the_cpu(cell, trace):
    rc, line = tiny_run(cell, trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    if trace:
        # a CPU run writes no device metric: only the port's counters read
        counted = {m["name"] for m in BENCH["per_layer"]
                   if cell in m.get("workloads", [cell]) and m["source"] == "program_counter"}
        assert set(line["metrics"]) == counted and dev["busy_s"] == 0.0 and "breakdown" in line
    else:
        want = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_the_command_line_refuses_the_cpu():
    """Without a card the run exits with another code than 0 and prints no
    result (where a card is present this test has nothing to show)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""
