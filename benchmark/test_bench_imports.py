"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "nerf_emitter_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import contextlib, io, json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from benchmark import run
cell = 'sdf-nerfacto-k5.takeover'
tiny = json.load(open({str(ROOT / 'benchmark' / 'tiny')!r} + '/' + cell + '.json'))
with contextlib.redirect_stdout(io.StringIO()):
    assert run.main(['--workload', cell, '--seed', '5', '--seconds', '0.1'], device='cpu', overrides=tiny) == 0
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "nerf_emitter_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert not _top_level_imports(path) & (FORBIDDEN | {"nerf_emitter_tpu_torch", "benchmark"}), path
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.pipeline, benchmark.compare, benchmark.scene, benchmark.roofline
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "nerf_emitter_tpu_torch" not in out.stdout and "'jax'" not in out.stdout


def test_only_program_py_imports_the_port():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if path.name.startswith("test_bench_") or path.name in ("program.py", "faults.py") or "drivers" in path.parts:
            continue
        assert "nerf_emitter_tpu_torch" not in _top_level_imports(path), path
