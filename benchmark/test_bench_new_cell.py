"""A cell for another NeRF field is added with new files alone. A copy of
the benchmark's files gains a configuration of nerfacto's own field (the
multiresolution hash grid at its published widths), its pretraining cell,
limits, tiny sizes, a reader of the port's span `nerf.forward_backward`,
and entries in `BENCHMARK.json`; the copy's cell runs through `run.main`
on the CPU, traced and not, and no copied file is edited. The yardstick's
widths of both fields are held against the reference model's Linear
shapes and table rows, built on the meta device.

    python -m pytest benchmark/ -q

On the card, `run.main([...], root=new_cell_root(dir))` runs the copy's
cell at the published sizes.
"""

import copy
import hashlib
import io
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import roofline
from benchmark.drivers.common import check_model, model_kwargs, weight_shapes
from benchmark.reference.models.nerfacto import NerfactoModel as RefModel
from benchmark.test_bench_cells import ROOT, tiny, tiny_run

torch.set_num_threads(1)

CONFIG = "sdf-nerfacto-hash"
CELL = f"{CONFIG}.pretrain"
READER = "nerf_forward_backward_host_ms"

# nerfacto's published field (nerfstudio's NerfactoModelConfig; Instant-NGP's
# grid): 16 levels x 2 features, 2^19 rows a level, resolutions 16 -> 2048,
# a 64-wide base MLP; two proposal grids of 5 levels, 2^17 rows, up to 64
# and 256, each with a 16-wide MLP; the 3 x 64 head on SH degree 4
HASH_MODEL = {
    "implementation": "hash",
    "num_levels": 16, "features_per_level": 2, "log2_hashmap_size": 19, "min_res": 16, "max_res": 2048,
    "proposal_num_levels": [5, 5], "proposal_features_per_level": [2, 2], "proposal_log2_hashmap_size": [17, 17],
    "proposal_min_res": [16, 16], "proposal_max_res": [64, 256],
    "field_width": 64, "field_hidden_layers": 1, "proposal_width": 16, "proposal_hidden_layers": 1,
}
FREQ_ONLY = ("proposal_frequencies", "field_frequencies")

# host seconds: on the CPU as on the card
READER_SOURCE = '''"""nerf_forward_backward_host_ms: the host time of the port's span
`nerf.forward_backward` in the traced window, over its steps, in ms."""


def read(r):
    s = (r.get("program_spans") or {}).get("nerf.forward_backward")
    if r.get("kind") != "pretrain" or s is None or not r.get("steps"):
        return None
    return 1e3 * s["host_s"] / r["steps"]
'''


def hash_config() -> dict:
    """sdf-nerfacto's pretraining on nerfacto's published hash field."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "sdf-nerfacto.json").read_text())
    cfg["describes"] = "sdf-nerfacto's NeRF pretraining on nerfacto's own field, the hash grid at its published widths"
    for k in FREQ_ONLY:
        del cfg["model"][k]
    cfg["model"].update(HASH_MODEL)
    cfg["reduced"] = {k: v for k, v in cfg["reduced"].items() if k != "model.implementation"}
    return cfg


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def new_cell_root(root: Path) -> Path:
    """A copy of the benchmark's files at `root` (`BENCHMARK.json` and
    `benchmark/`) with the hash cell added: new files (the configuration,
    limits, tiny sizes, a reader) and new entries in `BENCHMARK.json` (the
    configuration, the cell, the reader's metric, the cell in
    `pretrain_step_ms`' workloads). The tiny sizes cut the field's table
    and finest resolution, which the constructor takes, and use the
    pretraining cell's tiny schedule and batch."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    (b / "configs" / f"{CONFIG}.json").write_text(json.dumps(hash_config(), indent=2))
    (b / "limits" / f"{CELL}.json").write_text((b / "limits" / "sdf-nerfacto.pretrain.json").read_text())
    sizes = tiny("sdf-nerfacto.pretrain")
    sizes["model"].update(log2_hashmap_size=12, max_res=64)
    (b / "tiny" / f"{CELL}.json").write_text(json.dumps(sizes, indent=2))
    (b / "metrics" / f"{READER}.py").write_text(READER_SOURCE)
    bench["configs"].append({"name": CONFIG, "source": "https://arxiv.org/abs/2302.04264",
                             "file": f"benchmark/configs/{CONFIG}.json", "reduced": ["pipeline.sdf_init"],
                             "why": "nerfacto's own field, the hash grid at its published widths"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "pretrain", "chips": 1,
                               "why": "NeRF pretraining at 2^14 rays on 64 views at 256^2 on the hash field"})
    for m in bench["end_to_end"]:
        if "sdf-nerfacto.pretrain" in m.get("workloads", []):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": READER, "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "the NeRF train step", "moves": "pretrain_step_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root


def test_a_hash_cell_runs_from_new_files_alone(tmp_path):
    before_files = _files(ROOT / "benchmark")
    before = json.loads((ROOT / "BENCHMARK.json").read_text())
    root = new_cell_root(tmp_path)
    rc, line = tiny_run(CELL, 0, root=root)
    assert rc == 0 and line["correct"] is True, line
    assert set(line["metrics"]) == {"pretrain_step_ms", "setup_s"}
    err = io.StringIO()
    rc, line = tiny_run(CELL, 1, root=root, err=err)
    assert rc == 0 and line["correct"] is True, line
    assert line["metrics"][READER]["value"] > 0 and set(line["metrics"]) == {READER}
    # the traced reading holds the yardstick's counts and the port's spans
    traced = json.loads(next(s for s in err.getvalue().splitlines() if s.startswith("trace: "))[len("trace: "):])
    rays = 2 * 64  # trace_steps x the tiny batch
    cfg = hash_config()
    cfg["model"].update(tiny(CELL, root)["model"])
    work = roofline.encoding_work(cfg)
    assert traced["encoding_lookups"] == rays * work["lookups"] > 0
    assert traced["encoding_bytes"] == rays * work["bytes"] + 2 * 2 * work["table_bytes"]
    assert traced["flops"] > 0 and "nerf.forward_backward" in traced["program_spans"]
    # no copied file edited; BENCHMARK.json only gained entries
    after = _files(root / "benchmark")
    assert {k: after[k] for k in before_files} == before_files
    now = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert now[key][:len(before[key])] == before[key]
    for old, new in zip(before["end_to_end"], now["end_to_end"]):
        assert {k: v for k, v in new.items() if k != "workloads"} == {k: v for k, v in old.items() if k != "workloads"}
        assert new.get("workloads", [])[:len(old.get("workloads", []))] == old.get("workloads", [])


def _config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", [_config("sdf-nerfacto-k5"), hash_config()], ids=["freq", "hash"])
def test_the_yardstick_matches_the_reference_model(config):
    """nerf_mlp_dims and table_rows against the Linear shapes and table rows
    of the reference model built from the configuration on the meta device;
    a configuration stating a width the constructor does not build is
    refused."""
    kw = model_kwargs(config, 8)
    model = RefModel(kw.pop("aabb"), device="meta", **kw)
    d = roofline.nerf_mlp_dims(config)
    linears = {"proposals": [p.mlp for p in model.proposal_networks], "base": [model.field.base_mlp],
               "head": [model.field.head_mlp]}
    for key, mods in linears.items():
        want = d[key] if key == "proposals" else [d[key]]
        for dims, mod in zip(want, mods, strict=True):
            shapes = [tuple(m.weight.shape) for m in mod.modules() if isinstance(m, torch.nn.Linear)]
            assert shapes == [(b, a) for a, b in zip(dims[:-1], dims[1:])], key
    rows = roofline.table_rows(config)
    tables = [getattr(m, "hash_table", None) for m in (*model.proposal_networks, model.field)]
    assert [None if t is None else t.shape[0] for t in tables] == [*rows["proposals"], rows["field"]]
    weight_shapes(config, 8)  # checks the same, raising nothing
    wrong = copy.deepcopy(config)
    wrong["model"]["head_width"] = 32
    if config["model"]["implementation"] == "hash":
        wrong["model"]["proposal_max_res"] = [128, 256]
    with pytest.raises(ValueError, match="differs from the configuration"):
        check_model(model, wrong)
    with pytest.raises(ValueError, match="differs from the configuration"):
        weight_shapes(wrong, 8)


def test_the_hash_field_at_its_published_widths():
    """1.22 MFLOP and 40,448 table lookups a ray at (256, 96, 48): proposals
    [10, 16, 1], base [32, 64, 16], head [63, 64, 64, 3]; the tables' rows
    from the grids' dense and hashed levels."""
    cfg = hash_config()
    d = roofline.nerf_mlp_dims(cfg)
    assert d == {"proposals": [[10, 16, 1], [10, 16, 1]], "base": [32, 64, 16], "head": [63, 64, 64, 3]}
    assert roofline.ray_flops(cfg) == 2 * ((256 + 96) * 176 + 48 * (3072 + 8320)) == 2 * 608768
    # dense levels: (res + 1)^3 rows up to 2^17 or 2^19; the rest 2^17 or 2^19 each
    assert roofline.table_rows(cfg) == {"proposals": [17**3 + 23**3 + 32**3 + 46**3 + 2**17,
                                                      17**3 + 33**3 + 2**17 * 3],
                                        "field": 17**3 + 23**3 + 31**3 + 43**3 + 59**3 + 11 * 2**19}
    work = roofline.encoding_work(cfg)
    assert work["lookups"] == (256 + 96) * 5 * 8 * 2 + 48 * 16 * 8 * 2 == 40448
    assert work["bytes"] == 4 * ((256 + 96) * (3 + 10) + 48 * (3 + 32))
    assert work["table_bytes"] == 4 * 2 * (278256 + 434066 + 6098925)
    assert roofline.encoding_work(_config("sdf-nerfacto-k5")) == {"lookups": 0, "bytes": 0, "table_bytes": 0}


def test_hash_tables_get_their_own_weights_and_the_rest_stay_bit_equal():
    """make_weights draws a hash table uniform in +-1e-4; every other tensor
    of the two present configurations is bit-equal to the rule before hash
    tables had one of their own: one normal draw, (out, in) N(0, 1/in),
    biases N(0, 0.01^2)."""
    import math

    from benchmark import scene

    for name in ("sdf-nerfacto-k5", "sdf-nerfacto"):
        shapes = weight_shapes(_config(name), 8)
        got = scene.make_weights(shapes, 123456789012, "cpu")
        flat = torch.randn((sum(math.prod(s) for s in shapes.values()),),
                           generator=torch.Generator().manual_seed(123456789012))
        at = 0
        for k, shape in sorted(shapes.items()):
            x = flat[at:at + math.prod(shape)].reshape(shape)
            at += math.prod(shape)
            assert torch.equal(got[k], x / math.sqrt(shape[1]) if len(shape) == 2 else x * 0.01), k
    tables = {k: v for k, v in scene.make_weights(weight_shapes(hash_config(), 8), 5, "cpu").items()
              if k.endswith("hash_table")}
    assert len(tables) == 3
    for t in tables.values():
        assert t.abs().max() <= scene.HASH_TABLE_SCALE and t.std() > 0.5 * scene.HASH_TABLE_SCALE / math.sqrt(3)
