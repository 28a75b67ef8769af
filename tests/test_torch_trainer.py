"""The port's train CLI and what it needs, against the JAX package where it
has a counterpart: the quality gates and the method configs, the CLI's
flags and config.json, checkpoints (bit for bit, the stored shapes, the
drifted-optimiser and NeRF-only restores), the bridge's train-state loader
against optax, and a CLI run on a tiny synthetic scene: 3 NeRF steps and 2
takeover steps, a checkpoint, then --resume."""

import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_emitter_tpu.configs import methods as jmethods
from nerf_emitter_tpu.engine import train_loop as JT
from nerf_emitter_tpu.utils import writer as jwriter
from nerf_emitter_tpu_torch.bridge import load_train_state
from nerf_emitter_tpu_torch.configs import cli as tcli
from nerf_emitter_tpu_torch.configs import gates as gates_mod
from nerf_emitter_tpu_torch.configs import methods as tmethods
from nerf_emitter_tpu_torch.configs.gates import gate_default, load_gates, write_gate
from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
from nerf_emitter_tpu_torch.engine import checkpoints as ck
from nerf_emitter_tpu_torch.engine import train_loop as TT
from nerf_emitter_tpu_torch.engine.trainer import Trainer
from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne
from nerf_emitter_tpu_torch.renderer import optimize as topt
from nerf_emitter_tpu_torch.scripts import train as train_cli
from nerf_emitter_tpu_torch.utils import profiler
from nerf_emitter_tpu_torch.utils import writer as twriter
from test_torch_hash import hash_pair
from test_torch_train import _by_torch_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# ---- gates and methods (tests/test_gates.py's checks on the port's copy)


@pytest.fixture()
def tmp_gates(tmp_path, monkeypatch):
    """The gates module pointed at a scratch copy of the port's file."""
    path = tmp_path / "gates.json"
    path.write_text((REPO / "nerf_emitter_tpu_torch/configs/gates.json").read_text())
    monkeypatch.setattr(gates_mod, "_GATES_PATH", path)
    return path


def test_port_gates_file_is_the_jax_packages():
    """The port keeps its own gates.json, equal to the JAX package's: a gate
    decided there is copied here on purpose."""
    ours = json.loads((REPO / "nerf_emitter_tpu_torch/configs/gates.json").read_text())
    theirs = json.loads((REPO / "nerf_emitter_tpu/configs/gates.json").read_text())
    assert ours == theirs
    assert load_gates() == ours
    for entry in ours.values():
        assert isinstance(entry["value"], bool)


def test_port_gates_raise_on_unknown_and_malformed(tmp_gates):
    with pytest.raises(KeyError):
        gate_default("no_such_gate")
    with pytest.raises(KeyError):
        write_gate("no_such_gate", True, "t", "t", "t")
    tmp_gates.write_text('{"distill_emitter": true}')
    with pytest.raises(ValueError):
        load_gates()


def test_port_gate_write_and_method_read(tmp_gates):
    """A written gate reads back and reverts; sdf-nerfacto's distill_emitter
    and emitter_samples follow the file."""
    write_gate("distill_emitter", True, decided_by="test", evidence="pass", decided_at="t0")
    assert gate_default("distill_emitter") is True
    write_gate("distill_emitter", False, decided_by="test", evidence="fail", decided_at="t1")
    assert gate_default("distill_emitter") is False and load_gates()["distill_emitter"]["evidence"] == "fail"
    raw = json.loads(tmp_gates.read_text())
    for value in (True, False):
        raw["distill_emitter"]["value"] = raw["emitter_samples_reduced"]["value"] = value
        tmp_gates.write_text(json.dumps(raw))
        cfg = tmethods.METHOD_CONFIGS["sdf-nerfacto"]()
        assert cfg.pipeline.distill_emitter is value
        assert cfg.pipeline.emitter_samples == ((128, 48, 24) if value else None)


def _leaves(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out.update(_leaves(v, f"{prefix}{f.name}.") if dataclasses.is_dataclass(v) else {prefix + f.name: v})
    return out


def test_method_configs_match_jax():
    """Every method, leaf field by leaf field, equals the JAX package's; the
    port adds `device` (default cuda); the descriptions are the same."""
    assert sorted(tmethods.METHOD_CONFIGS) == sorted(jmethods.METHOD_CONFIGS)
    for name in jmethods.METHOD_CONFIGS:
        ours, theirs = _leaves(tmethods.get_method_config(name)), _leaves(jmethods.METHOD_CONFIGS[name]())
        assert ours.pop("device") == "cuda"
        assert ours == theirs, name
    assert tmethods.METHOD_DESCRIPTIONS == jmethods.METHOD_DESCRIPTIONS
    with pytest.raises(KeyError):
        tmethods.get_method_config("no-such-method")


def test_cli_flags_and_config_round_trip(tmp_path):
    """Dotted flags set nested fields (bools, JSON tuples, paths); the saved
    config.json loads back equal, with the port's qualified names; a
    config naming a class outside the package is refused."""
    args = train_cli.build_parser().parse_args(
        ["sdf-gt-envmap", "--pipeline.takeover-step", "7", "--pipeline.use-occlusion", "true",
         "--model.num-proposal-samples", "[16, 8]", "--pipeline.object-aabb", "[[-1, -1, -1], [1, 1, 1]]",
         "--datacfg.data", str(tmp_path), "--device", "cpu"])
    cfg = tcli.dataclass_from_args(tmethods.ExperimentConfig, args)
    assert cfg.pipeline.takeover_step == 7 and cfg.pipeline.use_occlusion is True
    assert cfg.pipeline.guiding_type == "env" and cfg.pipeline.mis_mode == "both"  # the method's defaults
    assert cfg.model.num_proposal_samples == (16, 8) and cfg.pipeline.object_aabb == ((-1, -1, -1), (1, 1, 1))
    assert cfg.datacfg.data == tmp_path and cfg.device == "cpu"
    tcli.save_config(cfg, tmp_path / "config.json")
    text = (tmp_path / "config.json").read_text()
    assert "nerf_emitter_tpu_torch.configs.methods.ExperimentConfig" in text
    assert tcli.load_config(tmp_path / "config.json") == cfg
    (tmp_path / "bad.json").write_text(text.replace("nerf_emitter_tpu_torch.configs.methods", "os"))
    with pytest.raises(ValueError):
        tcli.load_config(tmp_path / "bad.json")


# ---- checkpoints and the bridge


def test_checkpoint_manager_round_trip(tmp_path):
    """A tree of dataclasses, dicts, tuples, tensors and scalars comes back
    bit for bit in the template's structure; the metadata gives the shapes
    without a load; a save at or below the latest step, and a template of
    another shape, raise; only the latest step is kept."""
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import SdfOptState, build_sdf_optimizer, init_mean_params
    from nerf_emitter_tpu_torch.renderer.scene import SdfScene

    cfg = topt.get_opt_config("diffuse-12-relativel1-hqq")
    scene = SdfScene.create(sdf_res=9, tex_res=4)
    scene = scene.replace(sdf=scene.sdf + torch.randn_like(scene.sdf) * 1e-3)
    tx = build_sdf_optimizer(cfg)
    state = SdfOptState(step=3, scene=scene, opt_state=tx.init(scene), mean_params=init_mean_params(scene),
                        mean_count=2)
    mgr = ck.CheckpointManager(tmp_path / "ckpt")
    mgr.save(5, {"sdf": state, "misc": (1.5, None, torch.arange(4))})
    mgr.save(8, {"sdf": state, "misc": (1.5, None, torch.arange(4))})
    assert mgr.steps() == [8] and mgr.latest_step() == 8
    with pytest.raises(RuntimeError):
        mgr.save(8, {"sdf": state})
    meta = mgr.metadata_tree()
    assert meta["sdf"]["scene"]["sdf"].shape == (9, 9, 9, 1) and meta["sdf"]["step"] == 3
    template = {"sdf": SdfOptState(step=0, scene=SdfScene.create(sdf_res=9, tex_res=4),
                                   opt_state=tx.init(scene), mean_params=init_mean_params(scene)),
                "misc": (0.0, None, torch.zeros(4, dtype=torch.long))}
    back = mgr.restore(template)
    assert isinstance(back["sdf"], SdfOptState) and back["sdf"].step == 3 and back["sdf"].mean_count == 2
    assert torch.equal(back["sdf"].scene.sdf, state.scene.sdf) and back["misc"][0] == 1.5
    assert isinstance(back["sdf"].opt_state["sdf"], tuple)
    small = dict(template, sdf=template["sdf"].replace(scene=SdfScene.create(sdf_res=5, tex_res=4)))
    with pytest.raises(ValueError, match="/sdf/scene/sdf"):
        mgr.restore(small)
    zeros = ck.template_from_metadata(meta)
    assert zeros["sdf"]["scene"]["sdf"].shape == (9, 9, 9, 1) and float(zeros["sdf"]["scene"]["sdf"].abs().sum()) == 0


def test_load_train_state_matches_optax():
    """bridge.load_train_state carries JAX's TrainState (the tiny hash NeRF
    after one optax step of random gradients: Adam moments and counts per
    group) into the port: the next step on the same gradients moves every
    parameter as optax does (tests/test_torch_train.py's Adam bar, rtol
    1e-5 and atol 1e-7; measured 9.9e-8 on the hash table), and the
    schedule's lr is JAX's at count 1."""
    _, params, pm = hash_pair()
    tx = JT.build_nerfacto_optimizer(JT.TrainConfig(max_steps=50, lr_fields=1e-2, lr_proposal=5e-3), params)
    j_state = JT.TrainState(step=jnp.int32(0), params=params, opt_state=tx.init(params))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), j_state.params)
             for _ in range(2)]
    upd, opt_state = tx.update(grads[0], j_state.opt_state, j_state.params)
    j_state = j_state.replace(step=j_state.step + 1, params=optax.apply_updates(j_state.params, upd),
                              opt_state=opt_state)
    t_state, t_opt = TT.create_train_state(pm, TT.TrainConfig(max_steps=50, lr_fields=1e-2, lr_proposal=5e-3))
    t_state = load_train_state(pm, t_opt, jax.tree.map(np.array, j_state))
    assert t_state.step == 1
    assert t_opt.lrs()["fields"] == pytest.approx(1e-2 * (1e-3 / 1e-2) ** (1 / 50), rel=1e-6)
    upd, _ = tx.update(grads[1], j_state.opt_state, j_state.params)
    want = _by_torch_name(pm, optax.apply_updates(j_state.params, upd))
    g = _by_torch_name(pm, grads[1])
    for name, p in pm.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(g[name]))
    t_opt.step()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5, atol=1e-7, err_msg=name)
    tree = TT.train_state_tree(t_state, pm, t_opt)
    assert [float(s) for s in tree["opt_state"]["fields"]["step"]][:2] == [2.0, 2.0]


# ---- the CLI on a tiny scene

STEPS = ["--pipeline.takeover-step", "3", "--train.num-rays-per-batch", "64", "--model.num-proposal-samples",
         "[16, 8]", "--model.num-nerf-samples", "8", "--pipeline.distill-steps", "2", "--pipeline.spp", "2",
         "--pipeline.batch-size", "2", "--pipeline.takeover-image-size", "8", "--pipeline.tsdf-init-res", "16",
         "--steps-per-eval-image", "4", "--steps-per-save", "4"]


@pytest.fixture()
def cli_run(tmp_path, monkeypatch):
    """argv -> main(argv) on a synthetic scene of 8 views at 16^2 on the
    CPU: TensorBoard left out (its import costs seconds), the distillation
    at 2^8 queries a step (the default 2^14 cut for the CPU), the guiding
    at 16 probes a view; the Trainer's load_checkpoint recorded."""
    data = make_synthetic_dataset(tmp_path / "scene", n_views=8, width=16, height=16)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(tne, "DistillConfig", functools.partial(tne.DistillConfig, batch=1 << 8))
    loaded = []
    real_load = Trainer.load_checkpoint

    def load_checkpoint(self, *a, **kw):
        real_load(self, *a, **kw)
        p = self.pipeline
        schedule = tuple(getattr(p, k, None) for k in ("_takeover_size", "_takeover_spp", "_lr_up_scale"))
        loaded.append((self._nerf_tree(), p.sdf_state, schedule))

    monkeypatch.setattr(Trainer, "load_checkpoint", load_checkpoint)
    base = ["sdf-nerfacto", "--datacfg.data", str(data), "--output-dir", str(tmp_path / "out"),
            "--experiment-name", "tiny", "--device", "cpu", *STEPS]
    return (lambda *extra: train_cli.main(base + list(extra))), loaded


def _trees_equal(a, b) -> bool:
    a, b = ck.to_tree(a), ck.to_tree(b)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_train_cli_runs_checkpoints_and_resumes(cli_run):
    """sdf-nerfacto through the CLI: 3 NeRF steps and 2 takeover steps, an
    eval view and a checkpoint at step 4, the final one at 5; then
    --resume to 7 in a new Trainer. Held: events.jsonl's rows (the train
    metrics with the reference's rays/s and ETA names at step 0, the eval
    metrics at step 4), config.json loads back equal, the restored NeRF and
    SDF states bit-equal to the first run's last, the replayed schedule
    equal to it, the resumed run's takeover steps counted."""
    run, loaded = cli_run
    first = run("--max-num-iterations", "5")
    run_dir = first.run_dir
    rows = [json.loads(line) for line in (run_dir / "logs/events.jsonl").read_text().splitlines()]
    by_step = {r["step"]: r for r in rows}
    assert sorted(by_step) == [0, 4]
    assert {"loss", "rgb_loss", jwriter.TRAIN_RAYS_PER_SEC, jwriter.ETA} <= set(by_step[0])
    assert (twriter.TRAIN_RAYS_PER_SEC, twriter.ETA) == (jwriter.TRAIN_RAYS_PER_SEC, jwriter.ETA)
    assert {"eval/psnr", "eval/ssim", "eval/mape"} <= set(by_step[4])
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k != "ts")
    assert (run_dir / "logs/images/eval_rgb_000004.exr").exists()
    assert tcli.load_config(run_dir / "config.json") == first.config
    assert first.ckpt.steps() == [5] and first.pipeline.sdf_state.step == 2
    saved_nerf, saved_sdf = first._nerf_tree(), first.pipeline.sdf_state
    saved_schedule = (first.pipeline._takeover_size, first.pipeline._takeover_spp, first.pipeline._lr_up_scale)

    second = run("--max-num-iterations", "7", "--resume")
    (nerf, sdf, schedule), = loaded
    assert _trees_equal(nerf, saved_nerf) and _trees_equal(sdf, saved_sdf)
    assert schedule == saved_schedule
    assert second.pipeline.sdf_state.step == 4 and second.pipeline.nerf_state.step == 3
    assert second.ckpt.steps() == [7]
    # Trainer.train traces its run (the NeRF's and the takeover's steps) and
    # leaves the library's tracing off
    summary = profiler.summary()
    assert "train_iteration" in summary and "nerf.step" in summary and "takeover.step" in summary
    assert not profiler.enabled()


def test_train_cli_restores_nerf_only_and_a_drifted_optimizer(cli_run):
    """--load-nerf-only drops the SDF state; a checkpoint whose SDF optimizer
    state has another structure than the current recipe's (uniform Adam's
    scalar second moment against per-coordinate Adam's) restores the scene
    and the running means and starts the moments afresh."""
    run, _ = cli_run
    first = run("--max-num-iterations", "5")
    saved_sdf = first.pipeline.sdf_state
    trainer = Trainer(first.config)
    trainer.setup()
    trainer.load_checkpoint(nerf_only=True)
    assert trainer.pipeline.sdf_state is None and _trees_equal(trainer._nerf_tree(), first._nerf_tree())

    trainer = Trainer(first.config)
    trainer.setup()
    opt = trainer.pipeline.opt_config
    trainer.pipeline.opt_config = dataclasses.replace(
        opt, variables=tuple(dataclasses.replace(v, smooth_lam=0.0, optimizer="adam") for v in opt.variables))
    trainer.load_checkpoint()
    got = trainer.pipeline.sdf_state
    assert _trees_equal(got.scene, saved_sdf.scene) and _trees_equal(got.mean_params, saved_sdf.mean_params)
    assert got.opt_state["sdf"]["count"] == 0 and got.opt_state["sdf"]["nu"].shape == got.scene.sdf.shape


def test_train_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without --device cpu the run is CUDA's: with no CUDA device the CLI
    raises before any work, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["sdf-nerfacto", "--datacfg.data", str(tmp_path), "--output-dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_profiler_times_blocks_and_reports_on_stderr(capsys):
    """time_block and time_function count calls and seconds per name; the
    summary printed at exit goes to standard error, so a program's last
    line of standard output stays its own."""
    profiler.enable(True)
    try:
        @profiler.time_function(name="test.fn")
        def fn():
            return 3

        with profiler.time_block("test.block"):
            assert fn() == 3
    finally:
        profiler.disable()
    assert profiler._STATS["test.fn"][0] >= 1 and profiler._STATS["test.block"][0] >= 1
    assert "test.block" in profiler.summary()
    profiler._print_summary()
    out, err = capsys.readouterr()
    assert out == "" and "profiler summary" in err


def test_method_run_times_the_stages(tmp_path, monkeypatch, capsys):
    """scripts/method_run.py on the CPU at a tiny size: the synthetic scene
    written, the CLI run, and one JSON line with every stage's calls, the
    takeover by render size, the trainer's rows and the last grid's
    diagnostics."""
    from nerf_emitter_tpu_torch.scripts import method_run

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(tne, "DistillConfig", functools.partial(tne.DistillConfig, batch=1 << 8))
    rec = method_run.main(["--views", "8", "--res", "16", "--out", str(tmp_path), "--", "sdf-nerfacto", "--device",
                           "cpu", "--max-num-iterations", "5", *STEPS])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(rec))
    assert rec["pretrain"]["steps"] == 3 and len(rec["takeover"]["ms_per_step"]) == 2
    assert rec["takeover"]["by_size"]["8"]["steps"] == 2 and len(rec["guiding_build_s"]) == 2
    assert len(rec["distillations"]) == 1 and rec["metrics_finite"] and rec["device"] == "cpu"
    assert [r["step"] for r in rec["rows"]] == [0, 4] and len(rec["save_checkpoint_s"]) == 2
    scene = rec["final_scene"]
    assert scene["grid"] == 64 and len(scene["hit_share_by_camera"]) == 8
