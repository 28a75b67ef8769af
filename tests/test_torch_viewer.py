"""The port's web viewer (nerf_emitter_tpu_torch/viewer/server.py) on the
CPU: tests/test_viewer.py's server tests against the port's server, the
keyframe export and the orbit camera against JAX's, the orbit render
against the pipeline's render_camera_outputs, the PNG encoder, and the
viewer beside a training run: pause and stop through /control, and a
render that waits for the step holding the pipeline's lock."""

from __future__ import annotations

import functools
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nerf_emitter_tpu.viewer import server as jserver
from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
from nerf_emitter_tpu_torch.engine.trainer import Trainer
from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne
from nerf_emitter_tpu_torch.scripts import train as train_cli
from nerf_emitter_tpu_torch.scripts.render import _slerp
from nerf_emitter_tpu_torch.utils.video import encode_png, read_png
from nerf_emitter_tpu_torch.viewer import server as tserver
from nerf_emitter_tpu_torch.viewer.server import ViewerState, keyframes_to_camera_path, start_viewer

torch.set_num_threads(1)

KEYFRAMES = {"keyframes": [{"theta": 0.0, "phi": 0.3, "radius": 2.0, "fov": 50},
                           {"theta": 1.0, "phi": -0.2, "radius": 2.5, "target": [0.1, -0.2, 0.3], "fov": 35}],
             "n_frames": 8}


def _fake_render(theta, phi, radius, w, h, target=(0, 0, 0), fov_deg=40.0, spp=4, mode="rgb", light_angle=0.0):
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 if mode == "rgb" else 1.0
    return img


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=60).read()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=60).read()


@pytest.fixture()
def served(tmp_path):
    """serve(**kw) -> (state, base URL) of a port viewer on an ephemeral
    port."""
    servers = []

    def serve(**kw):
        state = ViewerState(_fake_render, save_dir=tmp_path, **kw)
        server = start_viewer(state, port=0)
        servers.append(server)
        return state, f"http://127.0.0.1:{server.server_address[1]}"

    yield serve
    for s in servers:
        s.shutdown()
        s.server_close()


def test_viewer_serves_page_render_and_metrics(served, tmp_path):
    """tests/test_viewer.py's round trip on the port: the page, a PNG in
    each mode, /status, /metrics' losses and the keyframe export."""
    state, base = served()
    state.put_metrics(10, {"loss": 1.5})
    state.put_metrics(20, {"loss": 1.0})
    page = _get(base, "/")
    assert b"viewer" in page and b"keyframe" in page
    for mode in tserver.MODES:
        png = _get(base, f"/render?theta=0&phi=0&w=16&h=16&mode={mode}&spp=2")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert json.loads(_get(base, "/status"))["step"] == 20
    metrics = json.loads(_get(base, "/metrics"))
    assert metrics["losses"] == [[10, 1.5], [20, 1.0]] and metrics["render_ms"] > 0.0
    msg = _post(base, "/save_path", {"keyframes": KEYFRAMES["keyframes"], "n_frames": 8}).decode()
    assert "camera_path.json" in msg and "nerf_emitter_tpu_torch.scripts.render camera-path" in msg
    spec = json.loads((tmp_path / "camera_path.json").read_text())
    assert len(spec["keyframes"]) == 2 and spec["n_frames"] == 8
    assert np.asarray(spec["keyframes"][0]["c2w"]).shape == (3, 4)


def test_viewer_scene_tree_and_training_control(served):
    """tests/test_viewer.py's scene tree and control on the port: /scene
    from scene_fn, pause/resume/stop through /control, 400 on an unknown
    action, the page's scene tree and control UI."""
    c2w = np.eye(4, dtype=np.float32)[:3].tolist()
    scene = {"phase": "sdf", "cameras": [c2w], "aabb": [[-1, -1, -1], [1, 1, 1]],
             "lights": {"positions": [[0, 2, 0]], "weights": [1.0]}}
    state, base = served(scene_fn=lambda: scene)
    state.phase = "sdf"
    got = json.loads(_get(base, "/scene"))
    assert got["phase"] == "sdf" and np.asarray(got["cameras"]).shape == (1, 3, 4)
    assert got["lights"]["positions"] == [[0, 2, 0]]
    assert json.loads(_post(base, "/control", {"action": "pause"})) == {"paused": True, "stop": False}
    m = json.loads(_get(base, "/metrics"))
    assert state.paused is True and m["paused"] is True and m["phase"] == "sdf"
    assert json.loads(_post(base, "/control", {"action": "resume"})) == {"paused": False, "stop": False}
    assert json.loads(_post(base, "/control", {"action": "stop"})) == {"paused": False, "stop": True}
    assert state.stop_requested is True
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/control", {"action": "bogus"})
    assert err.value.code == 400
    page = _get(base, "/")
    for needle in (b"scene", b"pause training", b"camlist", b"showaabb"):
        assert needle in page
    assert page == jserver._PAGE.encode()


def test_keyframes_to_camera_path_matches_jax():
    """The exported path equals JAX's on the same payload (1e-6), looks at
    its target from the orbit, and the render CLI's slerp interpolates it
    through rotations (tests/test_viewer.py's geometry and camera-path
    checks)."""
    got, want = keyframes_to_camera_path(KEYFRAMES), jserver.keyframes_to_camera_path(KEYFRAMES)
    assert got["n_frames"] == want["n_frames"] == 8
    for g, w in zip(got["keyframes"], want["keyframes"], strict=True):
        np.testing.assert_allclose(g["c2w"], w["c2w"], rtol=0, atol=1e-6)
        assert g["fov_deg"] == w["fov_deg"]
    c2w = np.asarray(keyframes_to_camera_path({"keyframes": [{"theta": 0.0, "phi": 0.0, "radius": 2.0}]})
                     ["keyframes"][0]["c2w"])
    np.testing.assert_allclose(np.linalg.norm(c2w[:, 3]), 2.0, rtol=1e-5)
    np.testing.assert_allclose(-c2w[:, 2], -c2w[:, 3] / 2.0, atol=1e-5)
    kf = [np.asarray(k["c2w"], np.float32) for k in got["keyframes"]]
    for t in np.linspace(0.0, 1.0, 5):
        rot = _slerp(kf[0][:, :3], kf[1][:, :3], t)
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(_slerp(kf[0][:, :3], kf[1][:, :3], 1.0), kf[1][:, :3], atol=1e-5)


class _Recorder:
    """A pipeline stand-in that records the cameras it is asked to render."""

    def __init__(self, torch_side: bool):
        self.cams, self.torch_side = [], torch_side
        self.sdf_state = None
        self.device = torch.device("cpu")
        self.lock = threading.Lock()

    def render_camera_outputs(self, ds, cam_index, generator, spp=64, **kw):
        self.cams.append(ds.cameras)
        h, w = ds.cameras.height, ds.cameras.width
        zeros = (lambda *s: torch.zeros(s)) if self.torch_side else (lambda *s: np.zeros(s, np.float32))
        return {"rgb": zeros(h, w, 3), "depth": zeros(h, w, 1), "accumulation": zeros(h, w, 1),
                "normal": zeros(h, w, 3)}


def test_orbit_camera_matches_jax():
    """make_orbit_render_fn's camera for the same viewer parameters (orbit,
    target, field of view, size) equals the JAX viewer's: c2w within 1e-6,
    the intrinsics equal."""
    import jax.numpy as jnp

    params = dict(theta=0.7, phi=-0.3, radius=2.2, w=24, h=16, target=(0.1, 0.0, -0.2), fov_deg=55.0, spp=2)
    jp, tp = _Recorder(False), _Recorder(True)
    jds = type("DS", (), {"images": jnp.zeros((1, 16, 24, 3))})()
    tds = type("DS", (), {"images": torch.zeros((1, 16, 24, 3))})()
    jserver.make_orbit_render_fn(jp, jds)(**params)
    tserver.make_orbit_render_fn(tp, tds)(**params)
    (jc,), (tc,) = jp.cams, tp.cams
    np.testing.assert_allclose(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds), rtol=0, atol=1e-6)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)), rtol=1e-6, err_msg=k)
    assert (tc.width, tc.height) == (jc.width, jc.height) == (24, 16)


def test_encode_png_round_trips_through_read_png(tmp_path):
    """encode_png's bytes decode back to the uint8 image (RGB and grey),
    and write_png writes the same bytes."""
    from nerf_emitter_tpu_torch.utils.video import write_png

    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8), rng.integers(0, 256, size=(4, 3, 1),
                                                                                      dtype=np.uint8)):
        data = encode_png(img)
        (tmp_path / "a.png").write_bytes(data)
        np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
        assert write_png(tmp_path / "b.png", img).read_bytes() == data
    f = rng.uniform(-0.5, 1.5, size=(3, 3, 3)).astype(np.float32)
    (tmp_path / "f.png").write_bytes(encode_png(f))
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), (np.clip(f, 0, 1) * 255).astype(np.uint8))


# ---- the viewer beside a run of the train CLI

STEPS = ["--pipeline.takeover-step", "3", "--train.num-rays-per-batch", "64", "--model.num-proposal-samples",
         "[16, 8]", "--model.num-nerf-samples", "8", "--pipeline.distill-steps", "2", "--pipeline.spp", "2",
         "--pipeline.batch-size", "2", "--pipeline.takeover-image-size", "8", "--pipeline.tsdf-init-res", "16",
         "--steps-per-eval-image", "1000", "--steps-per-save", "1000"]


@pytest.fixture()
def live_run(tmp_path, monkeypatch):
    """sdf-nerfacto through the train CLI with --viewer-port, in a thread,
    on 8 synthetic views of 16^2 on the CPU (TensorBoard left out, the
    distillation at 2^8 queries a step). Yields (base URL, trainer box,
    thread); the trainer is box["live"] from its setup on, box["trainer"]
    once main returns. The run is stopped through /control if a test
    leaves it running."""
    data = make_synthetic_dataset(tmp_path / "scene", n_views=8, width=16, height=16)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(tne, "DistillConfig", functools.partial(tne.DistillConfig, batch=1 << 8))
    port = train_cli.free_port()
    box = {}
    real_setup = Trainer.setup

    def setup(self):
        box["live"] = self
        real_setup(self)

    monkeypatch.setattr(Trainer, "setup", setup)

    def run():
        box["trainer"] = train_cli.main(
            ["sdf-nerfacto", "--datacfg.data", str(data), "--output-dir", str(tmp_path / "out"), "--experiment-name",
             "live", "--device", "cpu", "--max-num-iterations", "400", "--viewer-port", str(port), *STEPS])

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60
    while True:
        try:
            _get(base, "/metrics")
            break
        except OSError:
            assert time.time() < deadline and thread.is_alive(), "the viewer did not come up"
            time.sleep(0.1)
    yield base, box, thread
    if thread.is_alive():
        _post(base, "/control", {"action": "stop"})
        thread.join(60)
    if "trainer" in box:
        box["trainer"].close_viewer()


def _wait_step(base, cond, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        m = json.loads(_get(base, "/metrics"))
        if cond(m):
            return m
        time.sleep(0.05)
    raise AssertionError(f"the run did not reach the condition: {m}")


def test_trainer_pauses_and_stops_with_a_checkpoint(live_run):
    """Through /control: pause holds the step (with the takeover's light
    clusters in /scene meanwhile), resume goes on, stop saves a checkpoint
    at the step it stopped at and ends the run long before its 400 steps;
    renders in all four modes are served while paused."""
    base, box, thread = live_run
    _wait_step(base, lambda m: m["phase"] == "sdf" and m["step"] >= 4)
    _post(base, "/control", {"action": "pause"})
    held, deadline = None, time.time() + 60
    while True:  # the step in flight ends, then none follows
        step = json.loads(_get(base, "/metrics"))["step"]
        if step == held:
            break
        assert time.time() < deadline
        held = step
        time.sleep(1.0)
    scene = json.loads(_get(base, "/scene"))
    assert scene["phase"] == "sdf" and len(scene["lights"]["positions"]) == len(scene["lights"]["weights"]) > 0
    assert np.asarray(scene["cameras"]).shape == (8, 3, 4) and np.asarray(scene["aabb"]).shape == (2, 3)
    for mode in tserver.MODES:
        assert _get(base, f"/render?w=8&h=8&spp=1&mode={mode}")[:4] == b"\x89PNG"
    _post(base, "/control", {"action": "resume"})
    _wait_step(base, lambda m: m["step"] > held)
    _post(base, "/control", {"action": "stop"})
    thread.join(60)
    assert not thread.is_alive()
    trainer = box["trainer"]
    stopped = trainer.ckpt.latest_step()
    assert stopped is not None and held < stopped < 400 and trainer.ckpt.steps() == [stopped]
    assert trainer.pipeline.sdf_state.step == stopped - 3


def test_render_waits_for_the_step_holding_the_lock(live_run):
    """A /render from the server's thread while the pipeline's lock is
    held (as the trainer holds it around each step) waits for it: it has
    not answered after 0.5 s, answers once the lock is released, and
    /metrics reports a lock wait of at least 0.4 s."""
    base, box, thread = live_run
    _wait_step(base, lambda m: m["step"] >= 1)
    lock = box["live"].pipeline.lock
    answer = {}
    with lock:
        t = threading.Thread(target=lambda: answer.setdefault("png", _get(base, "/render?w=8&h=8&spp=1")))
        t.start()
        time.sleep(0.5)
        assert "png" not in answer
    t.join(60)
    assert answer["png"][:4] == b"\x89PNG"
    # the request reaches the lock a few ms after the hold starts
    assert json.loads(_get(base, "/metrics"))["lock_wait_ms"] >= 400.0


def test_orbit_render_equals_render_camera_outputs(monkeypatch):
    """The orbit render function on a tiny CPU pipeline after its takeover
    returns render_camera_outputs' rgb of the same camera from a generator
    seeded 0 (bit for bit), its depth mode the normalised depth."""
    from test_torch_hash import hash_pair
    from test_torch_parallel import two_phase

    from nerf_emitter_tpu_torch.data.datamanager import ImageDataset

    monkeypatch.setattr(tne, "DistillConfig", functools.partial(tne.DistillConfig, batch=1 << 8))
    pipe = two_phase(None, {"hash": hash_pair()[2].state_dict()})[0]
    assert pipe.sdf_state is not None
    render = tserver.make_orbit_render_fn(pipe, pipe.dataset)
    args = dict(theta=0.4, phi=0.3, radius=1.2, w=12, h=12, fov_deg=45.0, spp=2)
    got = render(**args)
    cams = tserver.orbit_cameras(0.4, 0.3, 1.2, 12, 12, fov_deg=45.0)
    ds = ImageDataset(cameras=cams, images=pipe.dataset.images[:1])
    want = pipe.render_camera_outputs(ds, 0, torch.Generator().manual_seed(0), spp=2)
    np.testing.assert_array_equal(got, want["rgb"].numpy())
    depth = render(**args, mode="depth")
    assert depth.shape == (12, 12, 3) and 0.0 <= depth.min() and depth.max() <= 1.0
    assert render.lock_wait_ms is not None and not pipe.lock.locked()
    lit = render(**args, light_angle=0.5)
    assert lit.shape == (12, 12, 3) and np.isfinite(lit).all()
