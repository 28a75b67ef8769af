"""Trainer: the host's orchestration of a two-phase run (port of
nerf_emitter_tpu/engine/trainer.py).

`setup` parses the data, builds the model and the pipeline; `train` runs
the steps, writing metrics every 10 steps (with rays/s and the ETA),
rendering an eval view every `steps_per_eval_image` steps and saving every
`steps_per_save`; checkpoints are engine/checkpoints.py's. Dataparsers
that plugins register (plugins/registry.py) are picked by name before the
built-in ones.

With `viewer_port` the web viewer (viewer/server.py) serves the live
pipeline; each step polls its pause and stop flags (stop saves a
checkpoint and ends the run), and the pipeline's lock is held around each
step, eval view and save, so the viewer's renders run between them.

In a process group of more than one rank (parallel/mesh.py) the trainer
runs one rank: its device is cuda:<local rank>, the steps and views split
their rays over the ranks, rank 0 alone writes events, rows, eval images
and checkpoints and serves the viewer, and every rank restores.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs.cli import save_config
from ..configs.methods import ExperimentConfig
from ..data.datamanager import ImageDataset, build_dataset
from ..data.dataparsers.instant_ngp import InstantNGPDataparserConfig, parse_instant_ngp
from ..data.dataparsers.nerfstudio import NerfstudioDataparserConfig, parse_nerfstudio
from ..engine.train_loop import eval_image_metrics, load_train_state_tree, train_state_tree
from ..fields.rotater import Rotater
from ..models.nerfacto import NerfactoModel
from ..parallel.mesh import DATA_AXIS, broadcast_flag, is_main_process, make_mesh
from ..pipelines.nerf_emitter import NerfEmitterPipeline
from ..plugins.registry import discover_dataparsers
from ..renderer.optimize import get_opt_config
from ..utils import coords, profiler
from ..utils import writer as writer_mod
from ..utils.device import resolve_device
from .checkpoints import CheckpointManager, template_from_metadata

# what a split that is missing or empty raises while it is parsed and loaded
_NO_SPLIT = (OSError, ValueError, KeyError, IndexError)


class Trainer:
    def __init__(self, config: ExperimentConfig):
        self.config = config
        self.run_dir = config.run_dir
        self.device = resolve_device(config.device)
        # across ranks: this rank's view of the process group (None: one rank)
        mesh = make_mesh(device_type=self.device.type)
        self.mesh = mesh if mesh.world_size > 1 else None
        if self.mesh is not None:
            self.device = self.mesh.device
        self.is_main = is_main_process()
        self.writer = writer_mod.EventWriter(self.run_dir / "logs", enabled=self.is_main)
        self.ckpt = CheckpointManager(self.run_dir / "checkpoints", mesh=self.mesh)
        self.viewer_state = None
        self.viewer_server = None

    def setup(self) -> None:
        cfg = self.config
        d = cfg.datacfg
        plugin_parsers = discover_dataparsers()
        if d.dataparser in plugin_parsers:
            parse_split = plugin_parsers[d.dataparser].setup(d)
            dp_cfg = None

            def parse(_cfg, split):
                return parse_split(split)

        elif d.dataparser == "nerfstudio-data":
            dp_cfg = NerfstudioDataparserConfig(data=d.data, scene_scale=d.scene_scale, aabb_scale=d.aabb_scale,
                                                eval_mode=d.eval_mode, mi_data=d.mi_data,
                                                downscale_factor=d.downscale_factor or None)
            parse = parse_nerfstudio
        elif d.dataparser == "instant-ngp-data":
            dp_cfg = InstantNGPDataparserConfig(data=d.data, scene_scale=d.scene_scale, aabb_scale=d.aabb_scale,
                                                eval_mode=d.eval_mode, mi_data=d.mi_data, test_data=d.test_data,
                                                downscale_factor=d.downscale_factor)
            parse = parse_instant_ngp
        else:
            raise ValueError(f"unknown dataparser {d.dataparser!r}; have instant-ngp-data, nerfstudio-data and "
                             f"the plugins' {sorted(plugin_parsers)}")
        train_out = parse(dp_cfg, "train")
        self.dataset = build_dataset(train_out, device=self.device)
        try:
            eval_out = parse(dp_cfg, "val")
            self.eval_dataset: Optional[ImageDataset] = (
                build_dataset(eval_out, device=self.device) if eval_out.image_filenames else None)
        except _NO_SPLIT:
            self.eval_dataset = None
        # the mi_train split: the takeover's full images, from mi_data
        self.mi_dataset: Optional[ImageDataset] = None
        if d.mi_data is not None:
            try:
                self.mi_dataset = build_dataset(parse(dp_cfg, "mi_train"), device=self.device)
            except _NO_SPLIT as e:
                print(f"mi_train split unavailable ({e}); using train split")

        s = d.aabb_scale
        m = cfg.model
        torch.manual_seed(cfg.seed)  # the model's initial weights come from the run's seed
        self.model = NerfactoModel(
            ((-s, -s, -s), (s, s, s)), hdr=m.hdr, num_nerf_samples=m.num_nerf_samples,
            num_proposal_samples=tuple(m.num_proposal_samples), log2_hashmap_size=m.log2_hashmap_size,
            max_res=m.max_res, num_cameras=max(len(self.dataset.cameras), 1),
            appearance_embedding_dim=m.appearance_embedding_dim, background_color=m.background_color,
            use_fake_contraction=m.use_fake_contraction, implementation=m.implementation,
            optimize_camera_poses=m.optimize_camera_poses, device=self.device)
        pipe_cfg = cfg.pipeline
        # a box the dataset declares (a generator knows the object's extent)
        # overrides the config's: a carve-out smaller than the object breaks
        # the TSDF init and leaves the object's density in the emitter
        ds_box = train_out.metadata.get("object_aabb")
        if ds_box is not None:
            pipe_cfg = dataclasses.replace(pipe_cfg, object_aabb=tuple(map(tuple, np.asarray(ds_box).tolist())))
            print(f"object_aabb from dataset: {np.asarray(ds_box).tolist()}")
        # turntable captures: the Rotater from the dataparser's rotation tags
        self.rotater = None
        rot_ids = train_out.rotation_ids
        if rot_ids is not None and len(np.unique(np.asarray(rot_ids))) > 1:
            md = train_out.metadata
            center = torch.as_tensor(np.mean(np.asarray(pipe_cfg.object_aabb, np.float32), axis=0),
                                     device=self.device)
            if md.get("rotation_transform_matrices") is not None:
                self.rotater = Rotater.from_matrices(
                    torch.as_tensor(np.asarray(md["rotation_transform_matrices"], np.float32), device=self.device),
                    center)
            else:
                self.rotater = Rotater.from_angles(md["rotation_angles"], center)
            print(f"turntable: {len(np.unique(np.asarray(rot_ids)))} rotations, "
                  f"angles={list(np.asarray(md.get('rotation_angles', [])))}")
        train_cfg = cfg.train
        if self.mesh is not None:
            train_cfg = dataclasses.replace(train_cfg, data_axis=DATA_AXIS)
            if self.is_main:
                print(f"mesh: {self.mesh.world_size} ranks on axis '{DATA_AXIS}' ({self.mesh.backend})", flush=True)
        self.pipeline = NerfEmitterPipeline(pipe_cfg, self.model, train_cfg, get_opt_config(cfg.opt_config_name),
                                            self.dataset, mi_dataset=self.mi_dataset, rotater=self.rotater,
                                            mesh=self.mesh, data_axis=None if self.mesh is None else DATA_AXIS)
        self.pipeline.data_dir = d.data  # where env.exr is looked for
        if cfg.viewer_port and self.is_main:
            from ..viewer.server import ViewerState, make_orbit_render_fn, start_viewer

            self.viewer_state = ViewerState(make_orbit_render_fn(self.pipeline, self.dataset),
                                            save_dir=self.run_dir, scene_fn=self._viewer_scene_info)
            self.viewer_server = start_viewer(self.viewer_state, cfg.viewer_port)

    def _viewer_scene_info(self) -> dict:
        """The viewer's scene tree (/scene): the training cameras, the
        object AABB and, once the takeover fits them, the guiding mixture's
        light clusters in world space. Read under the pipeline's lock (the
        copies to the host are CUDA calls, which must not meet a step's
        graph capture)."""
        pipe = self.pipeline
        with pipe.lock:
            sdf_state = pipe.sdf_state
            info: dict = {"phase": "sdf" if sdf_state is not None else "nerf",
                          "cameras": self.dataset.cameras.camera_to_worlds[:, :3, :4].cpu().tolist(),
                          "aabb": pipe.object_aabb.cpu().tolist()}
            if sdf_state is not None and sdf_state.scene.guiding is not None:
                g = sdf_state.scene.guiding
                pos = coords.unit_to_world(g.positions.detach().cpu(), self.config.datacfg.scene_scale)
                info["lights"] = {"positions": pos.tolist(), "weights": g.weights.detach().cpu().tolist()}
        return info

    def _stop_requested(self) -> bool:
        """Poll the viewer: wait while it pauses the run (the lock is free
        meanwhile, so it renders); whether it asked to stop, on every rank."""
        vs = self.viewer_state
        if vs is not None:
            while vs.paused and not vs.stop_requested:
                time.sleep(0.25)
        stop = vs is not None and vs.stop_requested
        return broadcast_flag(stop, self.mesh) if self.config.viewer_port else stop

    def close_viewer(self) -> None:
        if self.viewer_server is not None:
            self.viewer_server.shutdown()
            self.viewer_server.server_close()
            self.viewer_server = None

    def train(self, start_step: int = 0) -> None:
        """The train loop; start_step > 0 resumes mid-schedule. The port's
        tracing (utils/profiler) is on while it runs: its summary is
        printed at exit."""
        was_on = profiler.enabled()
        profiler.enable()
        try:
            self._train(start_step)
        finally:
            profiler.enable(was_on)

    def _train(self, start_step: int) -> None:
        cfg = self.config
        # written only by train: the eval and render tools build a Trainer
        # from a loaded config and must not overwrite the run's
        if self.is_main:
            save_config(cfg, self.run_dir / "config.json")
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        t_start = time.time()
        n_rays = cfg.train.num_rays_per_batch
        lock = self.pipeline.lock
        vs = self.viewer_state
        for step in range(start_step, cfg.max_num_iterations):
            if self._stop_requested():
                if self.is_main:
                    print(f"viewer: stop requested at step {step}", flush=True)
                latest = self.ckpt.latest_step()
                if latest is None or step > latest:
                    self.save_checkpoint(step)
                elif self.is_main:
                    print(f"viewer stop: step {step} is not past the latest checkpoint ({latest}); not saved")
                self.writer.close()
                return
            with lock:
                with profiler.time_block("train_iteration"):
                    metrics = self.pipeline.train_iteration(step, generator)
                if step % 10 == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t_start) / (step - start_step + 1)
                    m[writer_mod.TRAIN_RAYS_PER_SEC] = n_rays / max(dt, 1e-9)
                    m[writer_mod.ETA] = dt * (cfg.max_num_iterations - step)
                    self.writer.put_dict(m, step)
                    self.writer.maybe_print(step, m)
                    self.writer.flush(step)
                    if self.mesh is not None and not self.is_main:
                        print(f"rank {self.mesh.rank} step {step} loss {m['loss']!r}", flush=True)
                    if vs is not None:
                        vs.put_metrics(step, m)
            if vs is not None:
                vs.step = step
                vs.phase = "sdf" if self.pipeline.sdf_state is not None else "nerf"
            if step > 0 and step % cfg.steps_per_eval_image == 0:
                self.eval_step(step)
            # not at start_step: a resumed run's first step can be the
            # restored checkpoint's own
            if step > 0 and step != start_step and step % cfg.steps_per_save == 0:
                self.save_checkpoint(step)
        self.save_checkpoint(cfg.max_num_iterations)
        self.writer.close()

    def eval_step(self, step: int) -> None:
        """One eval view: the NeRF's render before the takeover, the SDF
        scene's lit by the NeRF after it. Every rank renders its rows; rank 0
        writes."""
        ds = self.eval_dataset or self.dataset
        idx = step // self.config.steps_per_eval_image % ds.images.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(step)
        with self.pipeline.lock:
            out = self.pipeline.render_camera_outputs(ds, int(idx), gen, spp=16)
            if not self.is_main:
                return
            m = eval_image_metrics(out["rgb"], ds.images[idx], is_hdr=ds.is_hdr)
        self.writer.put_dict({f"eval/{k}": v for k, v in m.items()}, step)
        self.writer.put_image("eval/rgb", out["rgb"], step)
        if self.pipeline.sdf_state is not None:
            self.writer.put_image("eval/mask", out["accumulation"].repeat(1, 1, 3), step)

    def _nerf_tree(self) -> dict:
        p = self.pipeline
        return train_state_tree(p.nerf_state, p.model, p.nerf_tx)

    def save_checkpoint(self, step: int) -> None:
        """Rank 0 writes `step`; every rank waits for the write."""
        with self.pipeline.lock:
            state = {"nerf": self._nerf_tree()}
            if self.pipeline.sdf_state is not None:
                state["sdf"] = self.pipeline.sdf_state
            self.ckpt.save(step, state)

    def _set_nerf(self, tree: dict) -> None:
        p = self.pipeline
        p.nerf_state = load_train_state_tree(tree, p.model, p.nerf_tx)

    def load_checkpoint(self, step: Optional[int] = None, nerf_only: bool = False, bind: bool = True) -> None:
        """Restore `step` (default: the latest). The stored shapes are read
        first, so the SDF template is built at the stored grid resolution
        (the upsample schedule grows it), with none of the takeover's work;
        resume_takeover_bind then binds the emitter to the restored NeRF
        and replays the schedule (skipped with bind=False). nerf_only: the
        NeRF alone, any SDF state discarded. An SDF optimizer state of
        another structure than the current recipe's is read, discarded and
        started afresh; an SDF state that fits no template leaves the
        restore NeRF-only."""
        step = step if step is not None else self.ckpt.latest_step()
        meta = self.ckpt.metadata_tree(step)
        has_sdf_meta = meta is not None and "sdf" in meta
        pipe = self.pipeline
        if nerf_only:
            template = {"nerf": self._nerf_tree()}
            if has_sdf_meta:
                template["sdf"] = template_from_metadata(meta["sdf"])
            self._set_nerf(self.ckpt.restore(template, step)["nerf"])
            pipe.sdf_state = None
            return
        if has_sdf_meta and pipe.sdf_state is None:
            pipe.begin_takeover_template(sdf_res=int(meta["sdf"]["scene"]["sdf"].shape[0]))
        elif meta is not None and not has_sdf_meta:
            pipe.sdf_state = None
        template = {"nerf": self._nerf_tree()}
        if pipe.sdf_state is not None:
            template["sdf"] = pipe.sdf_state
        try:
            restored = self.ckpt.restore(template, step)
        except ValueError:
            if "sdf" not in template:
                raise
            restored = None
            try:
                drifted = dict(template, sdf=template["sdf"].replace(
                    opt_state=template_from_metadata(meta["sdf"]["opt_state"])))
                restored = self.ckpt.restore(drifted, step)
                restored["sdf"] = restored["sdf"].replace(opt_state=pipe.sdf_tx.init(restored["sdf"].scene))
                print("checkpoint SDF optimizer structure drifted from the current config; optimizer moments "
                      "re-initialized")
            except ValueError:
                restored = None
            if restored is None:
                # the SDF state fits no current template: NeRF only
                pipe.sdf_state = None
                template = {"nerf": template["nerf"], "sdf": template_from_metadata(meta["sdf"])}
                restored = self.ckpt.restore(template, step)
                restored.pop("sdf")
                print("warning: checkpointed SDF state could not be restored under the current config; "
                      "resuming NeRF-only")
        self._set_nerf(restored["nerf"])
        if "sdf" in restored:
            pipe.sdf_state = restored["sdf"]
        if pipe.sdf_state is not None and bind:
            pipe.resume_takeover_bind(torch.Generator(device=self.device).manual_seed(0))
