"""Trainer: the host's orchestration of a two-phase run (port of
nerf_emitter_tpu/engine/trainer.py).

`setup` parses the data, builds the model and the pipeline; `train` runs
the steps, writing metrics every 10 steps (with rays/s and the ETA),
rendering an eval view every `steps_per_eval_image` steps and saving every
`steps_per_save`; checkpoints are engine/checkpoints.py's. Dataparsers
that plugins register (plugins/registry.py) are picked by name before the
built-in ones. The viewer (ROADMAP.md, Queue 1 item 8) and more than one
device (item 7) are not ported and raise.
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
from ..pipelines.nerf_emitter import NerfEmitterPipeline
from ..plugins.registry import discover_dataparsers
from ..renderer.optimize import get_opt_config
from ..utils import profiler
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
        if self.device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                f"{torch.cuda.device_count()} CUDA devices are visible; training across cards is not ported yet "
                "(ROADMAP.md, Queue 1 item 7): make one visible with CUDA_VISIBLE_DEVICES")
        if config.viewer_port:
            raise NotImplementedError("the viewer is not ported yet (ROADMAP.md, Queue 1 item 8)")
        self.writer = writer_mod.EventWriter(self.run_dir / "logs")
        self.ckpt = CheckpointManager(self.run_dir / "checkpoints")

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
        self.pipeline = NerfEmitterPipeline(pipe_cfg, self.model, cfg.train, get_opt_config(cfg.opt_config_name),
                                            self.dataset, mi_dataset=self.mi_dataset, rotater=self.rotater)
        self.pipeline.data_dir = d.data  # where env.exr is looked for

    @profiler.time_function
    def train(self, start_step: int = 0) -> None:
        """The train loop; start_step > 0 resumes mid-schedule."""
        cfg = self.config
        # written only by train: the eval and render tools build a Trainer
        # from a loaded config and must not overwrite the run's
        save_config(cfg, self.run_dir / "config.json")
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        t_start = time.time()
        n_rays = cfg.train.num_rays_per_batch
        for step in range(start_step, cfg.max_num_iterations):
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
        scene's lit by the NeRF after it."""
        ds = self.eval_dataset or self.dataset
        idx = step // self.config.steps_per_eval_image % ds.images.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(step)
        out = self.pipeline.render_camera_outputs(ds, int(idx), gen, spp=16)
        m = eval_image_metrics(out["rgb"], ds.images[idx], is_hdr=ds.is_hdr)
        self.writer.put_dict({f"eval/{k}": v for k, v in m.items()}, step)
        self.writer.put_image("eval/rgb", out["rgb"], step)
        if self.pipeline.sdf_state is not None:
            self.writer.put_image("eval/mask", out["accumulation"].repeat(1, 1, 3), step)

    def _nerf_tree(self) -> dict:
        p = self.pipeline
        return train_state_tree(p.nerf_state, p.model, p.nerf_tx)

    def save_checkpoint(self, step: int) -> None:
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
