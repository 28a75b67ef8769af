"""Traffic of kind `pretrain`: the NeRF pretraining of sdf-nerfacto, driven
through `NerfEmitterPipeline.nerf_iteration` (never `train_iteration`, so
no window reaches the takeover).

Set-up: the traffic's views from the seed, the NeRF with the seed's
weights, the pipeline, then `warmup_steps` steps on a generator seeded
from the run's seed; the first `check_steps` of them are the steps the
reference follows, on a generator with the same seed. Window: steps until
`--seconds` have passed, then a synchronise; `pretrain_step_ms` is the
window's host-clock seconds over its steps. The traced window runs
`trace_steps` steps under the profiler with the port's tracing on.
"""

from __future__ import annotations

import time

import torch

from .. import compare, program, roofline
from ..reference.cameras.cameras import Cameras
from ..reference.pipeline import NerfTrainConfig, build_nerf_optimizer, nerf_train_step, tf32_off
from ..trace import profiled, read_period
from .common import cuda_sync, derive, ref_model, views, weight_shapes


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic
        self.dev = run.device
        self.losses = []
        t = self.cfg["train"]
        self.train = NerfTrainConfig(num_rays_per_batch=t["num_rays_per_batch"], rgb_loss=t["rgb_loss"],
                                     rgb_loss_second=t["rgb_loss_second"], anneal_steps=t["anneal_steps"],
                                     max_steps=t["max_steps"], lr_fields=t["lr_fields"],
                                     lr_proposal=t["lr_proposal"], step_pretrain=t["step_pretrain"])

    def inputs_from_seed(self) -> None:
        run = self.run
        self.inputs = views(self.tr, run.seed, self.dev, self.cfg["data"]["scene_scale"], masks=False)
        self.weights = run.make_weights(weight_shapes(self.cfg, self.tr["views"]))
        self.gen_seed = derive(run.seed, "pretrain")

    def setup(self) -> None:
        self.inputs_from_seed()
        model = program.build_model(self.cfg, self.tr["views"], self.weights, self.dev)
        ds = program.build_dataset(self.inputs["cams"], self.inputs["images"])
        self.pipe = pipe = program.build_pipeline(self.cfg, model, ds)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.gen_seed)
        names = {id(p): k for k, p in model.named_parameters()}
        snaps = {"losses": [], "before": {k: v.clone() for k, v in self.weights.items()}}
        for i in range(self.tr["warmup_steps"]):
            m = pipe.nerf_iteration(self.gen)
            if i < self.tr["check_steps"]:
                snaps["losses"].append(m["loss"].detach().clone())
                if i == 0:
                    snaps["grads"] = self._first_grads(pipe.nerf_tx, names)
                snaps["after"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        self.program_snaps = snaps
        cuda_sync(self.dev)

    @staticmethod
    def _first_grads(optimizer, names: dict) -> dict:
        """The gradient each parameter's Adam got in its first step, from its
        first moment ((1 - beta1) g)."""
        out = {}
        for grp in optimizer.groups.values():
            b1 = grp.adam.param_groups[0]["betas"][0]
            for p in grp.params:
                st = grp.adam.state.get(p)
                out[names[id(p)]] = (st["exp_avg"].detach() / (1.0 - b1)) if st else torch.zeros_like(p)
        return out

    def window(self, seconds: float) -> dict:
        self.losses = []
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.losses.append(self.pipe.nerf_iteration(self.gen)["loss"])
            steps += 1
        cuda_sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.run.log(f"window: {steps} steps in {elapsed:.3f} s")
        return {"pretrain_step_ms": elapsed / steps * 1e3}

    def trace_window(self, port: bool = True) -> dict:
        """`trace_steps` steps under the profiler, the port's tracing on
        (`port`); the reading with the steps' MLP FLOPs (forward once,
        backward twice) and the encoding's work (each step's forward reads
        and its backward writes the tables once)."""
        cuda = torch.device(self.dev).type == "cuda"
        self.losses = []
        steps = self.tr["trace_steps"]
        with profiled(cuda, port) as p:
            for _ in range(steps):
                self.losses.append(self.pipe.nerf_iteration(self.gen)["loss"])
        t = read_period(p)
        rays = steps * self.cfg["train"]["num_rays_per_batch"]
        work = roofline.encoding_work(self.cfg)
        t.update(kind="pretrain", steps=steps, flops=3 * rays * roofline.ray_flops(self.cfg),
                 encoding_lookups=rays * work["lookups"],
                 encoding_bytes=rays * work["bytes"] + steps * 2 * work["table_bytes"])
        return t

    def attempted(self) -> int:
        return len(self.losses)

    def failed(self) -> int:
        return int(sum(int(not torch.isfinite(x)) for x in self.losses))

    def release(self) -> None:
        del self.pipe
        self.losses = [float(x) for x in self.losses]

    def follow(self, precision: str) -> dict:
        """The reference's readings of the same first steps."""
        with tf32_off():
            model = ref_model(self.cfg, self.tr["views"], self.weights, self.dev, precision)
            opt = build_nerf_optimizer(self.train, model)
            names = {id(p): k for k, p in model.named_parameters()}
            g = torch.Generator(device=self.dev).manual_seed(self.gen_seed)
            cams = Cameras(**self.inputs["cams"])
            snaps = {"losses": [], "before": {k: v.clone() for k, v in self.weights.items()}}
            for i in range(self.tr["check_steps"]):
                snaps["losses"].append(nerf_train_step(model, self.train, opt, i, cams, self.inputs["images"], g))
                if i == 0:
                    snaps["grads"] = self._first_grads(opt, names)
            snaps["after"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        return snaps

    def check(self) -> dict:
        return compare.training_numbers(self.program_snaps, self.follow("bf16"))

    def control(self) -> dict:
        return compare.training_numbers(self.follow("fp8"), self.follow("bf16"))
