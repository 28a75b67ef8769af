"""Traffic of kind `takeover`: the SDF takeover of sdf-nerfacto, driven
through `NerfEmitterPipeline.takeover_iteration`.

Set-up: the traffic's views (targets and masks, from the seed), the NeRF
with the seed's weights, `begin_takeover` (the sphere start, the guiding
build, the emitter's bind: the NeRF's query, K5 on the card), the step counter
at `start_step`, then the steps up to `window_step`: the render size
doubles and the volume upsamples at the first of them, and the march's
CUDA graphs are captured. The first `check_steps` of them are the steps
the reference follows; in the second of them every emitter call's rays,
radiance and gradients are kept (`EmitterTap`), for the reference's query
to answer again. Each step's cameras (`batch_size` distinct views)
and random numbers (`ImageDraws`) come from the seed and are handed to the
program, in set-up and in the window alike.

Window: whole guiding periods from `window_step`; each period starts at a
rebuild, and at its start the step counter is set back to `window_step`,
so that no window reaches another schedule event. `takeover_step_ms` is
the window's host-clock seconds (ending in a synchronise) over its steps,
the rebuilds and `post_step_host` included. The traced window is one
period under the profiler with the port's tracing on.
"""

from __future__ import annotations

import contextlib
import time
import types

import torch

from .. import compare, program, roofline
from ..reference.pipeline import Takeover as RefTakeover, TakeoverSettings, make_emitter_fn_of, tf32_off
from ..reference.pipelines import sdf_optimizer as ref_sdf
from ..reference.renderer.emitters import VMFMixture as RefMixture
from ..reference.renderer.optimize import get_opt_config as ref_opt_config
from ..reference.renderer.scene import DIFFUSE
from ..trace import Spans, profiled, read_period
from .common import cuda_sync, derive, ref_guiding, ref_model, views, weight_shapes

B1 = 0.9  # Adam's first-moment decay: a fresh moment after one step is (1 - B1) g
TAP_STEP = 1  # the followed step whose emitter calls are kept: the first on the upsampled volume


def _mu(state):
    """The first moment in one variable's optimiser state (Adam's, or the
    chained Sobolev + uniform Adam's)."""
    if isinstance(state, dict) and "mu" in state:
        return state["mu"]
    for s in state:
        if isinstance(s, (dict, tuple)) and (m := _mu(s)) is not None:
            return m
    return None


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic
        self.dev = run.device
        p = self.cfg["pipeline"]
        if p["distill_emitter"]:
            raise ValueError("the takeover driver lights the takeover by the NeRF's own query: "
                             "the configuration's distill_emitter must be false")
        self.settings = TakeoverSettings(
            object_aabb=tuple(map(tuple, p["object_aabb"])), scene_scale=p["scene_scale"],
            batch_size=p["batch_size"], spp=p["spp"], spp_attached=p["spp_attached"],
            takeover_image_size=p["takeover_image_size"], mi_opt_steps=p["mi_opt_steps"])
        self.opt_cfg = ref_opt_config(p["opt_config_name"])
        self.fed = 0
        self.losses = []

    # ---- the feed

    def render_size(self, step: int) -> int:
        """The pipeline's render size at `step`: the takeover's size, doubled
        at each render upsample step it has passed since `start_step`."""
        size = self.settings.takeover_image_size
        for it in self.opt_cfg.render_upsample_iter:
            if self.tr["start_step"] <= it <= step:
                size = min(size * 2, self.tr["image_size"])
        return size

    def feed(self, step: int):
        """The next step's cameras and draws, from the seed."""
        g = torch.Generator(device=self.dev).manual_seed(derive(self.run.seed, f"feed:{self.fed}"))
        self.fed += 1
        s, size = self.settings, self.render_size(step)
        cam_idx = torch.randperm(self.tr["views"], generator=g, device=self.dev)[:s.batch_size]
        t = ref_sdf.TakeoverConfig(spp=s.spp, spp_per_batch=min(ref_sdf.TakeoverConfig.spp_per_batch, s.spp),
                                   spp_attached=min(s.spp_attached, s.spp), image_height=size, image_width=size)
        layout = ref_sdf.SdfTrainStep(self.opt_cfg, t, tx=None)
        stub = types.SimpleNamespace(sdf=torch.empty(0, device=self.dev), bsdf_type=DIFFUSE, guiding=True,
                                     envmap=None)
        return cam_idx, layout.draw(stub, s.batch_size, g)

    # ---- set-up

    def inputs_from_seed(self) -> None:
        """The views, the weights, the takeover's generator seed and the
        followed steps' feeds."""
        run, tr = self.run, self.tr
        self.fed = 0
        self.inputs = views(tr, run.seed, self.dev, self.cfg["data"]["scene_scale"], masks=True)
        self.weights = run.make_weights(weight_shapes(self.cfg, tr["views"]))
        self.gen_seed = derive(run.seed, "takeover")
        self.check_feeds = [self.feed(tr["start_step"] + i) for i in range(tr["check_steps"])]

    def setup(self) -> None:
        from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import SdfTrainStep

        cfg, tr = self.cfg, self.tr
        self.inputs_from_seed()
        model = program.build_model(cfg, tr["views"], self.weights, self.dev)
        ds = program.build_dataset(self.inputs["cams"], self.inputs["images"], self.inputs["masks"])
        self.pipe = pipe = program.build_pipeline(cfg, model, ds)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.gen_seed)
        pipe.begin_takeover(self.gen)
        gd = pipe.sdf_state.scene.guiding
        self.mixture = tuple(x.detach().clone() for x in (gd.positions, gd.weights, gd.stds))
        program.replace_step(pipe, tr["start_step"])
        snaps = {"losses": []}
        for i, step in enumerate(range(tr["start_step"], tr["window_step"])):
            cam_idx, draws = self.check_feeds[i] if i < tr["check_steps"] else self.feed(step)
            with EmitterTap(SdfTrainStep, snaps) if i == TAP_STEP else contextlib.nullcontext():
                m = pipe.takeover_iteration(self.gen, cam_idx=cam_idx, draws=draws)
            if i < tr["check_steps"]:
                self._snapshot(snaps, i, pipe.sdf_state, m)
        self.program_snaps = snaps
        cuda_sync(self.dev)

    @staticmethod
    def _snapshot(snaps: dict, i: int, state, metrics) -> None:
        """The followed steps' readings: each loss; the volumes after the
        first step (after its upsample) and after the last; the gradient
        the optimiser got in the second step (the first after the
        upsample's fresh optimiser state), from its first moment."""
        snaps["losses"].append(metrics["loss"].detach().clone())
        vol = {k: getattr(state.scene, k).detach().clone() for k in ("sdf", "albedo", "roughness")}
        if i == 0:
            snaps["before"] = vol
        if i == 1:
            snaps["grads"] = {k: _mu(state.opt_state[k]) / (1.0 - B1) for k in ("sdf", "albedo", "roughness")}
        snaps["after"] = vol

    # ---- the window

    def _period(self, on_step=None) -> int:
        pipe, tr = self.pipe, self.tr
        program.replace_step(pipe, tr["window_step"])
        for step in range(tr["window_step"], tr["window_step"] + tr["period"]):
            cam_idx, draws = self.feed(step)
            m = pipe.takeover_iteration(self.gen, cam_idx=cam_idx, draws=draws)
            self.losses.append(m["loss"])
            if on_step is not None:
                on_step()
        return tr["period"]

    def window(self, seconds: float) -> dict:
        """Whole periods, as many as end nearest to `seconds` (another period
        starts while half of one more would still end inside them)."""
        self.losses = []
        steps, t0, ends = 0, time.perf_counter(), []
        while True:
            steps += self._period()
            ends.append(time.perf_counter() - t0)
            if ends[-1] + 0.5 * ends[-1] / len(ends) >= seconds:
                break
        cuda_sync(self.dev)
        elapsed = time.perf_counter() - t0
        periods = [round(b - a, 3) for a, b in zip([0.0] + ends[:-1], ends)]
        self.run.log(f"window: {steps} steps in {elapsed:.3f} s; periods (host clock, enqueued) {periods}")
        return {"takeover_step_ms": elapsed / steps * 1e3}

    def trace_window(self, port: bool = True) -> dict:
        """One guiding period under the profiler, the port's tracing on
        (`port`), with spans around the guiding build, the SDF step,
        post_step_host and every emitter call; the reading with the MLP
        FLOPs of the rays asked of the NeRF and their encoding's work (the
        frozen tables read once in the period)."""
        import nerf_emitter_tpu_torch.pipelines.nerf_emitter as ne

        pipe, cuda = self.pipe, torch.device(self.dev).type == "cuda"
        self.losses = []
        with Spans(cuda) as spans:
            def count_emitter(args, kwargs):
                x, d = args[0], args[1]
                if torch._C._current_graph_task_id() != -1:
                    return {"recompute_rays": x.shape[0]}
                if torch.is_grad_enabled() and (x.requires_grad or d.requires_grad):
                    return {"grad_rays": x.shape[0]}
                return {"rays": x.shape[0]}

            step_fn = pipe.sdf_step_fn
            spans.wrap(step_fn, "emitter_for_camera", "emitter_bind",
                       wrap_result=lambda fn: spans.wrapped(fn, "emitter", count=count_emitter))
            spans.wrap(pipe, "sdf_step_fn", "sdf_step")
            spans.wrap(pipe, "build_emitter_proposal", "guiding")
            spans.wrap(pipe.model, "point_lights", "probes",
                       count=lambda a, k: {"rays": a[0].origins.shape[0]})
            spans.wrap(ne, "post_step_host", "post_step_host")
            before = program.kernel_launches()
            with profiled(cuda, port) as p:
                steps = self._period()
            launches = {k: n - before.get(k, 0) for k, n in program.kernel_launches().items() if n != before.get(k, 0)}
            guiding_s, step_s = spans.seconds("guiding"), spans.seconds("sdf_step")
            counts = {k: dict(v) for k, v in spans.counts.items()}
        t = read_period(p, [lambda n: n == "bench::emitter" or "_MegaQueryBackward" in n])
        f = roofline.ray_flops(self.cfg)
        em = counts.get("emitter", {})
        fwd, grad = em.get("rays", 0) + em.get("grad_rays", 0), em.get("grad_rays", 0)
        emitter_flops = fwd * f + grad * 2 * f
        emitter_bytes = (fwd + grad) * roofline.RAY_BYTES
        probes = counts.get("probes", {}).get("rays", 0)
        work = roofline.encoding_work(self.cfg)
        t.update(kind="takeover", steps=steps, flops=emitter_flops + probes * 2 * f,
                 encoding_lookups=(fwd + probes) * work["lookups"],
                 encoding_bytes=(fwd + probes) * work["bytes"] + work["table_bytes"],
                 emitter_bound_s=roofline.bound_s(emitter_flops, emitter_bytes)[0],
                 emitter_bound_by=roofline.bound_s(emitter_flops, emitter_bytes)[1],
                 emitter_device_s=t["linked_s"][0] if t.get("linked_s") else 0.0,
                 guiding_s=guiding_s, sdf_step_s=step_s, counts=counts, launches=launches)
        return t

    def attempted(self) -> int:
        return len(self.losses)

    def failed(self) -> int:
        return int(sum(int(not torch.isfinite(x)) for x in self.losses))

    # ---- the check

    def release(self) -> None:
        del self.pipe
        self.losses = [float(x) for x in self.losses]

    def _emitter_fn_of(self, precision: str):
        model = ref_model(self.cfg, self.tr["views"], self.weights, self.dev, precision)
        return make_emitter_fn_of(model, self.settings.scene_scale, self.settings.object_aabb)

    def follow(self, precision: str, mixture, tap: bool = False) -> dict:
        """The reference's readings of the followed steps, lit by the
        reference's plain query in `precision`, from the mixture given (the
        program's: the reference follows the program's guiding state, and
        the guiding build is held by itself, `guiding_gap`). With `tap`, its
        emitter calls are kept as the program's are (for the control)."""
        from ..reference.cameras.cameras import Cameras

        tr = self.tr
        with tf32_off():
            fn_of = self._emitter_fn_of(precision)
            emitter_for_camera = lambda cam, rot: fn_of(camera_index=cam)  # noqa: E731
            tk = RefTakeover(self.settings, self.opt_cfg, emitter_for_camera, tr["image_size"], self.dev)
            scene = tk.sphere_scene().replace(guiding=RefMixture(*[x.clone() for x in mixture]))
            tk.begin(scene, tr["start_step"])
            cams = Cameras(**self.inputs["cams"])
            snaps = {"losses": []}
            for i, (cam_idx, draws) in enumerate(self.check_feeds):
                with EmitterTap(ref_sdf.SdfTrainStep, snaps) if tap and i == TAP_STEP else contextlib.nullcontext():
                    m = tk.iteration(cams, self.inputs["images"], self.inputs["masks"], cam_idx, draws)
                self._snapshot(snaps, i, tk.state, m)
        return snaps

    def guiding(self, precision: str):
        return ref_guiding(self.cfg, self.settings, self.inputs, self.weights, self.gen_seed, self.dev, precision)

    def numbers(self, program_snaps: dict, program_mixture, reference_snaps: dict, guide) -> dict:
        """The training numbers of the followed steps and the guiding
        build's gap."""
        pts, w, ref_mix = guide
        out = compare.training_numbers(program_snaps, reference_snaps)
        out["guiding_gap"] = abs(compare.mixture_loglik(pts, w, *ref_mix)
                                 - compare.mixture_loglik(pts, w, *program_mixture))
        return out

    def check(self, emitter_only: bool = False) -> dict:
        """The numbers, and the program's tapped emitter calls answered again
        by the reference's query in bf16 (`compare.emitter_numbers`);
        `emitter_only` (for `benchmark.readings`) leaves out the rest."""
        out = {} if emitter_only else self.numbers(self.program_snaps, self.mixture,
                                                   self.follow("bf16", self.mixture), self.guiding("bf16"))
        with tf32_off():
            out.update(compare.emitter_numbers(self.program_snaps["emitter"], self._emitter_fn_of("bf16")))
        return out

    def control(self, emitter_only: bool = False) -> dict:
        """The reference in fp8 in the program's place: it takes the steps
        and builds the guiding, and it answers the emitter calls of the bf16
        reference's step at their rays (the fp8 steps can diverge; the
        emitter's answers are judged at the same rays either way)."""
        # the mixture the fp8 steps follow: their own build's (for the emitter
        # alone, the bf16 reference's)
        mix8 = self.guiding("bf16" if emitter_only else "fp8")[2]
        ref = self.follow("bf16", mix8, tap=True)
        out = {} if emitter_only else self.numbers(self.follow("fp8", mix8), mix8, ref, self.guiding("bf16"))
        with tf32_off():
            answers = compare.emitter_answers(ref["emitter"], self._emitter_fn_of("fp8"))
            out.update(compare.emitter_numbers(answers, self._emitter_fn_of("bf16")))
        return out


class _Tap(torch.autograd.Function):
    """The identity, keeping the gradient that passes it under `key`."""

    @staticmethod
    def forward(ctx, t, record, key):
        ctx.record, ctx.key = record, key
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.record[ctx.key] = g.detach().clone()
        return g, None, None


class EmitterTap:
    """While entered, every emitter call of `step_cls`'s steps (the port's
    SdfTrainStep, or the reference's) is kept in `snaps["emitter"]`: its
    camera, its rays x (unit cube) and d, its radiance, which of x and d
    carry a gradient (`grad`), and then the gradient that reached the
    radiance (`g_out`) and the one the emitter's backward gave those rays
    (`g_x`, `g_d`). Taps sit on the emitter's own inputs and output, so the
    renderer's other uses of x and d do not add to them. A checkpoint's
    recompute of a call, inside the backward, is not kept again."""

    def __init__(self, step_cls, snaps: dict):
        from ..faults import patched

        self.records = snaps.setdefault("emitter", [])

        def make(real):
            def _emitter(step, cam_idx):
                return self._tapped(real(step, cam_idx), cam_idx)
            return _emitter

        self._patch = patched(step_cls, "_emitter", make)

    def _tapped(self, fn, cam_idx):
        def emitter_fn(x, d):
            if torch._C._current_graph_task_id() != -1:  # a checkpoint's recompute, inside the backward
                return fn(x, d)
            grad = torch.is_grad_enabled()
            rec = {"cam": cam_idx, "x": x.detach().clone(), "d": d.detach().clone(),
                   "grad": tuple(k for k, t in (("x", x), ("d", d)) if grad and t.requires_grad)}
            x = _Tap.apply(x, rec, "g_x") if "x" in rec["grad"] else x
            d = _Tap.apply(d, rec, "g_d") if "d" in rec["grad"] else d
            out = fn(x, d)
            rec["out"], rec["out_grad"] = out.detach().clone(), out.requires_grad
            self.records.append(rec)
            return _Tap.apply(out, rec, "g_out") if out.requires_grad else out
        return emitter_fn

    def __enter__(self):
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)
