"""Faults planted under the timed path, to show that the comparison that
decides `correct` catches them (the CPU test `test_bench_faults.py`, and
`benchmark/readings.py --fault` on the card, which reads each fault's
numbers for the limits). Each is a context manager that patches the
port while entered and restores it after:

- `unchanged`: the step returns its state unchanged (the optimiser's
  update is dropped);
- `half_batch`: half of the batch is left out and the mean taken over the
  rest (the takeover step's images; the pretraining step's rays);
- `altered`: an answer altered where it is produced (the NeRF's radiance
  scaled by ALTER = 1.25: the emitter closure's, the model forward's);
- `no_backward` (takeover): the emitter's backward returns zeros, its
  forward unchanged (a kernel query whose backward does nothing).
"""

from __future__ import annotations

import contextlib
import dataclasses

ALTER = 1.25  # the altered answer: the NeRF's radiance times this


@contextlib.contextmanager
def patched(owner, attr: str, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def unchanged(kind: str):
    if kind == "pretrain":
        from nerf_emitter_tpu_torch.engine.optimizers import MultiOptimizer

        return patched(MultiOptimizer, "step", lambda real: lambda self: None)
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import SdfTrainStep

    def make(real):
        def apply(self, state, grads, metrics):
            new, m = real(self, state, grads, metrics)
            return dataclasses.replace(new, scene=state.scene, opt_state=state.opt_state), m
        return apply

    return patched(SdfTrainStep, "_apply", make)


def half_batch(kind: str):
    if kind == "pretrain":
        from nerf_emitter_tpu_torch.cameras.rays import RayBundle
        from nerf_emitter_tpu_torch.engine import train_loop

        def make(real):
            def loss(model, config, rays, gt, mask, **kw):
                h = gt.shape[0] // 2
                half = RayBundle(**{f.name: None if getattr(rays, f.name) is None else getattr(rays, f.name)[:h]
                                    for f in dataclasses.fields(RayBundle)})
                return real(model, config, half, gt[:h], mask[:h], **kw)
            return loss

        return patched(train_loop, "nerfacto_loss", make)
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import SdfTrainStep

    def make(real):
        def call(self, state, cameras, cam_indices, gt_images, gt_masks, generator=None, *, draws=None,
                 occ_layers=None):
            h = max(1, gt_images.shape[0] // 2)
            return real(self, state, cameras, cam_indices[:h], gt_images[:h], gt_masks[:h], generator,
                        draws=None if draws is None else draws[:h], occ_layers=occ_layers)
        return call

    return patched(SdfTrainStep, "__call__", make)


def altered(kind: str):
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel

    def make(real):
        def forward(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            return {**out, "rgb": out["rgb"] * ALTER}
        return forward

    if kind == "takeover":
        return _emitter_answer(lambda fn: lambda x, d: fn(x, d) * ALTER)
    return patched(NerfactoModel, "forward", make)


def no_backward(kind: str):
    if kind != "takeover":
        raise ValueError("no_backward is a fault of the takeover's emitter")
    # the same radiance, with no gradient to x and d
    return _emitter_answer(lambda fn: lambda x, d: fn(x, d).detach())


def _emitter_answer(wrap):
    """The NeRF emitter's closure `emitter_fn(x, d)` replaced by
    `wrap(emitter_fn)`."""
    from nerf_emitter_tpu_torch.pipelines import nerf_emitter

    def make_fn_of(real):
        def emitter_fn_of(*args, **kwargs):
            fn_of = real(*args, **kwargs)
            return lambda *a, **k: wrap(fn_of(*a, **k))
        return emitter_fn_of

    return patched(nerf_emitter, "make_nerf_emitter_fn", make_fn_of)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "no_backward": no_backward}
