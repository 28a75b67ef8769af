"""Traffic of kind `takeover_hash`: the takeover of `drivers/takeover.py`,
for a NeRF field whose plain reference encodes by reading a table
(nerfacto's hash grid).

The reference's renderer (`reference/renderer/integrator.py`) asks its
emitter for the surface offset of every pixel, and at some escaped pixels
that offset and its direction are not finite: up to a few hundred of a
call's 131,072 rows at the published sizes. Their hit distance is 0/0:
the reference's `sphere_trace.differentiable_hit_t` moves a denominator in
(-eps, 0) to sign(denom) eps + eps = 0 (the port moves it to -2 eps). On
an H100, over the reference's three steps of one seed, every row whose
hit distance was not finite had such a denominator, and none was a hit.
The `freq` field answers such a row NaN, and the pixel keeps its escaped
answer. The plain hash encoding (`reference/fields/encodings.hash_encode`)
turns a NaN position into a corner index below its table on a dense
level, which the card refuses (a device-side assert in the check). Here, while the
reference renders its own steps (`follow`), its emitter answers a row
whose origin or direction is not finite NaN without asking the NeRF, as
the `freq` field answers it, with no gradient to that row, and every
other row as the reference does. The program's tapped emitter calls are
answered again by the plain reference (`check`), and a row the program
asked with a non-finite origin or direction counts in
`emitter_nonfinite`: the port's encoding would read outside its table
there too. The window, the trace and every other compared number are the
`takeover` driver's."""

from __future__ import annotations

import torch

from . import takeover


def _finite_rows(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=-1) & torch.isfinite(d).all(dim=-1)


class Driver(takeover.Driver):
    _own_render = False  # while the reference renders its own steps

    def follow(self, precision: str, mixture, tap: bool = False) -> dict:
        self._own_render = True
        try:
            return super().follow(precision, mixture, tap)
        finally:
            self._own_render = False

    def _emitter_fn_of(self, precision: str):
        fn_of = super()._emitter_fn_of(precision)
        if not self._own_render:
            return fn_of

        def emitter_fn_of(camera_index=None):
            fn = fn_of(camera_index=camera_index)

            def emitter_fn(x, d):
                keep = _finite_rows(x, d)[:, None]
                out = fn(torch.where(keep, x, 0.5), torch.where(keep, d, 1.0))
                return torch.where(keep, out, float("nan"))

            return emitter_fn

        return emitter_fn_of

    def check(self, emitter_only: bool = False) -> dict:
        out = super().check(emitter_only)
        out["emitter_nonfinite"] += sum(int((~_finite_rows(rec["x"], rec["d"])).sum())
                                        for rec in self.program_snaps["emitter"])
        return out
