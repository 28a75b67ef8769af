"""The port's own tracing around a driver's traced period.

`port_tracing()` resets and switches on the port's tracing
(`nerf_emitter_tpu_torch.utils.profiler`) over a block and reads its
counters after it. `trace_window(driver, port)` runs the driver's own
`trace_window` (its profiled period, its `bench::` wrappers and its
reading, unchanged) with the port's tracing on or off, and adds to the
reading what the port recorded, read from the same profile
(`program_trace.read_program_trace`):

- `program_spans`: per port span, host seconds, device seconds launched
  inside it, and device idle seconds while it was open;
- `program_counts`: the port's counters (empty with the port's tracing off);
- `program_idle_gaps`: the longest idle gaps, named by the innermost span of
  either prefix (`nek::` or `bench::`);
- `program_idle_s`: the device's idle seconds in the window, with the
  ranges' mirrors of both prefixes left out of busy time;
- `period_s`: the profiled period's host seconds, ending in a synchronise.
"""

from __future__ import annotations

import contextlib
import sys
import time
import types

import torch

from ..faults import patched
from ..program_trace import read_program_trace


@contextlib.contextmanager
def port_tracing():
    """The port's tracing reset and on over the block; yields a holder
    whose `counts`, the port's counters, are read after the block."""
    from nerf_emitter_tpu_torch.utils import profiler

    profiler.reset()
    profiler.enable()
    holder = types.SimpleNamespace(counts={})
    try:
        yield holder
    finally:
        profiler.disable()
        holder.counts = profiler.counters()
        profiler.reset()


def trace_window(driver, port: bool) -> dict:
    """The driver's traced period and reading, with the port's tracing on
    (`port`) or off, and the port's spans and counters added."""
    mod = sys.modules[type(driver).__module__]
    got = {}

    def make_read(real):
        def read(prof, *args, **kwargs):
            got.update(read_program_trace(prof))
            return real(prof, *args, **kwargs)
        return read

    def make_profiled(real):
        @contextlib.contextmanager
        def profiled(cuda):
            with real(cuda) as holder:
                t0 = time.perf_counter()
                yield holder
                if cuda:
                    torch.cuda.synchronize()
                got["period_s"] = time.perf_counter() - t0
        return profiled

    on = port_tracing() if port else contextlib.nullcontext(types.SimpleNamespace(counts={}))
    with patched(mod, "read_trace", make_read), patched(mod, "profiled", make_profiled), on as holder:
        reading = driver.trace_window()
    reading.update(program_spans=got.get("program_spans", {}), program_idle_gaps=got.get("idle_gaps", []),
                   program_idle_s=got.get("idle_s", 0.0), program_counts=holder.counts,
                   period_s=got.get("period_s"))
    return reading
