"""A driver's traced period and reading with the port's tracing on or off,
by name: `trace_window(driver, port)`. The drivers switch the port's
tracing on over their profiled period themselves (`trace.profiled`); the
port's tests (`tests/test_torch_tracing.py`) reach it through this name."""

from __future__ import annotations


def trace_window(driver, port: bool) -> dict:
    return driver.trace_window(port)
