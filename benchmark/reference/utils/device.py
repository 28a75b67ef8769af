"""Device selection for the port's entry points, and id columns on a device.

Entry points run on the card unless the caller asks for the CPU: `None`
means CUDA, and a missing CUDA device is an error, never a quiet fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> cuda. Raises RuntimeError when CUDA is asked for (explicitly
    or by default) and torch sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def id_column(value, shape, device) -> torch.Tensor:
    """A long tensor of `shape` holding `value`, an int or a tensor (for
    example a device-side draw). An int is filled in on the device: a
    host-to-device copy of it would synchronise the stream on every call."""
    if isinstance(value, torch.Tensor):
        return value.to(device).long().expand(shape)
    return torch.full(shape, int(value), dtype=torch.long, device=device)


def rand(shape, generator, device) -> torch.Tensor:
    """torch.rand(shape) from `generator` (the port's ranks draw rows of
    the same call; the reference has one rank)."""
    return torch.rand(shape, generator=generator, device=device)
