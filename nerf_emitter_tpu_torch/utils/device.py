"""Device selection for the port's entry points.

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
