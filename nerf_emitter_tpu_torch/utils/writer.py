"""Metrics and images of a run: JSON lines, optional TensorBoard, console
(port of nerf_emitter_tpu/utils/writer.py).

Scalars are buffered per step and flushed as one row of
`<log_dir>/events.jsonl` ({"step", "ts", name: value, ...}); images are
written as EXR files under `<log_dir>/images/`. TensorBoard is used when
`torch.utils.tensorboard` imports, else skipped. The standard event names
are the reference's. A writer made with enabled=False (every rank but 0
of a run across ranks) writes, creates and prints nothing.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import exr

ITER_TRAIN_TIME = "Train Iter (time)"
TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
TEST_RAYS_PER_SEC = "Test Rays / Sec"
ETA = "ETA (time)"
CURR_TEST_PSNR = "Eval PSNR"


def _numpy(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class EventWriter:
    def __init__(self, log_dir: Path, use_tensorboard: bool = True, console_every: int = 50, enabled: bool = True):
        self.log_dir = Path(log_dir)
        self.enabled = enabled
        self._console_every = console_every
        self._buffer: dict[int, dict] = defaultdict(dict)
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "events.jsonl", "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is optional
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=str(self.log_dir / "tb"))

    def put_scalar(self, name: str, value, step: int) -> None:
        if not self.enabled:
            return
        v = float(_numpy(value))
        self._buffer[step][name] = v
        if self._tb is not None:
            self._tb.add_scalar(name, v, step)

    def put_dict(self, values: dict, step: int, prefix: str = "") -> None:
        for k, v in values.items():
            arr = _numpy(v)
            if arr.ndim == 0:
                self.put_scalar(prefix + k, arr, step)

    def put_image(self, name: str, image, step: int) -> None:
        if not self.enabled:
            return
        arr = _numpy(image).astype(np.float32)
        if self._tb is not None:
            self._tb.add_image(name, arr, step, dataformats="HWC")
        out = self.log_dir / "images" / f"{name.replace('/', '_')}_{step:06d}.exr"
        out.parent.mkdir(parents=True, exist_ok=True)
        exr.write_exr(out, arr)

    def flush(self, step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        steps = [step] if step is not None else sorted(self._buffer)
        for s in steps:
            if self._buffer.get(s):
                rec = {"step": s, "ts": time.time(), **self._buffer.pop(s)}
                self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def maybe_print(self, step: int, metrics: dict) -> None:
        if self.enabled and step % self._console_every == 0:
            parts = " ".join(f"{k}={float(_numpy(v)):.4g}" for k, v in metrics.items() if _numpy(v).ndim == 0)
            print(f"[{time.strftime('%H:%M:%S')}] step {step}: {parts}", flush=True)

    def close(self) -> None:
        if not self.enabled:
            return
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
