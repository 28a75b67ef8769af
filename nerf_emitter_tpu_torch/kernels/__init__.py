"""Build, load and launch the port's CUDA kernels.

The sources under `nerf_emitter_tpu_torch/csrc/` are compiled on first use
with `nvcc` for sm_90a, one shared library per kernel source, all compiled
in parallel, into `nerf_emitter_tpu_torch/_build/<hash of sources>/`
(listed in .gitignore). A source may hold several launchers (kernels);
it is compiled once. Each library has a plain C interface loaded with
ctypes: pointers and the stream pass as `c_void_p`, and every launcher
returns `cudaGetLastError()` after its launch, which `launch` turns into a
RuntimeError.

`launches` counts, per kernel (per instantiation for the launchers that
take a mode), the launches made through `launch`; a run reads it to show
that a path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

# kernel name -> CUDA source (one shared library per source)
SOURCES = {
    "fused_density": "fused_density.cu",
    "fused_field": "fused_field.cu",
    "proposal": "proposal.cu",
    "proposal_variant": "proposal.cu",
    "field_composite": "field_composite.cu",
    "mega_pipeline": "mega_pipeline.cu",
    "resample": "resample.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PI, _PLL, _PF = ctypes.POINTER(_I), ctypes.POINTER(_LL), ctypes.POINTER(_F)
_MLP = [_PI, _PLL]  # dims, pointers (PackedMlp.args)
# C launcher `nek_<kernel>` of each kernel -> argument types; every launcher
# ends with the stream and returns cudaGetLastError()
SIGNATURES = {
    "fused_density": [_P, _LL, *_MLP, _PF, _I, _I, _P, _P],
    "fused_field": [_P, _P, _P, _I, _LL, *_MLP, *_MLP, _PF, _I, _I, _I, _F, _P, _P, _P],
    "proposal": [_P, _P, _P, _P, _LL, *_MLP, *_MLP, _PF, _I, _I, _I, _I, _I, _I, _P, _P],
    "field_composite":
        [_P, _P, _P, _P, _P, _P, _I, _LL, *_MLP, *_MLP, _PF, _I, _I, _I, _I, _F, _P, _P, _P],
    "mega_pipeline": [_P, _P, _P, _P, _P, _I, _LL, *_MLP, *_MLP, *_MLP, *_MLP, _PF, _I, _I, _I,
                      _I, _I, _I, _I, _I, _F, _I, _P, _P, _P],
    "resample": [_I, _P, _P, _P, _LL, _I, _I, _I, _P, _P],
}
SIGNATURES["proposal_variant"] = [_I, *SIGNATURES["proposal"]]

launches: collections.Counter = collections.Counter()
_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels build on a CUDA machine")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every kernel source (in parallel) unless this set of sources
    is already built; load the libraries. Returns build_info: the build
    directory, seconds spent and each source's ptxas report."""
    if _libs:
        return build_info
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in sorted(set(SOURCES.values())):
        stem = Path(src).stem
        lib = out_dir / f"lib{stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{stem}.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    reports = {}
    failed = []
    for stem, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[stem] = out
        (out_dir / f"{stem}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name, src in SOURCES.items():
        lib = ctypes.CDLL(str(out_dir / f"lib{Path(src).stem}.so"))
        lib.nek_error_string.restype = ctypes.c_char_p
        lib.nek_error_string.argtypes = [ctypes.c_int]
        fn = getattr(lib, f"nek_{name}")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    build_info.update(dir=str(out_dir), seconds=time.perf_counter() - t0,
                      compiled=sorted(procs), ptxas=reports)
    return build_info


def mega_pipeline_occupancy(ld: int, s0: int, s1: int, s2: int) -> tuple[int, int]:
    """(blocks of K5 resident per SM, SM count) at these row stride and
    sample counts, as its launcher sizes its persistent grid."""
    build()
    fn = _libs["mega_pipeline"].nek_mega_pipeline_occupancy
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    per_sm, sms = _I(0), _I(0)
    rc = fn(ld, s0, s1, s2, ctypes.byref(per_sm), ctypes.byref(sms))
    if rc != 0:
        msg = _libs["mega_pipeline"].nek_error_string(rc).decode()
        raise RuntimeError(f"mega_pipeline occupancy: {msg}")
    return per_sm.value, sms.value


# ---------------------------------------------------------------------------
# argument helpers
# ---------------------------------------------------------------------------


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def i32(x: int) -> ctypes.c_int:
    return ctypes.c_int(int(x))


def i64(x: int) -> ctypes.c_longlong:
    return ctypes.c_longlong(int(x))


def f32(x: float) -> ctypes.c_float:
    return ctypes.c_float(float(x))


def check_tensor(t: torch.Tensor, name: str, *, ndim: int, rows: int | None = None,
                 cols: int | None = None) -> None:
    """The kernels take contiguous float32 CUDA tensors of a known shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: kernel needs float32, got {t.dtype}")
    if t.ndim != ndim or (rows is not None and t.shape[0] != rows) or (
        cols is not None and t.shape[-1] != cols
    ):
        raise ValueError(f"{name}: unexpected shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous tensor")


def box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density):
    """The 14 floats of csrc/common.cuh `Box`: scene-box origin and inverse
    extent, carve-out flag and corners, average density."""
    lo, hi = disable_box if disable_box is not None else ((0.0,) * 3, (0.0,) * 3)
    vals = [*aabb_lo, *aabb_inv_ext, 1.0 if disable_box is not None else 0.0, *lo, *hi, avg_density]
    return (ctypes.c_float * 14)(*[float(v) for v in vals])


class PackedMlp:
    """An MLP's (in, out) float32 weights laid out for csrc/common.cuh `Mlp`:
    per layer a bf16 (k, n) row-major copy with k padded to a multiple of 16
    (zero rows), the f32 bias, and for an output layer at most 4 wide the
    f32 (k, n) weight its reduce uses. Hidden widths must be multiples of
    16 (they are wmma tile widths)."""

    def __init__(self, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], *, device):
        n_layers = len(ws)
        if not 1 <= n_layers <= 8:
            raise ValueError(f"kernel MLPs have 1..8 layers, got {n_layers}")
        self.k_real = [w.shape[0] for w in ws]
        self.k = [-(-k // 16) * 16 for k in self.k_real]
        self.n = [w.shape[1] for w in ws]
        self._keep = []
        ptrs = []
        for i, (w, b) in enumerate(zip(ws, bs)):
            last = i == n_layers - 1
            if w.device != device or b.device != device:
                raise ValueError("MLP weights must be on the kernel's device")
            if (not last or self.n[i] > 4) and self.n[i] % 16:
                raise ValueError(f"layer {i}: width {self.n[i]} is not a multiple of 16")
            if i and self.k[i] != self.k_real[i]:
                raise ValueError(f"layer {i}: input width {self.k_real[i]} is not a multiple of 16")
            wb = torch.zeros(self.k[i], self.n[i], dtype=torch.bfloat16, device=device)
            wb[: self.k_real[i]] = w.detach()
            bias = b.detach().float().contiguous()
            self._keep += [wb, bias]
            ptrs += [wb.data_ptr(), bias.data_ptr()]
        wl = torch.zeros(self.k[-1], self.n[-1], dtype=torch.float32, device=device)
        wl[: self.k_real[-1]] = ws[-1].detach()
        self._keep.append(wl)
        ptrs.append(wl.data_ptr())
        self.ld = max([self.k[0]] + self.n[:-1]) + 8
        self._dims = (ctypes.c_int * (1 + 2 * n_layers))(n_layers, *self.k, *self.n)
        self._ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)

    def args(self):
        return self._dims, self._ptrs


def launch(name: str, *args, count_as: str | None = None) -> None:
    """Call the launcher `nek_<name>` of kernel `name` on the current
    stream; raise if the launch was refused; count it under `count_as`
    (a launcher's instantiation, e.g. "resample[walk]") or its name."""
    build()
    lib = _libs[name]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib, f"nek_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed: {lib.nek_error_string(rc).decode()}")
    launches[count_as or name] += 1
