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
    "field_mlp": "field_mlp.cu",
    "resample": "resample.cu",
    "field_composite_vjp": "field_composite_vjp.cu",
    "hash_grid_forward": "hash_grid.cu",
    "hash_grid_backward": "hash_grid.cu",
    "hash_grid_positions_backward": "hash_grid.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PI, _PLL, _PF = ctypes.POINTER(_I), ctypes.POINTER(_LL), ctypes.POINTER(_F)
_MLP = [_PI, _PLL]  # dims, pointers (FieldPack.args)
# C launcher `nek_<kernel>` of each kernel -> argument types; every launcher
# ends with the stream and returns cudaGetLastError()
SIGNATURES = {
    "fused_density": [_P, _LL, _P, _PF, _I, _P, _P],
    "fused_field": [_P, _P, _P, _I, _LL, *_MLP, _PF, _I, _I, _F, _P, _P, _P],
    "proposal": [_P, _P, _P, _P, _LL, _P, _P, _PF, _I, _I, _I, _I, _I, _P, _P],
    "field_composite": [_P, _P, _P, _P, _P, _P, _I, _LL, *_MLP, _PF, _I, _I, _I, _F, _P, _P, _P],
    "mega_pipeline": [_P, _P, _P, _P, _P, _I, _LL, _P, _P, *_MLP, _PF, _I, _I, _I, _I, _I, _I, _I, _F,
                      _P, _P, _P],
    "field_mlp": [_P, _I, _P, _P, _I, _LL, *_MLP, _I, _P, _P],
    "resample": [_I, _P, _P, _P, _LL, _I, _I, _I, _P, _P],
    "field_composite_vjp": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, *_MLP, _P, _PF, _I, _I, _I, _F, _P, _P, _P, _P,
                            _P],
    "hash_grid_forward": [_P, _P, _P, _LL, _P, _I, _LL, _P, _P, _P],
    "hash_grid_backward": [_P, _P, _LL, _P, _I, _LL, _P, _P],
    "hash_grid_positions_backward": [_P, _P, _P, _LL, _P, _I, _LL, _P, _P],
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
    directory, seconds spent, the sources compiled now and each source's
    ptxas report (saved beside the library when it was built)."""
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
    for stem in {Path(src).stem for src in SOURCES.values()} - reports.keys():
        log = out_dir / f"{stem}.log"  # built earlier: its saved report
        if log.exists():
            reports[stem] = log.read_text()
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


def _occupancy(name: str, *args) -> tuple[int, int, int]:
    build()
    lib = _libs[name]
    fn = getattr(lib, f"nek_{name}_occupancy")
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_LL)]
    fn.restype = ctypes.c_int
    per_sm, sms, smem = _I(0), _I(0), _LL(0)
    rc = fn(*args, ctypes.byref(per_sm), ctypes.byref(sms), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy: {lib.nek_error_string(rc).decode()}")
    return per_sm.value, sms.value, smem.value


def mega_pipeline_occupancy(s0: int, s1: int, s2: int) -> tuple[int, int, int]:
    """(blocks of K5 resident per SM, SM count, dynamic shared memory bytes)
    at these sample counts, as its launcher sizes its persistent grid."""
    return _occupancy("mega_pipeline", s0, s1, s2)


def proposal_occupancy(s0: int, s1: int, s2: int) -> tuple[int, int, int]:
    """The same for K3."""
    return _occupancy("proposal", s0, s1, s2)


def field_composite_occupancy(s2: int) -> tuple[int, int, int]:
    """The same for K4 at s2 samples per ray."""
    return _occupancy("field_composite", s2)


def field_composite_vjp_occupancy(s2: int, mask_words: int) -> tuple[int, int, int]:
    """The same for the field/composite vjp at s2 samples per ray and
    `mask_words` (`field_mask_words`)."""
    return _occupancy("field_composite_vjp", s2, mask_words)


def fused_density_occupancy() -> tuple[int, int, int]:
    """The same for K1."""
    return _occupancy("fused_density")


def fused_field_occupancy() -> tuple[int, int, int]:
    """The same for K2."""
    return _occupancy("fused_field")


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


# ---------------------------------------------------------------------------
# the wgmma field of K2, K4 and K5 (csrc/field_mlp.cuh)
# ---------------------------------------------------------------------------

# constants of csrc/field_mlp.cuh
WG_ROWS = 64  # rows per consumer warpgroup
PASS_ROWS = 2 * WG_ROWS  # rows per pass
RING = 3  # weight stages
STAGE_BYTES = 32768
SLAB_COLS = 256
SLAB_BYTES = WG_ROWS * SLAB_COLS * 2
FIELD_MAX_LAYERS = 16
FIELD_MAX_CHUNKS = 64
FIELD_RAYS = 8  # rays per K4 block / K5 group
FIELD_PRE = 1024 + 64  # mbarriers, keep flags and raw densities below the ring
HIDDEN_WIDTHS = (64, 128, 256)  # the wgmma shapes the field takes
BASE_OUT, HEAD_OUT = 16, 3  # density + 15 geo features; rgb
SH_GEO = 31  # SH (16) and geo (15) columns ahead of the appearance vector
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100


def _pad64(k: int) -> int:
    return -(-k // 64) * 64


def check_field_widths(base_shapes, head_shapes, n_emb: int | None = None) -> None:
    """Raise ValueError unless the wgmma field of K2, K4 and K5 takes an MLP of
    these (in, out) layer shapes: a base MLP of at least one hidden layer
    and a 16-wide output, a head over [SH 16, geo 15, appearance n_emb] with
    at least one hidden layer and a 3-wide output; hidden widths in
    HIDDEN_WIDTHS; first-layer inputs padded to a multiple of 64 at most
    SLAB_COLS wide."""
    base = [tuple(int(x) for x in s) for s in base_shapes]
    head = [tuple(int(x) for x in s) for s in head_shapes]
    for name, mlp, out in (("base", base, BASE_OUT), ("head", head, HEAD_OUT)):
        if len(mlp) < 2:
            raise ValueError(f"wgmma field: the {name} MLP needs a hidden layer, got {len(mlp)} layer(s)")
        if mlp[-1][1] != out:
            raise ValueError(f"wgmma field: the {name} MLP must end {out} wide, got {mlp[-1][1]}")
        for i, (k, n) in enumerate(mlp[:-1]):
            if n not in HIDDEN_WIDTHS:
                raise ValueError(f"wgmma field: {name} layer {i} is {n} wide; hidden widths must be one "
                                 f"of {HIDDEN_WIDTHS}")
        for i in range(1, len(mlp)):
            if mlp[i][0] != mlp[i - 1][1]:
                raise ValueError(f"wgmma field: {name} layer {i} takes {mlp[i][0]} inputs after a "
                                 f"{mlp[i - 1][1]}-wide layer")
        if _pad64(mlp[0][0]) > SLAB_COLS:
            raise ValueError(f"wgmma field: the {name} MLP's input ({mlp[0][0]} wide) must pad to at "
                             f"most {SLAB_COLS}")
    if head[0][0] < SH_GEO or (n_emb is not None and head[0][0] != SH_GEO + n_emb):
        raise ValueError(f"wgmma field: the head takes [SH 16, geo 15, appearance], got "
                         f"{head[0][0]} inputs" + ("" if n_emb is None else f" for {n_emb} appearance"))
    layers = [(_pad64(k), n) for k, n in base + head[:-1]]
    if len(layers) > FIELD_MAX_LAYERS:
        raise ValueError(f"wgmma field: {len(layers)} layers, at most {FIELD_MAX_LAYERS}")
    chunks = sum(k // 64 // kb_per_chunk(k, n) for k, n in layers)
    if chunks > FIELD_MAX_CHUNKS:
        raise ValueError(f"wgmma field: {chunks} weight chunks per pass, at most {FIELD_MAX_CHUNKS}")


def kb_per_chunk(k_pad: int, n: int) -> int:
    """64-row K blocks of a layer (k_pad, n) per stream chunk: the most that
    divide the layer's and fit one ring stage."""
    kb = k_pad // 64
    return max(d for d in range(1, kb + 1) if kb % d == 0 and d * n * 128 <= STAGE_BYTES)


def pack_wgmma_layer(w: torch.Tensor) -> torch.Tensor:
    """A (k, n) weight as the shared-memory image wgmma reads for B: W^T in
    bf16 with k zero-padded to a multiple of 64, in 64-K blocks of n rows x
    128 bytes, the 16-byte chunk c of row j stored at chunk c ^ (j % 8).
    Flat bf16."""
    k, n = w.shape
    kp = _pad64(k)
    wt = torch.zeros(n, kp, dtype=torch.bfloat16, device=w.device)
    wt[:, :k] = w.detach().T
    kb = kp // 64
    blocks = wt.reshape(n, kb, 8, 8).permute(1, 0, 2, 3)  # (kb, row, chunk, 8)
    stored = torch.arange(8, device=w.device)[None, :] ^ (torch.arange(n, device=w.device) % 8)[:, None]
    return blocks.gather(2, stored[None, :, :, None].expand(kb, n, 8, 8)).reshape(-1)


class FieldPack:
    """The field's base and head MLPs, (in, out) float32 weights with
    f-major first-layer rows in the base, laid out for csrc/field_mlp.cuh
    `FieldMlp`: every layer but the head's output as `pack_wgmma_layer`
    images, concatenated into one stream whose chunks (`chunks`: byte
    offset and size, in pass order) the kernels' ring loads; the f32
    biases; the head's output layer as f32 (its reduce). Raises ValueError
    on widths the field does not take (`check_field_widths`)."""

    def __init__(self, bws, bbs, hws, hbs, n_emb: int, *, device):
        check_field_widths([w.shape for w in bws], [w.shape for w in hws], n_emb)
        for t in (*bws, *bbs, *hws, *hbs):
            if t.device != device:
                raise ValueError("MLP weights must be on the kernel's device")
        pairs = list(zip(bws, bbs)) + list(zip(hws[:-1], hbs[:-1]))
        self.layers = [(_pad64(w.shape[0]), w.shape[1], kb_per_chunk(_pad64(w.shape[0]), w.shape[1]))
                       for w, _ in pairs]
        self.stream = torch.cat([pack_wgmma_layer(w) for w, _ in pairs])
        self.chunks = []
        off = 0
        for k, n, kbc in self.layers:
            for _ in range(k // 64 // kbc):
                self.chunks.append((off, kbc * n * 128))
                off += kbc * n * 128
        biases = [b.detach().float().contiguous() for _, b in pairs]
        self.w_last = hws[-1].detach().float().contiguous()
        self.b_last = hbs[-1].detach().float().contiguous()
        self.k0 = self.layers[0][0]
        self._keep = [self.stream, *biases, self.w_last, self.b_last]
        dims = [len(bws), len(hws) - 1, *(x for layer in self.layers for x in layer),
                *self.w_last.shape, 2 * self.stream.numel()]
        self._dims = (ctypes.c_int * len(dims))(*dims)
        self._ptrs = (ctypes.c_longlong * len(self._keep))(*[t.data_ptr() for t in self._keep])

    def args(self):
        return self._dims, self._ptrs


def field_smem_bytes(slab_bytes: int = 2 * SLAB_BYTES) -> int:
    """field_mlp.cuh `field_smem_bytes`: alignment slack, the mbarriers and
    per-row keep flags and raw densities (FIELD_PRE), the ring, the slabs'
    region."""
    return 1024 + FIELD_PRE + RING * STAGE_BYTES + slab_bytes


def row_passes(m: int) -> int:
    """128-row passes over m rows (K1, K2: two 64-row warpgroup tiles a
    pass)."""
    return -(-m // PASS_ROWS)


def persistent_grid(m: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of K1's or K2's persistent launch over m rows, as their
    launchers size it: one per pass, at most as many as are resident."""
    return min(row_passes(m), blocks_per_sm * sms)


# ---------------------------------------------------------------------------
# the wgmma density block of K1 (csrc/density_mlp.cuh)
# ---------------------------------------------------------------------------

DENSITY_K, DENSITY_N = 64, 128  # padded input width, hidden width
DENSITY_PACK_BYTES = DENSITY_K * DENSITY_N * 2 + 8 * DENSITY_N + 16  # image, bias, w_out, b_out
DENSITY_PACK_SPAN = -(-DENSITY_PACK_BYTES // 1024) * 1024  # a pack's room in shared memory
# the density block's work area: two 8 KB slabs, 128 keep flags, the mbarrier
DENSITY_WORK = 2 * WG_ROWS * DENSITY_K * 2 + PASS_ROWS * 4 + 16


def check_density_widths(shapes) -> None:
    """Raise ValueError unless K1's wgmma density block takes a proposal MLP
    of these (in, out) layer shapes: one hidden layer DENSITY_N wide over an
    input of at most DENSITY_K, and a 1-wide output."""
    mlp = [tuple(int(x) for x in s) for s in shapes]
    if len(mlp) != 2:
        raise ValueError(f"wgmma density: the proposal MLP needs exactly one hidden layer, got "
                         f"{len(mlp) - 1}")
    (k, n), (k_out, n_out) = mlp
    if n != DENSITY_N:
        raise ValueError(f"wgmma density: the hidden layer is {n} wide; it must be {DENSITY_N}")
    if k > DENSITY_K:
        raise ValueError(f"wgmma density: the input ({k} wide) must be at most {DENSITY_K}")
    if k_out != n or n_out != 1:
        raise ValueError(f"wgmma density: the output layer must be ({n}, 1), got ({k_out}, {n_out})")


class DensityPack:
    """A proposal MLP, (in, out) float32 weights with f-major first-layer
    rows, laid out for csrc/density_mlp.cuh: the hidden layer's
    `pack_wgmma_layer` image, the f32 hidden bias, the f32 output weight and
    the output bias zero-padded to 16 bytes, in one byte buffer
    (`buffer`) that a block loads with one bulk copy. Raises ValueError on
    widths the block does not take (`check_density_widths`)."""

    def __init__(self, ws, bs, *, device):
        check_density_widths([w.shape for w in ws])
        for t in (*ws, *bs):
            if t.device != device:
                raise ValueError("MLP weights must be on the kernel's device")
        b_out = torch.zeros(4, dtype=torch.float32, device=device)
        b_out[:1] = bs[1].detach()
        parts = [pack_wgmma_layer(ws[0]), bs[0].detach().float(), ws[1].detach().float()[:, 0], b_out]
        self.buffer = torch.cat([t.contiguous().view(torch.uint8) for t in parts])
        assert self.buffer.numel() == DENSITY_PACK_BYTES


def density_smem_bytes() -> int:
    """K1's dynamic shared memory (density_mlp.cuh `DENSITY_SMEM`):
    alignment slack, the pack padded to 1 KB, the work area (two 8 KB
    slabs, 128 keep flags, the mbarrier)."""
    return 1024 + DENSITY_PACK_SPAN + DENSITY_WORK


# ---------------------------------------------------------------------------
# the proposal stage of K3 and K5 (csrc/emitter_query.cuh)
# ---------------------------------------------------------------------------


def proposal_state_bytes(s0: int, s1: int, s2: int) -> int:
    """emitter_query.cuh `proposal_state_bytes`: per ray of a group its two
    spacing-bin rows, euclidean bins and CDF (smax+1 each), densities (smax)
    and o, d, s_near, s_far."""
    smax = max(s0, s1, s2)
    return 4 * FIELD_RAYS * (4 * (smax + 1) + smax + 8)


def proposal_smem_bytes(s0: int, s1: int, s2: int) -> int:
    """K3's (proposal.cu): alignment slack, both levels' packs, the density
    block's work area, the proposal state."""
    return 1024 + 2 * DENSITY_PACK_SPAN + DENSITY_WORK + proposal_state_bytes(s0, s1, s2)


def field_composite_smem_bytes(s2: int) -> int:
    """K4's dynamic shared memory (field_composite.cu): the field stage and
    per ray its euclidean bins, densities, colours and o, d."""
    return field_smem_bytes() + 4 * FIELD_RAYS * ((s2 + 1) + 4 * s2 + 6)


VJP_MAX_SAMPLES = 128  # the vjp kernel's s2: a ray spans at most two passes


def field_mask_words(base_shapes, head_shapes) -> int:
    """Words of ReLU mask the vjp kernel keeps per thread for a pass of the
    field of these (in, out) layer shapes: every hidden layer's n / 64."""
    return sum(int(s[1]) // 64 for mlp in (base_shapes, head_shapes) for s in list(mlp)[:-1])


def field_composite_vjp_smem_bytes(s2: int, mask_words: int) -> int:
    """The vjp kernel's (field_composite_vjp.cu): K4's field stage, the
    masks of two passes, per ray its euclidean bins and o, d, s_near, s_far,
    per sample its density, colour, their gradients' and its delta's,
    position's and SH direction's gradients, and a flags byte."""
    return field_smem_bytes() + 2 * mask_words * 256 * 4 + 4 * FIELD_RAYS * ((s2 + 1) + 8 + 11 * s2) + FIELD_RAYS * s2


def mega_pipeline_smem_bytes(s0: int, s1: int, s2: int) -> int:
    """K5's (mega_pipeline.cu): the field stage, whose slabs' region holds
    the two field slabs (where the proposal stage's packs sit between field
    stages) and the density block's work area, then the proposal state and
    the per-sample colours."""
    return field_smem_bytes(2 * SLAB_BYTES + DENSITY_WORK) + proposal_state_bytes(s0, s1, s2) + 4 * FIELD_RAYS * s2 * 3


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
