// K7: the multiresolution hash encoding (Instant-NGP, arXiv 2201.05989) of
// the `hash` fields: nerfacto's field and its two proposal grids. Three
// launchers: the forward (with a tangent given, also its forward-mode
// derivative), the table's gradient and the positions' gradient.
//
// Replaces no TPU kernel: the JAX package's grid
// (nerf_emitter_tpu/fields/encodings.py `hash_encode`) is plain XLA, one
// gather per level and corner. It was added because that form, ported as
// plain PyTorch (fields/encodings.hash_encode, this kernel's twin), spends
// ~1 s a pretraining step in the gathers' backward, an index-put that sorts
// millions of indices per level and corner.
//
// Levels: fields/encodings.HashGridSpec's (L, 4) int32 rows: resolution,
// rows, first row, dense flag. A corner's row is the twin's
// `_corner_index`: on a dense level ix + (res+1)(iy + (res+1) iz); on a
// hashed level (ix * 1 ^ iy * 2654435761 ^ iz * 805459861) mod rows in
// uint32; plus the level's first row, clamped to the table's last row (a
// dense level's far corner at pos == 1 has weight 0 and lies past the
// level). Positions are clamped to [0, 1]; their gradient and tangent pass
// only where 0 <= x <= 1, as clamp's do. F = 2 features a row: one 8-byte
// load a corner. The forward repeats the twin's arithmetic in its order,
// with no contraction into FMAs, so it equals the twin to the bit.
//
// Bound on an H100: bytes, with no arithmetic to speak of. Per point and
// level the forward reads 8 rows and writes 8 bytes. The least bytes of a
// pretraining step at nerfacto's widths (positions in, features out, each
// table read once a forward and its gradient written once a backward) are
// 519 MB, 0.155 ms at HBM's rate. The lookups are 50 times that, served
// by L2, which holds the coarse levels (39 KB to 4 MB a level) whole.
//
// Design:
// - forward, tangent and positions' gradient: one thread per (point,
//   level), a block of P points x L levels with the level fastest, so a
//   warp's feature writes are contiguous and a point's position is one
//   broadcast read. The positions' gradient sums over levels with atomics
//   into a zeroed (N, 3) buffer (L per point: no contention).
// - the table's gradient: one thread per point, a grid row per level, so a
//   warp's lanes take neighbouring samples of a ray on one level; it adds
//   into a zeroed (T, 2) f32 buffer with float2 atomics. The coarse levels
//   take millions of samples on a few thousand rows, and same-row atomics
//   serialise in L2: on plain atomics the first proposal grid's level 0
//   took 0.76 ms for 4.2 M points, its finest level 0.40 ms. Neighbouring
//   samples mostly share a coarse cell, so each corner's values are first
//   summed over the warp's runs of equal rows (a segmented shuffle scan)
//   and one atomic a run goes out: 2.76 -> 0.71 ms for that grid's five
//   levels. Sums in shared memory per block (the dense levels up to 23^3
//   rows) were slower than either: 3.35 ms alone, 0.99 ms after the run
//   sums. Points whose incoming gradient is zero (outside the contracted
//   box) add nothing and are skipped. Atomics reorder the sums: the
//   gradient agrees with the twin's to round-off, not to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned PRIME_Y = 2654435761u, PRIME_Z = 805459861u;

struct Level {
    int res, rows, first, dense;
};

__device__ __forceinline__ Level level_at(const int4* levels, int l) {
    const int4 v = __ldg(levels + l);
    return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ float unit_clamp(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// a point's cell on a level: integer corner b and fractions f (the twin's
// sx = x * res, bx = floor(sx), fx = sx - bx, in f32)
__device__ __forceinline__ void cell_of(const float p[3], int res, unsigned b[3], float f[3]) {
    const float s = (float)res;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const float sx = __fmul_rn(p[d], s);
        const float bx = floorf(sx);
        f[d] = __fsub_rn(sx, bx);
        b[d] = (unsigned)bx;
    }
}

// corner c = 4 cx + 2 cy + cz (the twin's order): its flat table row
__device__ __forceinline__ unsigned corner_row(const unsigned b[3], int c, Level lv, unsigned last) {
    const unsigned ix = b[0] + ((c >> 2) & 1), iy = b[1] + ((c >> 1) & 1), iz = b[2] + (c & 1);
    unsigned idx;
    if (lv.dense) {
        const unsigned r1 = (unsigned)lv.res + 1u;
        idx = ix + r1 * (iy + r1 * iz);
    } else {
        idx = (ix ^ (iy * PRIME_Y) ^ (iz * PRIME_Z)) % (unsigned)lv.rows;
    }
    idx += (unsigned)lv.first;
    return idx < last ? idx : last;
}

// the twin's weight (wx * wy) * wz, wx = fx or 1 - fx
__device__ __forceinline__ float axis_weight(float f, int on) { return on ? f : __fsub_rn(1.0f, f); }

__device__ __forceinline__ float corner_weight(const float f[3], int c) {
    return __fmul_rn(__fmul_rn(axis_weight(f[0], c & 4), axis_weight(f[1], c & 2)), axis_weight(f[2], c & 1));
}

// d(weight)/d(f) of corner c, each axis's sign times the other two weights
__device__ __forceinline__ void corner_weight_grad(const float f[3], int c, float dw[3]) {
    const float wx = axis_weight(f[0], c & 4), wy = axis_weight(f[1], c & 2), wz = axis_weight(f[2], c & 1);
    dw[0] = ((c & 4) ? 1.0f : -1.0f) * wy * wz;
    dw[1] = ((c & 2) ? 1.0f : -1.0f) * wx * wz;
    dw[2] = ((c & 1) ? 1.0f : -1.0f) * wx * wy;
}

// a point's clamped position and which axes pass a derivative
__device__ __forceinline__ void load_point(const float* pos, long long i, float p[3], bool in[3]) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const float x = __ldg(pos + 3 * i + d);
        p[d] = unit_clamp(x);
        in[d] = x >= 0.0f && x <= 1.0f;
    }
}

// out (N, L) float2, level-major rows as torch.cat gives; dout the tangent
// sum_c row_c (dw_c/df . t) res where a tangent is given. Either output
// may be null.
__global__ void __launch_bounds__(THREADS) forward_kernel(const float2* __restrict__ table,
                                                          const float* __restrict__ pos,
                                                          const float* __restrict__ tangent, long long n,
                                                          const int4* __restrict__ levels, int L, unsigned last,
                                                          float2* __restrict__ out, float2* __restrict__ dout) {
    const int l = threadIdx.x;
    const long long i = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    if (i >= n) return;
    const Level lv = level_at(levels, l);
    float p[3], f[3];
    bool in[3];
    unsigned b[3];
    load_point(pos, i, p, in);
    cell_of(p, lv.res, b, f);
    float t[3] = {0.0f, 0.0f, 0.0f};
    if (dout != nullptr) {
#pragma unroll
        for (int d = 0; d < 3; ++d) t[d] = in[d] ? __ldg(tangent + 3 * i + d) * (float)lv.res : 0.0f;
    }
    float2 acc = make_float2(0.0f, 0.0f), dacc = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float2 row = __ldg(table + corner_row(b, c, lv, last));
        if (out != nullptr) {
            const float w = corner_weight(f, c);
            acc.x = __fadd_rn(acc.x, __fmul_rn(row.x, w));
            acc.y = __fadd_rn(acc.y, __fmul_rn(row.y, w));
        }
        if (dout != nullptr) {
            float dw[3];
            corner_weight_grad(f, c, dw);
            const float s = dw[0] * t[0] + dw[1] * t[1] + dw[2] * t[2];
            dacc.x += row.x * s;
            dacc.y += row.y * s;
        }
    }
    if (out != nullptr) out[i * L + l] = acc;
    if (dout != nullptr) dout[i * L + l] = dacc;
}

// grad_pos (N, 3) += sum over corners of (g . row_c) dw_c/df res, this
// level's share
__global__ void __launch_bounds__(THREADS) positions_grad_kernel(const float2* __restrict__ table,
                                                                 const float* __restrict__ pos,
                                                                 const float2* __restrict__ grad_out, long long n,
                                                                 const int4* __restrict__ levels, int L, unsigned last,
                                                                 float* __restrict__ grad_pos) {
    const int l = threadIdx.x;
    const long long i = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    if (i >= n) return;
    const float2 g = grad_out[i * L + l];
    if (g.x == 0.0f && g.y == 0.0f) return;
    const Level lv = level_at(levels, l);
    float p[3], f[3];
    bool in[3];
    unsigned b[3];
    load_point(pos, i, p, in);
    if (!(in[0] || in[1] || in[2])) return;
    cell_of(p, lv.res, b, f);
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float2 row = __ldg(table + corner_row(b, c, lv, last));
        const float gw = row.x * g.x + row.y * g.y;
        float dw[3];
        corner_weight_grad(f, c, dw);
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d] += gw * dw[d];
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
        if (in[d]) atomicAdd(grad_pos + 3 * i + d, acc[d] * (float)lv.res);
}

constexpr unsigned FULL = 0xFFFFFFFFu, NO_ROW = 0xFFFFFFFFu;

// v summed over this lane's run, the consecutive lanes of the warp whose
// `row` equals its own (neighbouring samples of a ray in one cell); true
// on the run's first lane, which then holds the run's sum. All 32 lanes
// call it.
__device__ __forceinline__ bool run_sum(unsigned row, float2& v) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned prev = __shfl_up_sync(FULL, row, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != row);
    const unsigned above = heads & ~((2u << lane) - 1u);
    const unsigned end = above ? (unsigned)__ffs(above) - 1u : 32u;
#pragma unroll
    for (unsigned off = 1; off < 32; off <<= 1) {
        const float x = __shfl_down_sync(FULL, v.x, off), y = __shfl_down_sync(FULL, v.y, off);
        if (lane + off < end) {
            v.x += x;
            v.y += y;
        }
    }
    return (heads >> lane) & 1u;
}

// grad_table's rows of level blockIdx.y += w_c g, a thread per point: each
// corner's values summed over the warp's runs of equal rows, then one
// float2 atomic (sm_90's vector atomic, one 8-byte L2 operation) a run
__global__ void __launch_bounds__(THREADS) table_grad_kernel(const float* __restrict__ pos,
                                                             const float2* __restrict__ grad_out, long long n,
                                                             const int4* __restrict__ levels, int L, unsigned last,
                                                             float2* __restrict__ grad_table) {
    const int l = blockIdx.y;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float2 g = make_float2(0.0f, 0.0f);
    if (i < n) g = grad_out[i * L + l];
    const bool live = g.x != 0.0f || g.y != 0.0f;  // a zero gradient adds nothing
    if (!__any_sync(FULL, live)) return;  // warp-uniform: the run sums need every lane
    const Level lv = level_at(levels, l);
    float p[3] = {0.0f, 0.0f, 0.0f}, f[3];
    bool in[3];
    unsigned b[3];
    if (live) load_point(pos, i, p, in);
    cell_of(p, lv.res, b, f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float w = corner_weight(f, c);
        float2 v = make_float2(w * g.x, w * g.y);
        const unsigned row = live ? corner_row(b, c, lv, last) : NO_ROW;
        if (run_sum(row, v) && row != NO_ROW) atomicAdd(grad_table + row, v);
    }
}

int check_levels(int L, long long rows) {
    if (L < 1 || L > 32 || rows < 1 || rows > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
    return 0;
}

dim3 point_level_block(int L) { return dim3(L, THREADS / L); }

}  // namespace

extern "C" const char* nek_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// features (N, L*2) and/or, with a tangent (N, 3), its tangent (N, L*2);
// out or dout may be null
extern "C" int nek_hash_grid_forward(const float* table, const float* pos, const float* tangent, long long n,
                                     const int* levels, int L, long long rows, float* out, float* dout,
                                     void* stream) {
    if (int e = check_levels(L, rows)) return e;
    if ((dout != nullptr) != (tangent != nullptr)) return (int)cudaErrorInvalidValue;
    const dim3 block = point_level_block(L);
    const long long blocks = (n + block.y - 1) / block.y;
    if (blocks > 0)
        forward_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(
            (const float2*)table, pos, tangent, n, (const int4*)levels, L, (unsigned)(rows - 1), (float2*)out,
            (float2*)dout);
    return (int)cudaGetLastError();
}

// grad_table (T, 2), zeroed by the caller, += the table's gradient
extern "C" int nek_hash_grid_backward(const float* pos, const float* grad_out, long long n, const int* levels, int L,
                                      long long rows, float* grad_table, void* stream) {
    if (int e = check_levels(L, rows)) return e;
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 0)
        table_grad_kernel<<<dim3((unsigned)blocks, L), THREADS, 0, (cudaStream_t)stream>>>(
            pos, (const float2*)grad_out, n, (const int4*)levels, L, (unsigned)(rows - 1), (float2*)grad_table);
    return (int)cudaGetLastError();
}

// grad_pos (N, 3), zeroed by the caller, += the positions' gradient
extern "C" int nek_hash_grid_positions_backward(const float* table, const float* pos, const float* grad_out,
                                                long long n, const int* levels, int L, long long rows,
                                                float* grad_pos, void* stream) {
    if (int e = check_levels(L, rows)) return e;
    const dim3 block = point_level_block(L);
    const long long blocks = (n + block.y - 1) / block.y;
    if (blocks > 0)
        positions_grad_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(
            (const float2*)table, pos, (const float2*)grad_out, n, (const int4*)levels, L, (unsigned)(rows - 1),
            grad_pos);
    return (int)cudaGetLastError();
}
