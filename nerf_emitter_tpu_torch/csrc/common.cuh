// Pieces the emitter-query kernels share: the affine scene-box map
// with keep mask and carve-out box, the frequency encoding by double-angle
// recurrence, the degree-4 SH basis, the piecewise spacing warp, and one
// block-wide wmma MLP over a tile of TILE samples.
//
// The wmma MLP (`wmma_layer`, `run_mlp`) carries the density MLPs of K3
// and P2 (proposal.cu) and of K5's proposal stage (mega_pipeline.cu), and
// nothing else. K1's density MLP runs on wgmma (density_mlp.cuh), and the
// field MLP of K2, K4 and K5 too (field_mlp.cuh).
//
// MLP arithmetic follows the TPU kernels (nerf_emitter_tpu/ops/fused_field.py
// `_mlp_rowsT`): bf16 operands, f32 accumulation (wmma 16x16x16 bf16 tiles on
// the tensor cores), f32 bias, ReLU, re-cast to bf16; an output layer at most
// 4 wide is an f32 reduce with the f32 weight.
//
// Activations live in shared memory as bf16 rows (TILE x ld, ld a multiple
// of 8 elements so every 16-row tile starts 32-byte aligned); weights are
// read as wmma fragments straight from global memory, where they stay
// resident in L1/L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace nek {

using bf16 = __nv_bfloat16;

constexpr int MAX_LAYERS = 8;
constexpr int TILE = 64;       // samples per MLP tile
constexpr int THREADS = 256;   // 8 warps per block
constexpr int WARPS = THREADS / 32;
constexpr float SAFE_EXP_MAX = 88.0f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float HIST_PAD = 0.01f;  // sample_pdf histogram padding
constexpr float PDF_EPS = 1e-5f;   // sample_pdf eps

struct Mlp {
    int n_layers;
    int k[MAX_LAYERS];            // input width, padded to a multiple of 16
    int n[MAX_LAYERS];            // output width
    const bf16* w[MAX_LAYERS];    // (k, n) row-major
    const float* b[MAX_LAYERS];   // (n,)
    const float* w_last;          // (k, n) f32 of the last layer
};

// scene box, carve-out box and average density (kernels/__init__.py box_consts)
struct Box {
    float lo[3], inv_ext[3];
    int has_box;
    float box_lo[3], box_hi[3];
    float avg_density;
};

// dims = [L, k[0..L-1], n[0..L-1]]; ptrs = [w0, b0, ..., w_{L-1}, b_{L-1}, w_last]
inline Mlp make_mlp(const int* dims, const long long* ptrs) {
    Mlp m{};
    m.n_layers = dims[0];
    for (int i = 0; i < m.n_layers; ++i) {
        m.k[i] = dims[1 + i];
        m.n[i] = dims[1 + m.n_layers + i];
        m.w[i] = reinterpret_cast<const bf16*>(ptrs[2 * i]);
        m.b[i] = reinterpret_cast<const float*>(ptrs[2 * i + 1]);
    }
    m.w_last = reinterpret_cast<const float*>(ptrs[2 * m.n_layers]);
    return m;
}

inline Box make_box(const float* c) {
    Box b{};
    for (int i = 0; i < 3; ++i) {
        b.lo[i] = c[i];
        b.inv_ext[i] = c[3 + i];
        b.box_lo[i] = c[7 + i];
        b.box_hi[i] = c[10 + i];
    }
    b.has_box = c[6] != 0.0f;
    b.avg_density = c[13];
    return b;
}

inline int last_width(const Mlp& m) { return m.n[m.n_layers - 1]; }

// Shared memory of one MLP tile: two bf16 activation buffers, the f32 output
// of the last layer (TILE x out_max) and one 16x16 f32 scratch per warp.
__host__ __device__ inline size_t mlp_smem_bytes(int ld, int out_max) {
    return 2 * (size_t)TILE * ld * sizeof(bf16) + (size_t)TILE * out_max * sizeof(float) +
           (size_t)WARPS * 256 * sizeof(float);
}

struct MlpSmem {
    bf16* a;
    bf16* b;
    float* out;
    float* scratch;
};

__device__ inline MlpSmem carve_mlp_smem(unsigned char* base, int ld, int out_max) {
    MlpSmem s;
    s.a = reinterpret_cast<bf16*>(base);
    s.b = s.a + (size_t)TILE * ld;
    s.out = reinterpret_cast<float*>(s.b + (size_t)TILE * ld);
    s.scratch = s.out + (size_t)TILE * out_max;
    return s;
}

// ---------------------------------------------------------------------------
// per-sample math
// ---------------------------------------------------------------------------

// pos -> x2 in [-1, 1]^3 inside the scene box; returns keep (in the scene box
// and, with a carve-out box, not strictly inside it)
__device__ inline bool contract_and_select(const Box& bx, const float p[3], float x2[3]) {
    bool sel = true;
    for (int k = 0; k < 3; ++k) {
        float u = (p[k] - bx.lo[k]) * bx.inv_ext[k];
        sel = sel && (u >= 0.0f) && (u <= 1.0f);
        x2[k] = u * 2.0f - 1.0f;
    }
    if (bx.has_box) {
        bool inside = true;
        for (int k = 0; k < 3; ++k) inside = inside && (p[k] > bx.box_lo[k]) && (p[k] < bx.box_hi[k]);
        sel = sel && !inside;
    }
    return sel;
}

// Writes the 3 + 6F f-major encoding of x2 into row (bf16) and zero-fills
// up to kpad: [x, sin(dim k, octave i) at 3 + 3 i + k, cos at 3 + 3F + 3 i + k]
// (the first layer's rows are permuted on the host to match).
__device__ inline void freq_encode(bf16* row, const float x2[3], int F, int kpad) {
    for (int k = 0; k < 3; ++k) {
        row[k] = __float2bfloat16(x2[k]);
        float th = x2[k] * TWO_PI;
        float s = sinf(th), c = cosf(th);
        for (int i = 0; i < F; ++i) {
            int r = 3 * i + k;
            row[3 + r] = __float2bfloat16(s);
            row[3 + 3 * F + r] = __float2bfloat16(c);
            float s2 = (2.0f * s) * c;
            float c2 = __fsub_rn(1.0f, __fmul_rn(2.0f * s, s));  // the twins' rounding, unfused
            s = s2;
            c = c2;
        }
    }
    for (int j = 3 + 6 * F; j < kpad; ++j) row[j] = __float2bfloat16(0.0f);
}

// degree-4 real SH of a unit direction, reference coefficients and order
__device__ inline void sh4(float x, float y, float z, float out[16]) {
    float xx = x * x, yy = y * y, zz = z * z;
    float xy = x * y, yz = y * z, xz = x * z;
    out[0] = 0.28209479177387814f;
    out[1] = -0.48860251190291987f * y;
    out[2] = 0.48860251190291987f * z;
    out[3] = -0.48860251190291987f * x;
    out[4] = 1.0925484305920792f * xy;
    out[5] = -1.0925484305920792f * yz;
    out[6] = 0.94617469575755997f * zz - 0.31539156525251999f;
    out[7] = -1.0925484305920792f * xz;
    out[8] = 0.54627421529603959f * (xx - yy);
    out[9] = 0.59004358992664352f * y * (-3.0f * xx + yy);
    out[10] = 2.8906114426405538f * xy * z;
    out[11] = 0.45704579946446572f * y * (1.0f - 5.0f * zz);
    out[12] = 0.3731763325901154f * z * (5.0f * zz - 3.0f);
    out[13] = 0.45704579946446572f * x * (1.0f - 5.0f * zz);
    out[14] = 1.4453057213202769f * z * (xx - yy);
    out[15] = 0.59004358992664352f * x * (-xx + 3.0f * yy);
}

__device__ inline float density_of(float raw, bool keep, float avg_density) {
    return keep ? avg_density * expf(fminf(raw - 1.0f, SAFE_EXP_MAX)) : 0.0f;
}

__device__ inline float rgb_of(float raw, int hdr, float rgb_bias) {
    return hdr ? expf(fminf(raw + rgb_bias, SAFE_EXP_MAX)) : 1.0f / (1.0f + expf(-raw));
}

// UniformLinDispPiecewise spacing (ops/samplers.py spacing_piecewise) and inverse
__device__ inline float spacing_pw(float t) {
    return t < 1.0f ? t / 2.0f : 1.0f - 1.0f / (2.0f * fmaxf(t, 1e-10f));
}

__device__ inline float spacing_pw_inv(float s) {
    return s < 0.5f ? 2.0f * s : 1.0f / fmaxf(2.0f - 2.0f * s, 1e-10f);
}

// ---------------------------------------------------------------------------
// the block-wide MLP
// ---------------------------------------------------------------------------

// out = in (TILE x K) @ W (K x N) + bias, for the 16-row tiles [tm_lo, tm_hi)
// of the TILE rows. With out_bf: ReLU, bf16, row stride ld_out; else f32
// into out_f (row stride ld_out). 16x16 output tiles go to the warps
// round-robin; each warp stages its f32 tile in its scratch.
__device__ inline void wmma_layer(const bf16* in, int ld_in, int K, const bf16* W, int N,
                                  const float* bias, bf16* out_bf, float* out_f, int ld_out,
                                  float* scratch, int tm_lo = 0, int tm_hi = TILE / 16) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* scr = scratch + warp * 256;
    const int tiles_m = tm_hi - tm_lo, tiles = tiles_m * (N / 16);
    for (int t = warp; t < tiles; t += WARPS) {
        const int tm = tm_lo + t % tiles_m, tn = t / tiles_m;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int k = 0; k < K; k += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, in + (size_t)tm * 16 * ld_in + k, ld_in);
            wmma::load_matrix_sync(fb, W + (size_t)k * N + tn * 16, N);
            wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
            const int row = tm * 16 + e / 16, col = tn * 16 + e % 16;
            const float v = scr[e] + bias[col];
            if (out_bf)
                out_bf[row * ld_out + col] = __float2bfloat16(fmaxf(v, 0.0f));
            else
                out_f[row * ld_out + col] = v;
        }
        __syncwarp();
    }
}

// The output layer of run_mlp on the last hidden rows
// `cur`: f32 (TILE x n_last, row stride n_last) into s.out.
__device__ inline void run_mlp_last(const Mlp& m, const MlpSmem& s, const bf16* cur, int ld) {
    const int L = m.n_layers - 1, n = m.n[L], K = m.k[L];
    if (n <= 4) {
        for (int i = threadIdx.x; i < TILE * n; i += blockDim.x) {
            const int t = i / n, o = i % n;
            const bf16* h = cur + (size_t)t * ld;
            float acc = 0.0f;
            for (int j = 0; j < K; ++j) acc += m.w_last[j * n + o] * __bfloat162float(h[j]);
            s.out[t * n + o] = acc + m.b[L][o];
        }
    } else {
        wmma_layer(cur, ld, K, m.w[L], n, m.b[L], nullptr, s.out, n, s.scratch);
    }
    __syncthreads();
}

// Runs the MLP on the TILE rows of s.a (input in columns [0, k[0])). Hidden
// layers ping-pong between s.a and s.b; the last layer writes f32
// (TILE x n_last, row stride n_last) to s.out. All threads of the block call it.
__device__ inline void run_mlp(const Mlp& m, const MlpSmem& s, int ld) {
    bf16* cur = s.a;
    bf16* nxt = s.b;
    __syncthreads();
    for (int l = 0; l < m.n_layers - 1; ++l) {
        wmma_layer(cur, ld, m.k[l], m.w[l], m.n[l], m.b[l], nxt, nullptr, ld, s.scratch);
        __syncthreads();
        bf16* t = cur;
        cur = nxt;
        nxt = t;
    }
    run_mlp_last(m, s, cur, ld);
}

}  // namespace nek

#define NEK_ERROR_STRING_FN \
    extern "C" const char* nek_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
