// Pieces the emitter-query kernels share: the affine scene-box map with
// keep mask and carve-out box, the degree-4 SH basis, the density and
// colour activations and the piecewise spacing warp.
//
// The kernels' MLPs run on Hopper's warpgroup matrix multiply: the proposal
// density MLP of K1, K3, P2 and K5's proposal stage in density_mlp.cuh, the
// field MLP of K2, K4 and K5 in field_mlp.cuh. Their arithmetic follows the
// TPU kernels (nerf_emitter_tpu/ops/fused_field.py `_mlp_rowsT`): bf16
// operands, f32 accumulation, f32 bias, ReLU, re-cast to bf16; an output
// layer at most 4 wide is an f32 reduce with the f32 weight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nek {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // 8 warps per block
constexpr int WARPS = THREADS / 32;
constexpr float SAFE_EXP_MAX = 88.0f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float HIST_PAD = 0.01f;  // sample_pdf histogram padding
constexpr float PDF_EPS = 1e-5f;   // sample_pdf eps

// scene box, carve-out box and average density (kernels/__init__.py box_consts)
struct Box {
    float lo[3], inv_ext[3];
    int has_box;
    float box_lo[3], box_hi[3];
    float avg_density;
};

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

}  // namespace nek

#define NEK_ERROR_STRING_FN \
    extern "C" const char* nek_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
