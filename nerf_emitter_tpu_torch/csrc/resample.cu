// P3: the two-level inverse-CDF resample of given weights, in two forms.
//
// Replaces the profiling kernel of scripts/profile_resample.py
// (`make_kernel` :134-139, launched at :167): from weights w0 (S0, N) over
// spacing bins sb0 (S0+1, N), sb1' = R(w0, sb0, S1); then from w1 (S1, N),
// out = R(w1, sb1', S2), written (S2+1, N). The script's fourth input sb1
// is never read by its kernel body and is not passed here.
//
// Two forms of R, a compile-time choice:
// - kRamp: the TPU's form, `_prep` plus `resample_scalar_u` (:42-60,
//   :79-90): the CDF and the telescoped slope coefficients
//   coef = [g, 0] - [0, g], g = d_bins / max(d_cdf, eps), then each output
//   row is sb[0] + sum_s coef[s] relu(u_i - cdf[s]), in f32. The script's
//   `scalar-u-mxu` variant computes the same sum with its row reduce moved
//   onto the TPU's matrix unit, so this form is the counterpart of both.
// - kWalk: K3's resample (emitter_query.cuh `inverse_cdf`: the CDF by
//   warp scans, each u's segment by binary search, the exact per-segment
//   interpolation).
//
// Bound on an H100, both forms: the function's bytes (w0, sb0 and w1 read
// once, the output written once: 658 floats, 2.6 KB a ray). The walk's
// work is O(S + n_out log S) a ray. The ramp's (S1+1)(S0+1) + (S2+1)(S1+1) cells of 4 f32
// operations each (116 kFLOP a ray at (256, 96, 48)) are the cost of the
// ramp algorithm, not of the function, and do not set its bound.
//
// Design: one block of 8 warps per 16 rays. The block loads its rays'
// columns into per-ray shared-memory rows; one warp per ray builds the CDF
// as K3 does (and the ramp's coefficients, over the weights, a lane per
// segment), each warp taking two rays; the ramp's output rows are spread
// over all threads, one (row, ray) each.
#include "emitter_query.cuh"

using namespace nek;

constexpr int RAYS = 16;

enum ResampleForm { kRamp = 0, kWalk = 1 };

// the slope of segment s of the piecewise-linear inverse CDF
__device__ inline float ramp_slope(const float* cdf, const float* sb, int s) {
    return (sb[s + 1] - sb[s]) / fmaxf(cdf[s + 1] - cdf[s], PDF_EPS);
}

// the telescoped ramp coefficients (S+1) of the segments' slopes, over w:
// coef[s] = g[s] - g[s-1] (g[-1] = g[S] = 0), a lane per coefficient
__device__ inline void ramp_coef(float* coef, const float* cdf, int S, const float* sb, int lane) {
    for (int s = lane; s <= S; s += 32)
        coef[s] = (s < S ? ramp_slope(cdf, sb, s) : 0.0f) - (s > 0 ? ramp_slope(cdf, sb, s - 1) : 0.0f);
}

// R(w, sb_in, n_out) for the block's n_rays rays (row stride `row`), a
// warp per ray: w is clobbered, cdf is scratch. All threads call it.
template <int FORM>
__device__ inline void resample_stage(float* w, float* cdf, const float* sb_in, float* sb_out,
                                      int S, int n_out, int n_rays, int row) {
    const int t = threadIdx.x, lane = t % 32;
    for (int r = t / 32; r < n_rays; r += WARPS) {
        if (FORM == kWalk) {
            inverse_cdf(w + r * row, cdf + r * row, S, sb_in + r * row, n_out, sb_out + r * row, lane);
        } else {
            build_cdf(w + r * row, cdf + r * row, S, lane);
            __syncwarp();  // every lane's cdf is in; the weights are read
            ramp_coef(w + r * row, cdf + r * row, S, sb_in + r * row, lane);
        }
        __syncwarp();
    }
    __syncthreads();
    if (FORM == kWalk) return;
    for (int k = t; k < (n_out + 1) * n_rays; k += blockDim.x) {
        const int r = k % n_rays, i = k / n_rays;
        const float u = resample_u(i, n_out);
        const float* c = cdf + r * row;
        const float* cf = w + r * row;
        float acc = 0.0f;
        for (int s = 0; s <= S; ++s) acc += cf[s] * fmaxf(u - c[s], 0.0f);
        sb_out[r * row + i] = sb_in[r * row] + acc;
    }
    __syncthreads();
}

// (rows, n) columns r0.. of src -> per-ray shared rows of stride `row`
__device__ inline void load_rows(float* dst, const float* __restrict__ src, int rows, long long n,
                                 long long r0, int n_rays, int row) {
    for (int k = threadIdx.x; k < rows * n_rays; k += blockDim.x) {
        const int r = k % n_rays, s = k / n_rays;
        dst[r * row + s] = src[s * n + r0 + r];
    }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
resample_kernel(const float* __restrict__ w0, const float* __restrict__ sb0,
                const float* __restrict__ w1, long long n, int S0, int S1, int S2, int row,
                float* __restrict__ out) {
    extern __shared__ __align__(128) float sm[];
    float* w = sm;                  // RAYS x row: weights, then the ramp coefficients
    float* cdf = w + RAYS * row;    // RAYS x row
    float* sb_a = cdf + RAYS * row; // RAYS x row: sb0, then the output bins
    float* sb_b = sb_a + RAYS * row;  // RAYS x row: sb1'
    const long long r0 = (long long)blockIdx.x * RAYS;
    const int n_rays = (int)min((long long)RAYS, n - r0);
    load_rows(w, w0, S0, n, r0, n_rays, row);
    load_rows(sb_a, sb0, S0 + 1, n, r0, n_rays, row);
    __syncthreads();
    resample_stage<FORM>(w, cdf, sb_a, sb_b, S0, S1, n_rays, row);
    load_rows(w, w1, S1, n, r0, n_rays, row);
    __syncthreads();
    resample_stage<FORM>(w, cdf, sb_b, sb_a, S1, S2, n_rays, row);
    for (int k = threadIdx.x; k < (S2 + 1) * n_rays; k += blockDim.x) {
        const int r = k % n_rays, s = k / n_rays;
        out[s * n + r0 + r] = sb_a[r * row + s];
    }
}

template <int FORM>
static int launch(const float* w0, const float* sb0, const float* w1, long long n, int S0, int S1,
                  int S2, float* out, void* stream) {
    if (S0 < 2 || S1 < 2 || S2 < 1) return (int)cudaErrorInvalidValue;
    const int most = S0 > S1 ? (S0 > S2 ? S0 : S2) : (S1 > S2 ? S1 : S2);
    const int row = (most + 1) | 1;
    const size_t smem = sizeof(float) * 4 * RAYS * row;
    cudaError_t e = cudaFuncSetAttribute(resample_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n + RAYS - 1) / RAYS;
    if (blocks > 0)
        resample_kernel<FORM><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            w0, sb0, w1, n, S0, S1, S2, row, out);
    return (int)cudaGetLastError();
}

NEK_ERROR_STRING_FN

// form: 0 ramp, 1 walk
extern "C" int nek_resample(int form, const float* w0, const float* sb0, const float* w1,
                            long long n, int S0, int S1, int S2, float* out, void* stream) {
    switch (form) {
        case kRamp: return launch<kRamp>(w0, sb0, w1, n, S0, S1, S2, out, stream);
        case kWalk: return launch<kWalk>(w0, sb0, w1, n, S0, S1, S2, out, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
