// K3: both proposal levels of the emitter query -> final spacing bins.
//
// Replaces the TPU kernel `_proposal_kernel` (kernel A of
// nerf_emitter_tpu/ops/mega_query.py:205-238, launched at :711). Per ray:
// s0+1 uniform spacing bins between near and far under the piecewise warp;
// level-0 density (F=4) at the s0 bin midpoints; weights
// alpha * exp(-exclusive cumsum); deterministic inverse-CDF resample to s1+1
// bins (histogram pad 0.01, eps 1e-5, u_i = i (1-eps)/n + 1/(2(n+1)));
// level-1 density (F=6); the same resample to s2+1 bins, written (s2+1, N).
//
// Bound on an H100: operations. The two density MLPs are 3.6k and 5.1k MACs
// per sample over s0 + s1 = 352 samples per ray (0.19 ms of bf16 tensor-core
// time at 2^16 rays) against 32 bytes in and 196 bytes out per ray.
//
// Design: one block of 8 warps per 8 rays, the rays' bins, densities and
// CDFs in shared memory. The density passes run the block-wide wmma MLP
// over 64-sample tiles of the block's samples (f-major encoding rows, first-
// layer weight rows permuted on the host). The resample is one thread per
// ray: the TPU kernel's telescoped ramp sum is replaced by a merge walk of
// the monotone u grid against the CDF and an exact per-segment
// interpolation, the same function without the ramp form's cancellation.
#include "common.cuh"

using namespace nek;

constexpr int RAYS = 8;

struct ProposalSmem {
    MlpSmem mlp;
    float* sb_a;   // RAYS x (smax + 1) spacing bins
    float* sb_b;
    float* eb;     // RAYS x (smax + 1) euclidean bins of the current level
    float* cdf;    // RAYS x (smax + 1)
    float* dens;   // RAYS x smax: densities, then weights
    float* ray;    // RAYS x 8: o (3), d (3), s_near, s_far
};

static size_t proposal_smem_bytes(int ld, int smax) {
    return mlp_smem_bytes(ld, 1) + sizeof(float) * RAYS * (4 * (smax + 1) + smax + 8);
}

__device__ inline ProposalSmem carve(unsigned char* smem, int ld, int smax) {
    ProposalSmem p;
    p.mlp = carve_mlp_smem(smem, ld, 1);
    float* f = p.mlp.scratch + WARPS * 256;
    const int row = smax + 1;
    p.sb_a = f;
    p.sb_b = p.sb_a + RAYS * row;
    p.eb = p.sb_b + RAYS * row;
    p.cdf = p.eb + RAYS * row;
    p.dens = p.cdf + RAYS * row;
    p.ray = p.dens + RAYS * smax;
    return p;
}

// densities of the n_rays x S samples at the midpoints of p.eb (row stride smax+1)
__device__ void density_pass(const ProposalSmem& p, const Mlp& mlp, const Box& bx, int F, int S,
                             int n_rays, int smax, int ld) {
    const int total = n_rays * S;
    for (int c0 = 0; c0 < total; c0 += TILE) {
        const int t = threadIdx.x;
        bool keep = false;
        if (t < TILE) {
            const int j = c0 + t;
            float pt[3] = {0.0f, 0.0f, 0.0f}, x2[3];
            if (j < total) {
                const int r = j / S, sidx = j % S;
                const float* eb = p.eb + r * (smax + 1);
                const float mid = (eb[sidx] + eb[sidx + 1]) / 2.0f;
                const float* ray = p.ray + r * 8;
                for (int k = 0; k < 3; ++k) pt[k] = ray[k] + ray[3 + k] * mid;
            }
            keep = contract_and_select(bx, pt, x2) && j < total;
            freq_encode(p.mlp.a + (size_t)t * ld, x2, F, true, mlp.k[0]);
        }
        run_mlp(mlp, p.mlp, ld);
        if (t < TILE && c0 + t < total)
            p.dens[((c0 + t) / S) * smax + (c0 + t) % S] =
                density_of(p.mlp.out[t], keep, bx.avg_density);
        __syncthreads();
    }
}

// one thread per ray: weights from densities and p.eb, then the inverse-CDF
// resample of spacing bins sb_in (S+1) to sb_out (n_out+1)
__device__ void resample_ray(const ProposalSmem& p, int r, int S, int n_out, int smax,
                             const float* sb_in, float* sb_out) {
    const float* eb = p.eb + r * (smax + 1);
    float* w = p.dens + r * smax;
    float* cdf = p.cdf + r * (smax + 1);
    float excl = 0.0f, w_sum = 0.0f;
    for (int s = 0; s < S; ++s) {
        const float dd = w[s] * (eb[s + 1] - eb[s]);
        const float wt = (1.0f - expf(-dd)) * expf(-excl);
        excl += dd;
        w[s] = wt + HIST_PAD;
        w_sum += w[s];
    }
    const float padding = fmaxf(PDF_EPS - w_sum, 0.0f);
    w_sum += padding;
    float run = 0.0f;
    cdf[0] = 0.0f;
    for (int s = 0; s < S - 1; ++s) {
        run += (w[s] + padding / S) / w_sum;
        cdf[s + 1] = fminf(1.0f, run);
    }
    cdf[S] = 1.0f;
    const double step = (1.0 - 1e-5) / n_out, u0 = 1.0 / (2.0 * (n_out + 1));
    int b = 0;
    for (int i = 0; i <= n_out; ++i) {
        const float u = (float)(i * step + u0);
        while (b < S - 1 && cdf[b + 1] <= u) ++b;
        const float frac = fminf(fmaxf((u - cdf[b]) / fmaxf(cdf[b + 1] - cdf[b], PDF_EPS), 0.0f), 1.0f);
        sb_out[i] = sb_in[b] + (sb_in[b + 1] - sb_in[b]) * frac;
    }
}

__device__ inline void euclid_bins(const ProposalSmem& p, int r, int n, int smax, const float* sb) {
    const float sn = p.ray[r * 8 + 6], sf = p.ray[r * 8 + 7];
    float* eb = p.eb + r * (smax + 1);
    for (int i = 0; i <= n; ++i) eb[i] = spacing_pw_inv(sb[i] * (sf - sn) + sn);
}

__global__ void __launch_bounds__(THREADS)
proposal_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ near, const float* __restrict__ far, long long n,
                Mlp mlp0, Mlp mlp1, Box bx, int F0, int F1, int s0, int s1, int s2, int ld,
                float* __restrict__ sbins_out) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int smax = max(s0, max(s1, s2));
    ProposalSmem p = carve(smem, ld, smax);
    const long long r0 = (long long)blockIdx.x * RAYS;
    const int n_rays = (int)min((long long)RAYS, n - r0);
    const int t = threadIdx.x;
    const int row = smax + 1;
    if (t < n_rays) {
        float* ray = p.ray + t * 8;
        for (int k = 0; k < 3; ++k) {
            ray[k] = o[k * n + r0 + t];
            ray[3 + k] = d[k * n + r0 + t];
        }
        ray[6] = spacing_pw(near[r0 + t]);
        ray[7] = spacing_pw(far[r0 + t]);
        float* sb = p.sb_a + t * row;
        for (int i = 0; i <= s0; ++i) sb[i] = (float)i / (float)s0;
        euclid_bins(p, t, s0, smax, sb);
    }
    __syncthreads();
    density_pass(p, mlp0, bx, F0, s0, n_rays, smax, ld);
    if (t < n_rays) {
        resample_ray(p, t, s0, s1, smax, p.sb_a + t * row, p.sb_b + t * row);
        euclid_bins(p, t, s1, smax, p.sb_b + t * row);
    }
    __syncthreads();
    density_pass(p, mlp1, bx, F1, s1, n_rays, smax, ld);
    if (t < n_rays) {
        float* out = p.sb_a + t * row;
        resample_ray(p, t, s1, s2, smax, p.sb_b + t * row, out);
        for (int i = 0; i <= s2; ++i) sbins_out[(long long)i * n + r0 + t] = out[i];
    }
}

NEK_ERROR_STRING_FN

extern "C" int nek_proposal(const float* o, const float* d, const float* near, const float* far,
                            long long n, const int* dims0, const long long* ptrs0,
                            const int* dims1, const long long* ptrs1, const float* box, int F0,
                            int F1, int s0, int s1, int s2, int ld, float* sbins_out,
                            void* stream) {
    Mlp mlp0 = make_mlp(dims0, ptrs0), mlp1 = make_mlp(dims1, ptrs1);
    if (last_width(mlp0) != 1 || last_width(mlp1) != 1 || s0 < 2 || s1 < 2 || s2 < 1)
        return (int)cudaErrorInvalidValue;
    const int smax = s0 > s1 ? (s0 > s2 ? s0 : s2) : (s1 > s2 ? s1 : s2);
    const size_t smem = proposal_smem_bytes(ld, smax);
    cudaError_t e = cudaFuncSetAttribute(proposal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n + RAYS - 1) / RAYS;
    if (blocks > 0)
        proposal_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            o, d, near, far, n, mlp0, mlp1, make_box(box), F0, F1, s0, s1, s2, ld, sbins_out);
    return (int)cudaGetLastError();
}
