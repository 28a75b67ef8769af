// K3: both proposal levels of the emitter query -> final spacing bins; and
// P2, K3 with pieces stubbed out.
//
// K3 replaces the TPU kernel `_proposal_kernel` (kernel A of
// nerf_emitter_tpu/ops/mega_query.py:205-238, launched at :711). The
// per-ray math is emitter_query.cuh `proposal_group`, written (s2+1, N).
//
// P2 replaces the profiling kernel of scripts/profile_kernel_a.py
// (`make_variant_kernel` :46-88, launched at :148): the same kernel as a
// compile-time mode. kFull is K3's own instantiation; kDensOnly replaces
// each resample by uniform bins i/s; kResampleOnly replaces each density
// pass by 0.3 x the far bin edge of each sample. The split of K3's time
// between its MLPs and its resamples is what the modes measure.
//
// Bound on an H100: operations. The two density MLPs are 3.6k and 5.1k MACs
// per sample over s0 + s1 = 352 samples per ray (0.19 ms of bf16 tensor-core
// time at 2^16 rays) against 32 bytes in and 196 bytes out per ray; the
// kResampleOnly mode runs no MLP and is bound by its bytes.
//
// Design: one block of 8 warps per 8 rays, the rays' bins, densities and
// CDFs in shared memory. The density passes run the block-wide wmma MLP
// over 64-sample tiles of the block's samples (f-major encoding rows, first-
// layer weight rows permuted on the host). The resample is one thread per
// ray: a merge walk of the u grid against the CDF.
#include "emitter_query.cuh"

using namespace nek;

constexpr int RAYS = 8;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
proposal_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ near, const float* __restrict__ far, long long n,
                Mlp mlp0, Mlp mlp1, Box bx, int F0, int F1, int s0, int s1, int s2, int ld,
                float* __restrict__ sbins_out) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int smax = max(s0, max(s1, s2));
    ProposalSmem p = carve_proposal(smem, ld, 1, smax, RAYS);
    const long long r0 = (long long)blockIdx.x * RAYS;
    const int n_rays = (int)min((long long)RAYS, n - r0);
    proposal_group<MODE>(p, o, d, near, far, n, r0, n_rays, mlp0, mlp1, bx, F0, F1, s0, s1, s2,
                         smax, ld);
    const int t = threadIdx.x;
    if (t < n_rays) {
        const float* out = p.sb_a + t * (smax + 1);
        for (int i = 0; i <= s2; ++i) sbins_out[(long long)i * n + r0 + t] = out[i];
    }
}

template <int MODE>
static int launch(const float* o, const float* d, const float* near, const float* far,
                  long long n, const int* dims0, const long long* ptrs0, const int* dims1,
                  const long long* ptrs1, const float* box, int F0, int F1, int s0, int s1, int s2,
                  int ld, float* sbins_out, void* stream) {
    Mlp mlp0 = make_mlp(dims0, ptrs0), mlp1 = make_mlp(dims1, ptrs1);
    if (last_width(mlp0) != 1 || last_width(mlp1) != 1 || s0 < 2 || s1 < 2 || s2 < 1)
        return (int)cudaErrorInvalidValue;
    const int smax = s0 > s1 ? (s0 > s2 ? s0 : s2) : (s1 > s2 ? s1 : s2);
    const size_t smem = proposal_smem_bytes(ld, 1, smax, RAYS);
    cudaError_t e = cudaFuncSetAttribute(proposal_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n + RAYS - 1) / RAYS;
    if (blocks > 0)
        proposal_kernel<MODE><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            o, d, near, far, n, mlp0, mlp1, make_box(box), F0, F1, s0, s1, s2, ld, sbins_out);
    return (int)cudaGetLastError();
}

NEK_ERROR_STRING_FN

extern "C" int nek_proposal(const float* o, const float* d, const float* near, const float* far,
                            long long n, const int* dims0, const long long* ptrs0,
                            const int* dims1, const long long* ptrs1, const float* box, int F0,
                            int F1, int s0, int s1, int s2, int ld, float* sbins_out,
                            void* stream) {
    return launch<kFull>(o, d, near, far, n, dims0, ptrs0, dims1, ptrs1, box, F0, F1, s0, s1, s2,
                         ld, sbins_out, stream);
}

// mode: 0 full (K3's instantiation), 1 dens-only, 2 resample-only
extern "C" int nek_proposal_variant(int mode, const float* o, const float* d, const float* near,
                                    const float* far, long long n, const int* dims0,
                                    const long long* ptrs0, const int* dims1,
                                    const long long* ptrs1, const float* box, int F0, int F1,
                                    int s0, int s1, int s2, int ld, float* sbins_out,
                                    void* stream) {
    switch (mode) {
        case kFull:
            return launch<kFull>(o, d, near, far, n, dims0, ptrs0, dims1, ptrs1, box, F0, F1, s0,
                                 s1, s2, ld, sbins_out, stream);
        case kDensOnly:
            return launch<kDensOnly>(o, d, near, far, n, dims0, ptrs0, dims1, ptrs1, box, F0, F1,
                                     s0, s1, s2, ld, sbins_out, stream);
        case kResampleOnly:
            return launch<kResampleOnly>(o, d, near, far, n, dims0, ptrs0, dims1, ptrs1, box, F0,
                                         F1, s0, s1, s2, ld, sbins_out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
