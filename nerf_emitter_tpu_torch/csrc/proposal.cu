// K3: both proposal levels of the emitter query -> final spacing bins; and
// P2, K3 with pieces stubbed out.
//
// K3 replaces the TPU kernel `_proposal_kernel` (kernel A of
// nerf_emitter_tpu/ops/mega_query.py:205-238, launched at :711). The
// per-group math is emitter_query.cuh `proposal_group`, written (s2+1, N).
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
// Design: a persistent kernel, two blocks of two warpgroups per SM, each
// block walking 8-ray groups (as K5 does). The block loads both levels'
// packed MLPs once (kernels.DensityPack, one bulk copy each) and keeps
// them; a level's densities run on density_mlp.cuh's wgmma block, 64 rows
// (sample midpoints) a warpgroup tile; the weights, CDF and inverse-CDF
// resample run one warp a ray (warp scans, a binary search per u). Shared
// memory at samples (256, 96, 48): the packs 36,864 bytes, the slabs, keep
// flags and mbarrier 16,912, the proposal state 41,344, with the alignment
// slack 96,144. Nothing but the rays and the bins touches device memory.
#include "emitter_query.cuh"

using namespace nek;

constexpr int GROUP = GROUP_RAYS;
// the two packs and the density block's work area, from the 1024-aligned
// base, with the alignment slack; the proposal state follows
constexpr int PROPOSAL_DENSITY = 1024 + 2 * DENSITY_PACK_SPAN + DENSITY_WORK;

static int smax_of(int s0, int s1, int s2) {
    return s0 > s1 ? (s0 > s2 ? s0 : s2) : (s1 > s2 ? s1 : s2);
}

static size_t proposal_smem_bytes(int smax) {
    return PROPOSAL_DENSITY + proposal_state_bytes(smax, GROUP);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
proposal_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ near, const float* __restrict__ far, long long n,
                const unsigned char* __restrict__ pack0, const unsigned char* __restrict__ pack1,
                const __grid_constant__ Box bx, int F0, int F1, int s0, int s1, int s2,
                float* __restrict__ sbins_out) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const int smax = max(s0, max(s1, s2)), row = smax + 1;
    unsigned char* base = align1024(smem);
    const ProposalDensity pd = proposal_density(base, base + 2 * DENSITY_PACK_SPAN);
    const ProposalSmem p = carve_proposal(reinterpret_cast<float*>(smem + PROPOSAL_DENSITY), smax, GROUP);
    density_init(pd.level[0]);
    if (threadIdx.x == 0) load_proposal_packs(pd, pack0, pack1);
    __syncthreads();
    const long long groups = (n + GROUP - 1) / GROUP;
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
        const long long r0 = g * GROUP;
        const int n_rays = (int)min((long long)GROUP, n - r0);
        proposal_group<MODE>(p, pd, 0, o, d, near, far, n, r0, n_rays, bx, F0, F1, s0, s1, s2, smax);
        for (int k = threadIdx.x; k < (s2 + 1) * n_rays; k += THREADS) {
            const int r = k % n_rays, i = k / n_rays;
            sbins_out[(long long)i * n + r0 + r] = p.sb_a[r * row + i];
        }
        __syncthreads();  // the next group overwrites the rays' state
    }
}

static Occupancy occ[3];  // per mode

template <int MODE>
static int launch(const float* o, const float* d, const float* near, const float* far, long long n,
                  const void* pack0, const void* pack1, const float* box, int F0, int F1, int s0,
                  int s1, int s2, float* sbins_out, void* stream) {
    if (s0 < 2 || s1 < 2 || s2 < 1 || F0 < 0 || F1 < 0 || 3 + 6 * F0 > DENSITY_K ||
        3 + 6 * F1 > DENSITY_K || ((reinterpret_cast<uintptr_t>(pack0) | reinterpret_cast<uintptr_t>(pack1)) & 15))
        return (int)cudaErrorInvalidValue;
    const size_t smem = proposal_smem_bytes(smax_of(s0, s1, s2));
    cudaError_t e = occupancy(proposal_kernel<MODE>, smem, &occ[MODE]);
    if (e != cudaSuccess) return (int)e;
    if (occ[MODE].per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long groups = (n + GROUP - 1) / GROUP;
    const long long resident = (long long)occ[MODE].per_sm * occ[MODE].sms;
    const long long blocks = groups < resident ? groups : resident;
    if (blocks > 0)
        proposal_kernel<MODE><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            o, d, near, far, n, reinterpret_cast<const unsigned char*>(pack0),
            reinterpret_cast<const unsigned char*>(pack1), make_box(box), F0, F1, s0, s1, s2, sbins_out);
    return (int)cudaGetLastError();
}

NEK_ERROR_STRING_FN

// Blocks of K3 resident per SM, the SM count and its dynamic shared memory
// at these sample counts, as its launcher sizes its persistent grid.
extern "C" int nek_proposal_occupancy(int s0, int s1, int s2, int* blocks_per_sm, int* sms,
                                      long long* smem) {
    const size_t bytes = proposal_smem_bytes(smax_of(s0, s1, s2));
    const cudaError_t e = occupancy(proposal_kernel<kFull>, bytes, &occ[kFull]);
    *blocks_per_sm = occ[kFull].per_sm;
    *sms = occ[kFull].sms;
    *smem = (long long)bytes;
    return (int)e;
}

// pack0, pack1: kernels.DensityPack buffers of the two proposal MLPs
// (f-major first-layer rows, F0 and F1 octaves, 3 + 6F <= DENSITY_K)
extern "C" int nek_proposal(const float* o, const float* d, const float* near, const float* far,
                            long long n, const void* pack0, const void* pack1, const float* box,
                            int F0, int F1, int s0, int s1, int s2, float* sbins_out, void* stream) {
    return launch<kFull>(o, d, near, far, n, pack0, pack1, box, F0, F1, s0, s1, s2, sbins_out, stream);
}

// mode: 0 full (K3's instantiation), 1 dens-only, 2 resample-only
extern "C" int nek_proposal_variant(int mode, const float* o, const float* d, const float* near,
                                    const float* far, long long n, const void* pack0,
                                    const void* pack1, const float* box, int F0, int F1, int s0,
                                    int s1, int s2, float* sbins_out, void* stream) {
    switch (mode) {
        case kFull:
            return launch<kFull>(o, d, near, far, n, pack0, pack1, box, F0, F1, s0, s1, s2, sbins_out,
                                 stream);
        case kDensOnly:
            return launch<kDensOnly>(o, d, near, far, n, pack0, pack1, box, F0, F1, s0, s1, s2,
                                     sbins_out, stream);
        case kResampleOnly:
            return launch<kResampleOnly>(o, d, near, far, n, pack0, pack1, box, F0, F1, s0, s1, s2,
                                         sbins_out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
