// K5: the whole emitter query in one launch: both proposal levels (K3's
// code) and the field and composite (K4's code) per ray group, the bins
// never leaving shared memory.
//
// Replaces the TPU kernel `_mega_pipeline_kernel`
// (nerf_emitter_tpu/ops/mega_query.py:318-554, launched at :677), the JAX
// package's default query. On the TPU the grid runs in order on one core,
// so that kernel interleaves A (tile i) with B (tile i-1) through a VMEM
// scratch to keep its vector unit busy behind the matrix unit. On the card
// blocks run in parallel and nothing carries between them.
//
// Design: a persistent kernel, one block of two warpgroups per SM, looping
// over groups of 8 rays. For each group it runs emitter_query.cuh
// `proposal_group` (K3's body: density_mlp.cuh's wgmma block, a warp per
// ray) into shared memory, converts the final spacing bins to euclidean
// bins, and runs `field_group` and `composite_ray` (K4: the wgmma field of
// field_mlp.cuh) straight from them. The field's weight ring is filled
// once at the start and runs on across groups, so the first chunks of a
// group's field stage arrive while its proposal stage runs. Shared memory
// at the sdf-nerfacto widths and samples (256, 96, 48), 228,816 bytes: the
// ring (3 x 32 KB); the two field slabs (64 KB), where the proposal
// stage's two packs (36 KB) sit between field stages: they are copied in
// again for every group, the copy starting as the previous group's field
// stage ends; the density block's slabs, keep flags and mbarrier (16.5
// KB, zeroed once: the field never touches them); the field rows' keep
// flags and raw densities; the proposal state of 8 rays (bins, CDF,
// densities: 41 KB; the field stage reuses its euclidean bins and
// densities) and the per-sample colours (4.6 KB).
//
// mxu_chunk: the TPU kernel's column (sample) slices of the field's hidden
// matmuls have no counterpart here: a wgmma pass is 128 samples whatever
// the value, so the launcher does not take it and the answer is the same
// for every value.
//
// Bit equality with K3 + K4: every f32 step comes from the same device
// functions, and per-sample MLP rows do not depend on which samples share
// a tile or a pass (K4 and K5 also use the same 8-ray groups), so the bins
// equal K3's and the answer equals K4's on them.
//
// Bound on an H100: operations, the sum of K3's and K4's MLP work (0.19 +
// 1.85 ms of bf16 tensor-core time at 2^16 rays), against 32 bytes in and
// 12 bytes out per ray.
#include "emitter_query.cuh"

using namespace nek;

constexpr int GROUP = GROUP_RAYS;  // rays per group
// the field stage's slabs' region: the two field slabs (which the packs
// share), then the density block's work area
constexpr int SLAB_REGION = 2 * SLAB_BYTES + DENSITY_WORK;
static_assert(2 * DENSITY_PACK_SPAN <= 2 * SLAB_BYTES, "the packs fit the field's slabs");

static int smax_of(int s0, int s1, int s2) {
    return s0 > s1 ? (s0 > s2 ? s0 : s2) : (s1 > s2 ? s1 : s2);
}

static size_t mega_smem_bytes(int smax, int s2) {
    return field_smem_bytes(SLAB_REGION) + proposal_state_bytes(smax, GROUP) + sizeof(float) * GROUP * s2 * 3;
}

__global__ void __launch_bounds__(THREADS, 1)
mega_pipeline_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ near, const float* __restrict__ far,
                     const float* __restrict__ emb, int n_emb, long long n,
                     const unsigned char* __restrict__ pack0, const unsigned char* __restrict__ pack1,
                     const __grid_constant__ FieldMlp fm,
                     const __grid_constant__ Box bx, int F0, int F1, int Ff, int s0,
                     int s1, int s2, int hdr, float rgb_bias, float* __restrict__ rgb_out,
                     float* __restrict__ aux_out) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const int smax = max(s0, max(s1, s2)), row = smax + 1;
    const FieldSmem fs = carve_field(smem);
    const ProposalDensity pd = proposal_density(fs.slab(0), fs.slab(0) + 2 * SLAB_BYTES);
    const ProposalSmem p = carve_proposal(reinterpret_cast<float*>(smem + field_smem_bytes(SLAB_REGION)), smax,
                                          GROUP);
    float* rgb = p.end;  // GROUP x s2 x 3
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const long long groups = (n + GROUP - 1) / GROUP;
    density_init(pd.level[0]);
    if (t == 0) load_proposal_packs(pd, pack0, pack1);
    Ring ring = ring_start(fs, fm, fm.n_chunks,
                           ring_total(blockIdx.x, gridDim.x, groups, n, GROUP, s2, fm.n_chunks));
    int parity = 0;  // of the packs' copy for this group
    for (long long g = blockIdx.x; g < groups; g += gridDim.x, parity ^= 1) {
        const long long r0 = g * GROUP;
        const int n_rays = (int)min((long long)GROUP, n - r0);
        proposal_group<kFull>(p, pd, parity, o, d, near, far, n, r0, n_rays, bx, F0, F1, s0, s1, s2, smax);
        // B's euclidean bins (row stride s2+1) over A's, which are dead
        if (warp < n_rays)
            euclid_bins(p.eb + warp * (s2 + 1), p.sb_a + warp * row, 1, s2, p.ray[warp * 8 + 6],
                        p.ray[warp * 8 + 7], lane, 32);
        __syncthreads();
        field_group(ring, fm, fs, p.eb, p.ray, 8, p.dens, rgb, n_rays, bx, emb, n_emb, Ff, s2, hdr,
                    rgb_bias);
        // the field is done with its slabs: the next group's packs go there
        if (t == 0 && g + gridDim.x < groups) {
            fence_proxy_async();
            load_proposal_packs(pd, pack0, pack1);
        }
        if (t < n_rays)
            composite_ray(p.eb + t * (s2 + 1), p.dens + t * s2, rgb + t * s2 * 3, s2, n, r0 + t,
                          rgb_out, aux_out);
        __syncthreads();  // the next group overwrites the rays' state
    }
}

NEK_ERROR_STRING_FN

static Occupancy occ;

// Blocks of the kernel that fit on one SM at these sizes, the SM count and
// the kernel's dynamic shared memory.
extern "C" int nek_mega_pipeline_occupancy(int s0, int s1, int s2, int* blocks_per_sm, int* sms,
                                           long long* smem) {
    const size_t bytes = mega_smem_bytes(smax_of(s0, s1, s2), s2);
    const cudaError_t e = occupancy(mega_pipeline_kernel, bytes, &occ);
    *blocks_per_sm = occ.per_sm;
    *sms = occ.sms;
    *smem = (long long)bytes;
    return (int)e;
}

// pack0, pack1: kernels.DensityPack buffers of the two proposal MLPs
// (f-major first-layer rows, F0 and F1 octaves, 3 + 6F <= DENSITY_K)
extern "C" int nek_mega_pipeline(const float* o, const float* d, const float* near,
                                 const float* far, const float* emb, int n_emb, long long n,
                                 const void* pack0, const void* pack1, const int* field_dims,
                                 const long long* field_ptrs, const float* box, int F0, int F1,
                                 int Ff, int s0, int s1, int s2, int hdr, float rgb_bias,
                                 float* rgb_out, float* aux_out, void* stream) {
    FieldMlp fm;
    if (!make_field_mlp(field_dims, field_ptrs, &fm) || fm.n_last != 3 || fm.layer[fm.n_base].k < 31 + n_emb ||
        s0 < 2 || s1 < 2 || s2 < 1 || F0 < 0 || F1 < 0 || 3 + 6 * F0 > DENSITY_K || 3 + 6 * F1 > DENSITY_K ||
        ((reinterpret_cast<uintptr_t>(pack0) | reinterpret_cast<uintptr_t>(pack1)) & 15))
        return (int)cudaErrorInvalidValue;
    const size_t smem = mega_smem_bytes(smax_of(s0, s1, s2), s2);
    cudaError_t e = occupancy(mega_pipeline_kernel, smem, &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long groups = (n + GROUP - 1) / GROUP;
    const long long resident = (long long)occ.per_sm * occ.sms;
    const long long blocks = groups < resident ? groups : resident;
    if (blocks > 0)
        mega_pipeline_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            o, d, near, far, emb, n_emb, n, reinterpret_cast<const unsigned char*>(pack0),
            reinterpret_cast<const unsigned char*>(pack1), fm, make_box(box), F0, F1, Ff, s0, s1, s2, hdr,
            rgb_bias, rgb_out, aux_out);
    return (int)cudaGetLastError();
}
