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
// Design: a persistent kernel, two blocks of 8 warps per SM. Each block
// loops over groups of 4 rays; for each group it runs
// emitter_query.cuh `proposal_group` (K3) into shared memory, converts the
// final spacing bins to euclidean bins in place, and runs `field_group` and
// `composite_ray` (K4) straight from them. The A/B overlap comes from the
// two co-resident blocks being in different stages. Shared memory: the MLP
// tile buffers at the field's row stride (2 x 64 x 264 bf16, 78 KB) serve
// both stages; the proposal state (bins, CDF, densities: 5 KB a ray) is
// reused by the field stage for its euclidean bins and densities, and only
// the per-sample colours (0.6 KB a ray) are added: about 100 KB a block.
//
// mxu_chunk: the base MLP's hidden layers of the field stage run as
// mxu_chunk block-wide passes over sample slices of each 64-sample tile,
// each closed by a barrier (common.cuh `run_mlp_sliced`; clamped to 4), as
// the TPU kernel splits the same layers into column (sample) slices. Every
// output element's sum is unchanged, so the answer is bit-identical for
// every value; only the schedule changes, and on the H100 each value above
// 1 only adds barriers and time. K3, K4 and the proposal stage here run
// the unsliced `run_mlp`.
//
// Bit equality with K3 + K4: every f32 step comes from the same device
// functions, and per-sample MLP rows do not depend on which samples share
// a tile, so the bins equal K3's and the answer equals K4's on them.
//
// Bound on an H100: operations, the sum of K3's and K4's MLP work (0.19 +
// 1.85 ms of bf16 tensor-core time at 2^16 rays), against 32 bytes in and
// 12 bytes out per ray.
#include "emitter_query.cuh"

using namespace nek;

constexpr int GROUP = 4;          // rays per group
constexpr int BLOCKS_PER_SM = 2;

static int smax_of(int s0, int s1, int s2) {
    return s0 > s1 ? (s0 > s2 ? s0 : s2) : (s1 > s2 ? s1 : s2);
}

static size_t mega_smem_bytes(int ld, int smax, int s2) {
    return proposal_smem_bytes(ld, 16, smax, GROUP) + sizeof(float) * GROUP * s2 * 3;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
mega_pipeline_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ near, const float* __restrict__ far,
                     const float* __restrict__ emb, int n_emb, long long n, Mlp mlp0, Mlp mlp1,
                     Mlp base, Mlp head, Box bx, int F0, int F1, int Ff, int s0, int s1, int s2,
                     int ld, int hdr, float rgb_bias, int mxu_chunk, float* __restrict__ rgb_out,
                     float* __restrict__ aux_out) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int smax = max(s0, max(s1, s2)), row = smax + 1;
    ProposalSmem p = carve_proposal(smem, ld, 16, smax, GROUP);
    float* rgb = p.end;  // GROUP x s2 x 3
    const int t = threadIdx.x;
    const long long groups = (n + GROUP - 1) / GROUP;
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
        const long long r0 = g * GROUP;
        const int n_rays = (int)min((long long)GROUP, n - r0);
        proposal_group<kFull>(p, o, d, near, far, n, r0, n_rays, mlp0, mlp1, bx, F0, F1, s0, s1,
                              s2, smax, ld);
        // B's euclidean bins (row stride s2+1) over A's, which are dead
        if (t < n_rays)
            euclid_bins(p.eb + t * (s2 + 1), p.sb_a + t * row, 1, s2, p.ray[t * 8 + 6],
                        p.ray[t * 8 + 7]);
        __syncthreads();
        field_group<true>(p.mlp, p.eb, p.ray, 8, p.dens, rgb, n_rays, base, head, bx, emb, n_emb,
                          Ff, s2, ld, hdr, rgb_bias, mxu_chunk);
        if (t < n_rays)
            composite_ray(p.eb + t * (s2 + 1), p.dens + t * s2, rgb + t * s2 * 3, s2, n, r0 + t,
                          rgb_out, aux_out);
        __syncthreads();  // the next group overwrites the rays' state
    }
}

NEK_ERROR_STRING_FN

// Blocks of the kernel that fit on one SM at these sizes, and the SM count.
// Asked of the runtime once per (device, shared memory size): the launcher
// calls it on every query.
extern "C" int nek_mega_pipeline_occupancy(int ld, int s0, int s1, int s2, int* blocks_per_sm,
                                           int* sms) {
    static int cached_dev = -1, cached_per_sm = 0, cached_sms = 0;
    static size_t cached_smem = 0;
    const size_t smem = mega_smem_bytes(ld, smax_of(s0, s1, s2), s2);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev != cached_dev || smem != cached_smem) {
        e = cudaFuncSetAttribute(mega_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        e = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_per_sm, mega_pipeline_kernel,
                                                          THREADS, smem);
        if (e != cudaSuccess) return (int)e;
        cached_dev = dev;
        cached_smem = smem;
    }
    *blocks_per_sm = cached_per_sm;
    *sms = cached_sms;
    return (int)cudaSuccess;
}

extern "C" int nek_mega_pipeline(const float* o, const float* d, const float* near,
                                 const float* far, const float* emb, int n_emb, long long n,
                                 const int* dims0, const long long* ptrs0, const int* dims1,
                                 const long long* ptrs1, const int* base_dims,
                                 const long long* base_ptrs, const int* head_dims,
                                 const long long* head_ptrs, const float* box, int F0, int F1,
                                 int Ff, int s0, int s1, int s2, int ld, int hdr, float rgb_bias,
                                 int mxu_chunk, float* rgb_out, float* aux_out, void* stream) {
    Mlp mlp0 = make_mlp(dims0, ptrs0), mlp1 = make_mlp(dims1, ptrs1);
    Mlp base = make_mlp(base_dims, base_ptrs), head = make_mlp(head_dims, head_ptrs);
    if (last_width(mlp0) != 1 || last_width(mlp1) != 1 || last_width(base) != 16 ||
        last_width(head) != 3 || head.k[0] < 31 + n_emb || s0 < 2 || s1 < 2 || s2 < 1 ||
        mxu_chunk < 1)
        return (int)cudaErrorInvalidValue;
    int per_sm = 0, sms = 0;
    int e = nek_mega_pipeline_occupancy(ld, s0, s1, s2, &per_sm, &sms);
    if (e != (int)cudaSuccess) return e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long groups = (n + GROUP - 1) / GROUP;
    const long long resident = (long long)per_sm * sms;
    const long long blocks = groups < resident ? groups : resident;
    if (blocks > 0)
        mega_pipeline_kernel<<<(unsigned)blocks, THREADS,
                               mega_smem_bytes(ld, smax_of(s0, s1, s2), s2),
                               (cudaStream_t)stream>>>(
            o, d, near, far, emb, n_emb, n, mlp0, mlp1, base, head, make_box(box), F0, F1, Ff, s0,
            s1, s2, ld, hdr, rgb_bias, mxu_chunk, rgb_out, aux_out);
    return (int)cudaGetLastError();
}
