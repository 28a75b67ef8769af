// K4: radiance field and compositing of the emitter query.
//
// Replaces the TPU kernel `_field_composite_kernel` (kernel B of
// nerf_emitter_tpu/ops/mega_query.py:246-293, launched at :731). Per ray:
// spacing bins (s2+1) -> euclidean bins -> s2 midpoint positions; K2's field
// math on the f-major encoding (first-layer rows permuted on the host); the
// weights alpha * exp(-exclusive cumsum); rgb = sum(w rgb) + rgb_last (1 - acc)
// (the last-sample HDR background), written (3, N). With a non-null aux_out
// it also writes acc and rgb_last (4, N), from which a caller splits the
// answer into its foreground sum(w rgb) and its background term.
//
// Bound on an H100: operations. 290k MACs per sample, s2 = 48 samples per
// ray: 0.58 TFLOP at 2^16 rays, 1.85 ms of bf16 tensor-core time, against
// 228 bytes of I/O per ray. The design's own floor is the weight stream:
// every 128-sample pass moves the field's 581 KB of bf16 weights from L2
// into shared memory (14 GB per 2^16-ray query).
//
// Design: a persistent kernel, one block of two consumer warpgroups per SM
// (field_mlp.cuh: wgmma on 64-row warpgroup tiles, weights streamed through
// a 3-stage ring of 32 KB shared-memory stages that runs on across passes
// and ray groups). Each block loops over groups of 8 rays (384 samples, 3
// passes of 128); the per-group body is emitter_query.cuh `field_group`
// and `composite_ray`, which K5 runs on its own bins. Per-sample density
// and colour stay in shared memory; one thread per ray composites.
#include "emitter_query.cuh"

using namespace nek;

constexpr int RAYS = FIELD_RAYS;

static size_t composite_smem_bytes(int s2) {
    return field_smem_bytes(2 * SLAB_BYTES) + sizeof(float) * RAYS * ((s2 + 1) + 4 * s2 + 6);
}

__global__ void __launch_bounds__(THREADS, 1)
field_composite_kernel(const float* __restrict__ sbins, const float* __restrict__ o,
                       const float* __restrict__ d, const float* __restrict__ near,
                       const float* __restrict__ far, const float* __restrict__ emb, int n_emb,
                       long long n, const __grid_constant__ FieldMlp fm,
                       const __grid_constant__ Box bx, int F, int s2,
                       int hdr, float rgb_bias, float* __restrict__ rgb_out,
                       float* __restrict__ aux_out) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const FieldSmem fs = carve_field(smem);
    float* eb = reinterpret_cast<float*>(smem + field_smem_bytes(2 * SLAB_BYTES));  // RAYS x (s2 + 1)
    float* dens = eb + RAYS * (s2 + 1);              // RAYS x s2
    float* rgb = dens + RAYS * s2;                   // RAYS x s2 x 3
    float* ray = rgb + RAYS * s2 * 3;                // RAYS x 6: o, d
    const int t = threadIdx.x;
    const long long groups = (n + RAYS - 1) / RAYS;
    Ring ring = ring_start(fs, fm, fm.n_chunks,
                           ring_total(blockIdx.x, gridDim.x, groups, n, RAYS, s2, fm.n_chunks));
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
        const long long r0 = g * RAYS;
        const int n_rays = (int)min((long long)RAYS, n - r0);
        if (t < n_rays) {
            const long long gr = r0 + t;
            for (int k = 0; k < 3; ++k) {
                ray[t * 6 + k] = o[k * n + gr];
                ray[t * 6 + 3 + k] = d[k * n + gr];
            }
            euclid_bins(eb + t * (s2 + 1), sbins + gr, n, s2, spacing_pw(near[gr]), spacing_pw(far[gr]));
        }
        __syncthreads();
        field_group(ring, fm, fs, eb, ray, 6, dens, rgb, n_rays, bx, emb, n_emb, F, s2, hdr, rgb_bias);
        if (t < n_rays)
            composite_ray(eb + t * (s2 + 1), dens + t * s2, rgb + t * s2 * 3, s2, n, r0 + t, rgb_out,
                          aux_out);
        __syncthreads();  // the next group overwrites the rays' rows
    }
}

NEK_ERROR_STRING_FN

static Occupancy occ;

// Blocks per SM, SM count and dynamic shared memory of the kernel at s2.
extern "C" int nek_field_composite_occupancy(int s2, int* blocks_per_sm, int* sms, long long* smem) {
    const cudaError_t e = occupancy(field_composite_kernel, composite_smem_bytes(s2), &occ);
    *blocks_per_sm = occ.per_sm;
    *sms = occ.sms;
    *smem = (long long)composite_smem_bytes(s2);
    return (int)e;
}

extern "C" int nek_field_composite(const float* sbins, const float* o, const float* d,
                                   const float* near, const float* far, const float* emb,
                                   int n_emb, long long n, const int* field_dims,
                                   const long long* field_ptrs, const float* box, int F, int s2,
                                   int hdr, float rgb_bias, float* rgb_out, float* aux_out,
                                   void* stream) {
    FieldMlp fm;
    if (!make_field_mlp(field_dims, field_ptrs, &fm) || fm.n_last != 3 ||
        fm.layer[fm.n_base].k < 31 + n_emb || s2 < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = composite_smem_bytes(s2);
    cudaError_t e = occupancy(field_composite_kernel, smem, &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long groups = (n + RAYS - 1) / RAYS;
    const long long resident = (long long)occ.per_sm * occ.sms;
    const long long blocks = groups < resident ? groups : resident;
    if (blocks > 0)
        field_composite_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            sbins, o, d, near, far, emb, n_emb, n, fm, make_box(box), F, s2, hdr, rgb_bias, rgb_out,
            aux_out);
    return (int)cudaGetLastError();
}
