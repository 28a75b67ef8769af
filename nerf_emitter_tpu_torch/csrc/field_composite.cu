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
// 228 bytes of I/O per ray.
//
// The per-group body is emitter_query.cuh `field_group` and
// `composite_ray`, which K5 runs on its own bins.
//
// Design: one block of 8 warps owns 4 whole rays (192 samples), so the
// composite needs no second pass. The samples run through the block-wide
// wmma MLP in 64-sample tiles (two 64 x 264 bf16 activation buffers in
// shared memory, weights read as fragments from L1/L2); per-sample density
// and colour stay in shared memory; one thread per ray composites.
#include "emitter_query.cuh"

using namespace nek;

constexpr int RAYS = 4;

static size_t composite_smem_bytes(int ld, int s2) {
    return mlp_smem_bytes(ld, 16) + sizeof(float) * RAYS * ((s2 + 1) + 4 * s2 + 6);
}

__global__ void __launch_bounds__(THREADS)
field_composite_kernel(const float* __restrict__ sbins, const float* __restrict__ o,
                       const float* __restrict__ d, const float* __restrict__ near,
                       const float* __restrict__ far, const float* __restrict__ emb, int n_emb,
                       long long n, Mlp base, Mlp head, Box bx, int F, int s2, int ld, int hdr,
                       float rgb_bias, float* __restrict__ rgb_out, float* __restrict__ aux_out) {
    extern __shared__ __align__(128) unsigned char smem[];
    MlpSmem s = carve_mlp_smem(smem, ld, 16);
    float* eb = s.scratch + WARPS * 256;   // RAYS x (s2 + 1)
    float* dens = eb + RAYS * (s2 + 1);    // RAYS x s2
    float* rgb = dens + RAYS * s2;         // RAYS x s2 x 3
    float* ray = rgb + RAYS * s2 * 3;      // RAYS x 6: o, d
    const long long r0 = (long long)blockIdx.x * RAYS;
    const int n_rays = (int)min((long long)RAYS, n - r0);
    const int t = threadIdx.x;
    if (t < n_rays) {
        const long long g = r0 + t;
        for (int k = 0; k < 3; ++k) {
            ray[t * 6 + k] = o[k * n + g];
            ray[t * 6 + 3 + k] = d[k * n + g];
        }
        euclid_bins(eb + t * (s2 + 1), sbins + g, n, s2, spacing_pw(near[g]), spacing_pw(far[g]));
    }
    __syncthreads();
    field_group<false>(s, eb, ray, 6, dens, rgb, n_rays, base, head, bx, emb, n_emb, F, s2, ld, hdr,
                rgb_bias, 1);
    if (t < n_rays)
        composite_ray(eb + t * (s2 + 1), dens + t * s2, rgb + t * s2 * 3, s2, n, r0 + t, rgb_out,
                      aux_out);
}

NEK_ERROR_STRING_FN

extern "C" int nek_field_composite(const float* sbins, const float* o, const float* d,
                                   const float* near, const float* far, const float* emb,
                                   int n_emb, long long n, const int* base_dims,
                                   const long long* base_ptrs, const int* head_dims,
                                   const long long* head_ptrs, const float* box, int F, int s2,
                                   int ld, int hdr, float rgb_bias, float* rgb_out, float* aux_out,
                                   void* stream) {
    Mlp base = make_mlp(base_dims, base_ptrs), head = make_mlp(head_dims, head_ptrs);
    if (last_width(base) != 16 || last_width(head) != 3 || head.k[0] < 31 + n_emb || s2 < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = composite_smem_bytes(ld, s2);
    cudaError_t e = cudaFuncSetAttribute(field_composite_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n + RAYS - 1) / RAYS;
    if (blocks > 0)
        field_composite_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            sbins, o, d, near, far, emb, n_emb, n, base, head, make_box(box), F, s2, ld, hdr,
            rgb_bias, rgb_out, aux_out);
    return (int)cudaGetLastError();
}
