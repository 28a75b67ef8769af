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
// Design: one block of 8 warps owns 4 whole rays (192 samples), so the
// composite needs no second pass. The samples run through the block-wide
// wmma MLP in 64-sample tiles (two 64 x 264 bf16 activation buffers in
// shared memory, weights read as fragments from L1/L2); per-sample density
// and colour stay in shared memory; one thread per ray composites.
#include "common.cuh"

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
        const float sn = spacing_pw(near[g]), sf = spacing_pw(far[g]);
        for (int i = 0; i <= s2; ++i)
            eb[t * (s2 + 1) + i] = spacing_pw_inv(sbins[(long long)i * n + g] * (sf - sn) + sn);
    }
    __syncthreads();
    const int total = n_rays * s2;
    for (int c0 = 0; c0 < total; c0 += TILE) {
        const int j = c0 + t;
        const bool valid = t < TILE && j < total;
        const int r = valid ? j / s2 : 0, si = valid ? j % s2 : 0;
        bool keep = false;
        if (t < TILE) {
            float p[3] = {0.0f, 0.0f, 0.0f}, x2[3];
            if (valid) {
                const float mid = (eb[r * (s2 + 1) + si] + eb[r * (s2 + 1) + si + 1]) / 2.0f;
                for (int k = 0; k < 3; ++k) p[k] = ray[r * 6 + k] + ray[r * 6 + 3 + k] * mid;
            }
            keep = contract_and_select(bx, p, x2) && valid;
            freq_encode(s.a + (size_t)t * ld, x2, F, true, base.k[0]);
        }
        run_mlp(base, s, ld);  // s.out: (TILE, 16)
        if (t < TILE) {
            if (valid) dens[j] = density_of(s.out[t * 16], keep, bx.avg_density);
            float sh[16];
            const float* dr = ray + r * 6 + 3;
            sh4(dr[0], dr[1], dr[2], sh);
            bf16* row = s.a + (size_t)t * ld;
            for (int q = 0; q < 16; ++q) row[q] = __float2bfloat16(sh[q]);
            for (int q = 1; q < 16; ++q) row[15 + q] = __float2bfloat16(s.out[t * 16 + q]);
            for (int q = 0; q < n_emb; ++q) row[31 + q] = __float2bfloat16(emb[q]);
            for (int q = 31 + n_emb; q < head.k[0]; ++q) row[q] = __float2bfloat16(0.0f);
        }
        run_mlp(head, s, ld);  // s.out: (TILE, 3)
        if (valid)
            for (int k = 0; k < 3; ++k) rgb[j * 3 + k] = rgb_of(s.out[t * 3 + k], hdr, rgb_bias);
        __syncthreads();
    }
    if (t < n_rays) {
        const float* e = eb + t * (s2 + 1);
        float excl = 0.0f, acc = 0.0f, comp[3] = {0.0f, 0.0f, 0.0f};
        for (int si = 0; si < s2; ++si) {
            const float dd = dens[t * s2 + si] * (e[si + 1] - e[si]);
            const float w = (1.0f - expf(-dd)) * expf(-excl);
            excl += dd;
            acc += w;
            for (int k = 0; k < 3; ++k) comp[k] += w * rgb[(t * s2 + si) * 3 + k];
        }
        const float* bg = rgb + (t * s2 + s2 - 1) * 3;
        for (int k = 0; k < 3; ++k) rgb_out[k * n + r0 + t] = comp[k] + bg[k] * (1.0f - acc);
        if (aux_out) {
            aux_out[r0 + t] = acc;
            for (int k = 0; k < 3; ++k) aux_out[(k + 1) * n + r0 + t] = bg[k];
        }
    }
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
