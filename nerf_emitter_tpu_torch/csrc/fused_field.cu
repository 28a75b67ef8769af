// K2: fused radiance field.
//
// Replaces the TPU kernel `_field_kernel` of `fused_field`
// (nerf_emitter_tpu/ops/fused_field.py:306-413): positions and unit
// directions (3, M) and one appearance vector (E,) -> density (M,) and rgb
// (3, M). K1's front end with F=10, the base MLP 63 -> 256 x5 -> 16 (the
// 16-wide output as a bf16 product), then [SH4(dir) 16, geo 15, emb E] ->
// 64 -> 64 -> 3 (an f32 reduce), and exp(min(raw + rgb_bias, 88)) (HDR) or
// sigmoid.
//
// Bound on an H100: operations. 290k MACs per sample against 40 bytes of
// I/O; 0.58 TFLOP per 2^16 x 48 samples, 1.85 ms at the bf16 tensor-core
// peak.
//
// Design: one block of 8 warps per 64 samples; activations stay in shared
// memory as bf16 rows (two 64 x 264 buffers), each layer runs as wmma bf16
// tiles with f32 accumulation, weights are read as fragments from L1/L2.
// Only positions, directions, densities and colours touch device memory.
#include "common.cuh"

using namespace nek;

__global__ void __launch_bounds__(THREADS)
field_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
             const float* __restrict__ emb, int n_emb, long long m, Mlp base, Mlp head, Box bx,
             int F, int ld, int hdr, float rgb_bias, float* __restrict__ dens,
             float* __restrict__ rgb) {
    extern __shared__ __align__(128) unsigned char smem[];
    MlpSmem s = carve_mlp_smem(smem, ld, 16);
    __shared__ bool keep[TILE];
    __shared__ float geo[TILE][16];
    const long long g0 = (long long)blockIdx.x * TILE;
    const int t = threadIdx.x;
    const long long g = g0 + t;
    const bool valid = t < TILE && g < m;
    if (t < TILE) {
        float p[3] = {0.0f, 0.0f, 0.0f}, x2[3];
        if (valid)
            for (int k = 0; k < 3; ++k) p[k] = pos[k * m + g];
        keep[t] = contract_and_select(bx, p, x2) && valid;
        freq_encode(s.a + (size_t)t * ld, x2, F, false, base.k[0]);
    }
    run_mlp(base, s, ld);  // s.out: (TILE, 16) = [raw density, geo 15]
    if (t < TILE) {
        for (int j = 0; j < 16; ++j) geo[t][j] = s.out[t * 16 + j];
        if (valid) dens[g] = density_of(geo[t][0], keep[t], bx.avg_density);
        float d[3] = {0.0f, 0.0f, 1.0f}, sh[16];
        if (valid)
            for (int k = 0; k < 3; ++k) d[k] = dirs[k * m + g];
        sh4(d[0], d[1], d[2], sh);
        bf16* row = s.a + (size_t)t * ld;
        for (int j = 0; j < 16; ++j) row[j] = __float2bfloat16(sh[j]);
        for (int j = 1; j < 16; ++j) row[15 + j] = __float2bfloat16(geo[t][j]);
        for (int j = 0; j < n_emb; ++j) row[31 + j] = __float2bfloat16(emb[j]);
        for (int j = 31 + n_emb; j < head.k[0]; ++j) row[j] = __float2bfloat16(0.0f);
    }
    run_mlp(head, s, ld);  // s.out: (TILE, 3)
    if (valid)
        for (int k = 0; k < 3; ++k) rgb[k * m + g] = rgb_of(s.out[t * 3 + k], hdr, rgb_bias);
}

NEK_ERROR_STRING_FN

extern "C" int nek_fused_field(const float* pos, const float* dirs, const float* emb, int n_emb,
                               long long m, const int* base_dims, const long long* base_ptrs,
                               const int* head_dims, const long long* head_ptrs, const float* box,
                               int F, int ld, int hdr, float rgb_bias, float* dens, float* rgb,
                               void* stream) {
    Mlp base = make_mlp(base_dims, base_ptrs), head = make_mlp(head_dims, head_ptrs);
    if (last_width(base) != 16 || last_width(head) != 3 || head.k[0] < 31 + n_emb)
        return (int)cudaErrorInvalidValue;
    const size_t smem = mlp_smem_bytes(ld, 16);
    cudaError_t e = cudaFuncSetAttribute(field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (m + TILE - 1) / TILE;
    if (blocks > 0)
        field_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            pos, dirs, emb, n_emb, m, base, head, make_box(box), F, ld, hdr, rgb_bias, dens, rgb);
    return (int)cudaGetLastError();
}
