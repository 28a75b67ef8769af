// K1: fused proposal density.
//
// Replaces the TPU kernel `_density_kernel` of `fused_density`
// (nerf_emitter_tpu/ops/fused_field.py:183-250): world positions (3, M) ->
// density (M,) = avg * exp(min(raw - 1, 88)), zeroed outside the scene box
// and inside the carve-out box, with raw from the proposal MLP
// (3+6F -> 128 -> 1) on the k-major frequency encoding.
//
// Bound on an H100: operations. Per sample the MLP does (3+6F) x 128 + 128
// MACs, 3.6k (F=4) or 5.1k (F=6), against 16 bytes of I/O, far above the
// card's ~295 operations per byte; at 2^16 x 256 samples that is 0.12 ms of
// bf16 tensor-core time.
//
// Design: one block of 8 warps per 64 samples. Each thread of the first 64
// encodes one sample into a bf16 row of shared memory; the hidden layer runs
// as wmma bf16 tiles with f32 accumulation (weights read as fragments from
// L1/L2); the 128 -> 1 output is an f32 reduce per sample. Nothing but the
// positions and the densities touches device memory.
#include "common.cuh"

using namespace nek;

__global__ void __launch_bounds__(THREADS)
density_kernel(const float* __restrict__ pos, long long m, Mlp mlp, Box bx, int F, int ld,
               float* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem[];
    MlpSmem s = carve_mlp_smem(smem, ld, 1);
    __shared__ bool keep[TILE];
    const long long base = (long long)blockIdx.x * TILE;
    const int t = threadIdx.x;
    if (t < TILE) {
        const long long g = base + t;
        float p[3] = {0.0f, 0.0f, 0.0f}, x2[3];
        if (g < m)
            for (int k = 0; k < 3; ++k) p[k] = pos[k * m + g];
        keep[t] = contract_and_select(bx, p, x2) && g < m;
        freq_encode(s.a + (size_t)t * ld, x2, F, false, mlp.k[0]);
    }
    run_mlp(mlp, s, ld);
    if (t < TILE && base + t < m) out[base + t] = density_of(s.out[t], keep[t], bx.avg_density);
}

NEK_ERROR_STRING_FN

extern "C" int nek_fused_density(const float* pos, long long m, const int* dims,
                                 const long long* ptrs, const float* box, int F, int ld,
                                 float* out, void* stream) {
    Mlp mlp = make_mlp(dims, ptrs);
    if (last_width(mlp) != 1) return (int)cudaErrorInvalidValue;
    const size_t smem = mlp_smem_bytes(ld, 1);
    cudaError_t e = cudaFuncSetAttribute(density_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (m + TILE - 1) / TILE;
    if (blocks > 0)
        density_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            pos, m, mlp, make_box(box), F, ld, out);
    return (int)cudaGetLastError();
}
