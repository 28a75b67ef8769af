// K1: fused proposal density.
//
// Replaces the TPU kernel `_density_kernel` of `fused_density`
// (nerf_emitter_tpu/ops/fused_field.py:183-250): world positions (3, M) ->
// density (M,) = avg * exp(min(raw - 1, 88)), zeroed outside the scene box
// and inside the carve-out box, with raw from the proposal MLP
// (3+6F -> 128 -> 1) on the frequency encoding. The kernel encodes
// f-major; the host permutes the first layer's rows to match
// (ops/fused_field.py `permute_first`).
//
// Bound on an H100: operations. Per sample the MLP does (3+6F) x 128 + 128
// MACs, 3.6k (F=4) or 5.1k (F=6), against 16 bytes of I/O, far above the
// card's ~295 operations per byte; at 2^16 x 256 plus 2^16 x 96 samples
// (the two levels) that is 0.19 ms of bf16 tensor-core time. The per-row
// encoding on the CUDA cores is the practical floor (density_mlp.cuh).
//
// Design: a persistent kernel of two consumer warpgroups per block, as
// many blocks per SM as registers and shared memory allow (~36 KB a
// block). The block loads the packed MLP once (density_mlp.cuh); each pass
// covers 128 rows, 64 per warpgroup, through `density_tile`: encode into
// the warpgroup's slab, four wgmma.m64n128k16, the register epilogue. A
// thread reads its row's position of the next pass before it runs this
// one. The keep mask comes from the f32 position, not from the encoding.
// Rows past M are encoded as zeros and write nothing. Nothing but the
// positions and the densities touches device memory.
#include "density_mlp.cuh"

using namespace nek;

// The rows of one tile: this thread's row's position, loaded ahead.
struct PositionsIo {
    const Box& bx;
    float* __restrict__ out;
    long long m, g0;  // rows; first row of the tile
    int F;
    float p[3];

    __device__ bool encode(unsigned char* slab, int row, int half) const {
        const long long g = g0 + row;
        if (g >= m) {
            for (int j = half; j < 3 + 6 * F; j += 2) st_bf16(slab, row, j, 0.0f);
            return false;
        }
        float x2[3];
        const bool keep = contract_and_select(bx, p, x2);
        encode_row(slab, row, half, x2, F, 3 + 6 * F);  // no padding: it stays zero
        return keep;
    }

    __device__ void density(int row, float raw, bool keep) const {
        const long long g = g0 + row;
        if (g < m) out[g] = density_of(raw, keep, bx.avg_density);
    }
};

__global__ void __launch_bounds__(THREADS, 2)
density_kernel(const float* __restrict__ pos, long long m, const unsigned char* __restrict__ pack,
               const __grid_constant__ Box bx, int F, float* __restrict__ out) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const DensitySmem ds = density_start(smem, pack);
    const int wg = threadIdx.x / 128, row = threadIdx.x % WG_ROWS;
    const long long passes = (m + PASS_ROWS - 1) / PASS_ROWS;
    // this thread's row's position in pass p, read ahead of its tile
    float next[3] = {0.0f, 0.0f, 0.0f};
    auto fetch = [&](long long p) {
        const long long g = p * PASS_ROWS + wg * WG_ROWS + row;
        if (p < passes && g < m)
            for (int k = 0; k < 3; ++k) next[k] = pos[k * m + g];
    };
    fetch(blockIdx.x);
    bool ready = false;
    for (long long p = blockIdx.x; p < passes; p += gridDim.x) {
        const PositionsIo io{bx, out, m, p * PASS_ROWS + wg * WG_ROWS, F, {next[0], next[1], next[2]}};
        fetch(p + gridDim.x);
        density_tile(ds, io, wg, ready);
    }
    density_done(ds, ready);
}

NEK_ERROR_STRING_FN

static Occupancy occ;

// Blocks per SM, SM count and dynamic shared memory of the kernel.
extern "C" int nek_fused_density_occupancy(int* blocks_per_sm, int* sms, long long* smem) {
    const cudaError_t e = occupancy(density_kernel, DENSITY_SMEM, &occ);
    *blocks_per_sm = occ.per_sm;
    *sms = occ.sms;
    *smem = DENSITY_SMEM;
    return (int)e;
}

// pack: kernels.DensityPack's buffer (DENSITY_PACK bytes); F: octaves of
// the encoding, 3 + 6F <= DENSITY_K.
extern "C" int nek_fused_density(const float* pos, long long m, const void* pack, const float* box,
                                 int F, float* out, void* stream) {
    if (F < 0 || 3 + 6 * F > DENSITY_K || (reinterpret_cast<uintptr_t>(pack) & 15))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = occupancy(density_kernel, DENSITY_SMEM, &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long passes = (m + PASS_ROWS - 1) / PASS_ROWS;
    const long long resident = (long long)occ.per_sm * occ.sms;
    const long long blocks = passes < resident ? passes : resident;
    if (blocks > 0)
        density_kernel<<<(unsigned)blocks, THREADS, DENSITY_SMEM, (cudaStream_t)stream>>>(
            pos, m, reinterpret_cast<const unsigned char*>(pack), make_box(box), F, out);
    return (int)cudaGetLastError();
}
