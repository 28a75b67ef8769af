// K2: fused radiance field.
//
// Replaces the TPU kernel `_field_kernel` of `fused_field`
// (nerf_emitter_tpu/ops/fused_field.py:306-413): positions and unit
// directions (3, M) and one appearance vector (E,) -> density (M,) and rgb
// (3, M). K1's front end with F=10, the base MLP 63 -> 256 x5 -> 16, then
// [SH4(dir) 16, geo 15, emb E] -> 64 -> 64 -> 3 (an f32 reduce), and
// exp(min(raw + rgb_bias, 88)) (HDR) or sigmoid. The kernel encodes
// f-major; the host permutes the base MLP's first-layer rows to match
// (ops/fused_field.py `permute_first`).
//
// Bound on an H100: operations. 290k MACs per sample against 40 bytes of
// I/O; 0.58 TFLOP per 2^16 x 48 samples, 1.85 ms at the bf16 tensor-core
// peak. The design's own floor is K4's: each 128-row pass streams the
// field's 581 KB of bf16 weights from L2 into shared memory.
//
// Design: the field MLP of K4 and K5 (field_mlp.cuh `wg_field_pass`: two
// consumer warpgroups of 64 rows, wgmma on swizzled shared-memory slabs,
// the weights through a 3-stage ring of bulk async copies) with K2's own
// rows: one sample per row, its own position and direction. A persistent
// kernel, one block per SM; each block walks the 128-row passes
// blockIdx.x, blockIdx.x + gridDim.x, ..., and its weight ring runs on
// across them. The keep mask comes from the f32 position. Rows past M are
// encoded as zeros and write nothing. Only positions, directions, densities
// and colours touch device memory.
#include "field_mlp.cuh"

using namespace nek;

// The rows of one pass: row r of warpgroup wg is sample r0 + 64 wg + r.
struct SampleIo {
    const FieldSmem fs;
    const Box& bx;
    const float* __restrict__ pos;
    const float* __restrict__ dirs;
    const float* __restrict__ emb;
    float* __restrict__ dens;
    float* __restrict__ rgb;
    long long m, r0;
    int F, n_emb, hdr;
    float rgb_bias;

    __device__ long long at(int wg, int row) const { return r0 + wg * WG_ROWS + row; }

    __device__ void encode(unsigned char* slab, int wg, int row, int half, int kpad) const {
        const long long g = at(wg, row);
        bool keep = false;
        if (g < m) {
            float p[3] = {pos[g], pos[m + g], pos[2 * m + g]}, x2[3];
            keep = contract_and_select(bx, p, x2);
            encode_row(slab, row, half, x2, F, kpad);
        } else {
            for (int j = half; j < kpad; j += 2) st_bf16(slab, row, j, 0.0f);
        }
        if (half == 0) fs.keep()[wg * WG_ROWS + row] = keep;
    }

    // the head input [SH of the row's own direction 16, geo 15 (written by
    // the base output), emb]
    __device__ void head_in(unsigned char* slab, int wg, int row, int half, int kpad) const {
        const long long g = at(wg, row);
        if (half == 0) {
            float sh[16];
            if (g < m)
                sh4(dirs[g], dirs[m + g], dirs[2 * m + g], sh);
            else
                for (int q = 0; q < 16; ++q) sh[q] = 0.0f;
            for (int q = 0; q < 16; ++q) st_bf16(slab, row, q, sh[q]);
        } else {
            for (int q = 0; q < n_emb; ++q) st_bf16(slab, row, 31 + q, emb[q]);
            for (int q = 31 + n_emb; q < kpad; ++q) st_bf16(slab, row, q, 0.0f);
        }
    }

    __device__ void density(int wg, int row, float raw) const {
        const long long g = at(wg, row);
        if (g < m) dens[g] = density_of(raw, fs.keep()[wg * WG_ROWS + row], bx.avg_density);
    }

    __device__ void colour(int wg, int row, int o, float raw) const {
        const long long g = at(wg, row);
        if (g < m) rgb[o * m + g] = rgb_of(raw, hdr, rgb_bias);
    }

    __device__ void base_value(int, int, int, float) const {}
    __device__ void dump(const unsigned char*, int, int, int, int, int) const {}
};

__global__ void __launch_bounds__(THREADS, 1)
field_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
             const float* __restrict__ emb, int n_emb, long long m, const __grid_constant__ FieldMlp fm,
             const __grid_constant__ Box bx, int F, int hdr, float rgb_bias,
             float* __restrict__ dens, float* __restrict__ rgb) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const FieldSmem fs = carve_field(smem);
    const long long passes = (m + PASS_ROWS - 1) / PASS_ROWS;
    const long long mine = (passes - blockIdx.x + gridDim.x - 1) / gridDim.x;
    Ring ring = ring_start(fs, fm, fm.n_chunks, (int)(mine * fm.n_chunks));
    for (long long p = blockIdx.x; p < passes; p += gridDim.x) {
        const SampleIo io{fs, bx, pos, dirs, emb, dens, rgb, m, p * PASS_ROWS, F, n_emb, hdr, rgb_bias};
        wg_field_pass(ring, fm, fs, io, FIELD_MAX_LAYERS + 1);
    }
}

NEK_ERROR_STRING_FN

static Occupancy occ;

// Blocks per SM, SM count and dynamic shared memory of the kernel.
extern "C" int nek_fused_field_occupancy(int* blocks_per_sm, int* sms, long long* smem) {
    const size_t bytes = field_smem_bytes(2 * SLAB_BYTES);
    const cudaError_t e = occupancy(field_kernel, bytes, &occ);
    *blocks_per_sm = occ.per_sm;
    *sms = occ.sms;
    *smem = (long long)bytes;
    return (int)e;
}

extern "C" int nek_fused_field(const float* pos, const float* dirs, const float* emb, int n_emb,
                               long long m, const int* field_dims, const long long* field_ptrs,
                               const float* box, int F, int hdr, float rgb_bias, float* dens, float* rgb,
                               void* stream) {
    FieldMlp fm;
    if (!make_field_mlp(field_dims, field_ptrs, &fm) || fm.n_last != 3 ||
        fm.layer[fm.n_base].k < 31 + n_emb || F < 0 || 3 + 6 * F > fm.layer[0].k)
        return (int)cudaErrorInvalidValue;
    const size_t smem = field_smem_bytes(2 * SLAB_BYTES);
    cudaError_t e = occupancy(field_kernel, smem, &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long passes = (m + PASS_ROWS - 1) / PASS_ROWS;
    const long long resident = (long long)occ.per_sm * occ.sms;
    const long long blocks = passes < resident ? passes : resident;
    if (blocks > 0)
        field_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            pos, dirs, emb, n_emb, m, fm, make_box(box), F, hdr, rgb_bias, dens, rgb);
    return (int)cudaGetLastError();
}
