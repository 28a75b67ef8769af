// The field MLP alone: field_mlp.cuh's wgmma base MLP and colour head, the
// body of K4's and K5's field stage, on given rows. It replaces no TPU
// kernel of its own: it is K4's field (nerf_emitter_tpu/ops/mega_query.py
// `_field_composite_kernel`, :246-293) without the sampling and compositing
// around it, so that its layers can be held against a plain chain and timed
// one by one.
//
// Rows: x (m, k0) bf16, the base MLP's encoded input padded to its first
// layer's width; sh (m, 16) f32, the SH columns of the head's input; emb
// (E,), its appearance columns (the geo columns come from the base output).
// `depth` layers run: the base MLP's, then the head's hidden ones, then
// (depth = all + 1) the head's f32 output reduce. out (m, width of layer
// depth) f32 gets that layer's output: bf16 activations after a hidden
// layer, the f32 base output, or the head's raw f32 output. With out null
// nothing is written (the timing runs).
//
// Bound: as K4's field, operations (290k MACs a row at the sdf-nerfacto
// width); the weight stream from L2 (581 KB per 128-row pass) is the
// design's own floor (field_mlp.cuh).
#include "field_mlp.cuh"

using namespace nek;

struct RowsIo {
    const bf16* __restrict__ x;
    const float* __restrict__ sh;
    const float* __restrict__ emb;
    float* out;
    long long m, r0;  // rows; first row of the pass
    int kx, n_emb, depth, n_base;

    __device__ long long at(int wg, int row) const { return r0 + wg * WG_ROWS + row; }

    // 16-byte chunks of the row, alternating between its two threads
    __device__ void encode(unsigned char* slab, int wg, int row, int half, int) const {
        const long long i = at(wg, row);
        for (int q = half; q < kx / 8; q += 2) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (i < m) v = *reinterpret_cast<const uint4*>(x + i * kx + 8 * q);
            *reinterpret_cast<uint4*>(slab + swz(row, 8 * q)) = v;
        }
    }

    __device__ void head_in(unsigned char* slab, int wg, int row, int half, int kpad) const {
        const long long i = at(wg, row);
        if (half == 0) {
            for (int q = 0; q < 16; ++q) st_bf16(slab, row, q, i < m ? sh[i * 16 + q] : 0.0f);
        } else {
            for (int q = 0; q < n_emb; ++q) st_bf16(slab, row, 31 + q, emb[q]);
            for (int q = 31 + n_emb; q < kpad; ++q) st_bf16(slab, row, q, 0.0f);
        }
    }

    __device__ void density(int, int, float) const {}

    __device__ void colour(int wg, int row, int o, float raw) const {
        const long long i = at(wg, row);
        if (out && i < m) out[i * 3 + o] = raw;
    }

    __device__ void base_value(int wg, int row, int col, float v) const {
        const long long i = at(wg, row);
        if (out && depth == n_base && i < m) out[i * 16 + col] = v;
    }

    __device__ void dump(const unsigned char* slab, int wg, int row, int half, int n, int) const {
        const long long i = at(wg, row);
        if (!out || i >= m) return;
        for (int c = half; c < n; c += 2) out[i * n + c] = ld_bf16(slab, row, c);
    }
};

__global__ void __launch_bounds__(THREADS, 1)
field_mlp_kernel(const bf16* __restrict__ x, int kx, const float* __restrict__ sh,
                 const float* __restrict__ emb, int n_emb, long long m,
                 const __grid_constant__ FieldMlp fm, int depth, float* out) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const FieldSmem fs = carve_field(smem);
    const long long passes = (m + PASS_ROWS - 1) / PASS_ROWS;
    const int per_pass = field_chunks(fm, depth);
    const long long mine = (passes - blockIdx.x + gridDim.x - 1) / gridDim.x;
    Ring ring = ring_start(fs, fm, per_pass, (int)(mine * per_pass));
    for (long long p = blockIdx.x; p < passes; p += gridDim.x) {
        const RowsIo io{x, sh, emb, out, m, p * PASS_ROWS, kx, n_emb, depth, fm.n_base};
        wg_field_pass(ring, fm, fs, io, depth);
    }
}

NEK_ERROR_STRING_FN

static Occupancy occ;

extern "C" int nek_field_mlp(const void* x, int kx, const float* sh, const float* emb, int n_emb,
                             long long m, const int* field_dims, const long long* field_ptrs,
                             int depth, float* out, void* stream) {
    FieldMlp fm;
    if (!make_field_mlp(field_dims, field_ptrs, &fm) || kx != fm.layer[0].k ||
        fm.layer[fm.n_base].k < 31 + n_emb || depth < 1 || depth > fm.n_base + fm.n_head + 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = field_smem_bytes(2 * SLAB_BYTES);
    cudaError_t e = occupancy(field_mlp_kernel, smem, &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long passes = (m + PASS_ROWS - 1) / PASS_ROWS;
    const long long resident = (long long)occ.per_sm * occ.sms;
    const long long blocks = passes < resident ? passes : resident;
    if (blocks > 0)
        field_mlp_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            reinterpret_cast<const bf16*>(x), kx, sh, emb, n_emb, m, fm, depth, out);
    return (int)cudaGetLastError();
}
