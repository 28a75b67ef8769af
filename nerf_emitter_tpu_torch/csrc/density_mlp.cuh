// The proposal density MLP on Hopper's warpgroup matrix multiply: the
// f-major encoding (3 + 6F, zero-padded to 64) -> 128 (bf16, ReLU) -> 1 (an
// f32 reduce), over 64-row tiles, one tile per consumer warpgroup. K1
// (fused_density.cu) runs it on given positions, K3 and P2 (proposal.cu)
// and K5's proposal stage (mega_pipeline.cu) on the sample midpoints of a
// ray group (emitter_query.cuh `ProposalIo`): an Io supplies the rows and
// takes the densities.
//
// Arithmetic: that of the TPU kernels (nerf_emitter_tpu/ops/fused_field.py
// `_mlp_rowsT`) and of the twins: bf16 operands, f32 accumulation, f32 bias,
// ReLU, re-cast to bf16; the 128 -> 1 output layer is an f32 reduce with
// the f32 weight. The f32 bias is the accumulator's starting value, so it
// enters the f32 sum first rather than last (an f32 rounding apart).
//
// Design.
// - The whole MLP fits the block, so there is no ring: the hidden layer's
//   wgmma image (kernels.pack_wgmma_layer: W^T, K-major, 128-byte swizzle;
//   64 x 128 bf16, 16 KB), then the f32 hidden bias, the f32 output weight
//   and the output bias, packed by the host into one buffer
//   (kernels.DensityPack) and loaded by one bulk async copy on an mbarrier:
//   once per block in K1 and K3, once per ray group in K5, whose field
//   stage takes the pack's room between groups.
// - Each warpgroup owns a 64 x 64 bf16 slab (8 KB, field_mlp.cuh's swizzled
//   layout); its 128 threads encode a tile of 64 rows into it, two threads
//   a row (encode_row's split). The slabs are zeroed once per block, and a
//   tile writes only the 3 + 6F encoded columns: the padding stays zero.
//   The layer is four wgmma.m64n128k16 with A (the slab) and B (the image)
//   from shared memory and the accumulator in registers (64 f32 a thread,
//   set to the bias first: left uninitialised it spills).
// - The epilogue stays in registers: ReLU and the bf16 round in one
//   conversion a pair (cvt.rn.relu.bf16x2), times the output weight,
//   per-row partial sums over the thread's 32 columns, reduced across the
//   four lanes that share a row. No hidden activation goes back to shared
//   memory. A warpgroup synchronises only with itself (named barriers),
//   never with the block.
// - The caller loads a tile's rows ahead (K1 reads the next pass's
//   positions before it runs this one), so the global loads' latency hides
//   behind a tile's work.
//
// Bound: operations, (3 + 6F) x 128 + 128 MACs a row, ~16 bytes of I/O; at
// the bf16 peak a 64-row tile is ~1 ns of one SM's tensor cores, so the
// per-row CUDA-core work (6 sinf/cosf, the 3F-step octave recurrence, the
// bf16 stores, the epilogue's 64 values a thread) is the floor in practice.
#pragma once

#include "field_mlp.cuh"

namespace nek {

constexpr int DENSITY_K = 64;                                     // padded input width
constexpr int DENSITY_N = 128;                                    // hidden width
constexpr int DENSITY_IMAGE = DENSITY_K * DENSITY_N * 2;          // the hidden layer's image
constexpr int DENSITY_PACK = DENSITY_IMAGE + 8 * DENSITY_N + 16;  // + bias, w_out, b_out (f32)
constexpr int DENSITY_SLAB = WG_ROWS * DENSITY_K * 2;             // one warpgroup's rows
constexpr int DENSITY_PACK_SPAN = (DENSITY_PACK + 1023) / 1024 * 1024;  // a pack's room
// the work area (1024-aligned): the two slabs, the rows' keep flags, the
// pack's mbarrier, as byte offsets
constexpr int DENSITY_KEEP = 2 * DENSITY_SLAB;
constexpr int DENSITY_BAR = DENSITY_KEEP + PASS_ROWS * 4;
constexpr int DENSITY_WORK = DENSITY_BAR + 16;
constexpr int DENSITY_SMEM = 1024 + DENSITY_PACK_SPAN + DENSITY_WORK;  // K1's, with the alignment slack

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// The block's shared memory: the pack (image, bias, w_out, b_out) and the
// work area (one slab and 64 keep flags per warpgroup, the pack's
// mbarrier). Two packs can share one work area.
struct DensitySmem {
    unsigned char* pack;  // 1024-aligned
    unsigned char* work;  // 1024-aligned, DENSITY_WORK bytes

    __device__ const float* bias() const { return reinterpret_cast<const float*>(pack + DENSITY_IMAGE); }
    __device__ const float* w_out() const { return bias() + DENSITY_N; }
    __device__ float b_out() const { return w_out()[DENSITY_N]; }
    __device__ unsigned char* slab(int wg) const { return work + wg * DENSITY_SLAB; }
    __device__ int* keep(int wg) const { return reinterpret_cast<int*>(work + DENSITY_KEEP) + wg * WG_ROWS; }
    __device__ uint32_t bar() const { return smem_u32(work + DENSITY_BAR); }
};

__device__ inline unsigned char* align1024(unsigned char* smem) {
    return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

// ReLU, then bf16, of (lo, hi), packed; and back to f32
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// All threads call it: the work area's slabs are zeroed (a tile writes only
// its data columns, so the padding stays zero) and thread 0 initialises the
// mbarrier. The caller starts the copies and synchronises the block.
__device__ inline void density_init(const DensitySmem& ds) {
    for (int i = threadIdx.x; i < 2 * DENSITY_SLAB / 16; i += THREADS)
        reinterpret_cast<uint4*>(ds.slab(0))[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) {
        mbar_init(ds.bar(), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
}

// K1's layout from the block's dynamic shared memory: the pack, then the
// work area. All threads call it: thread 0 starts the pack's bulk copy
// (bytes DENSITY_PACK from `pack`, 16-byte aligned), waiting for which is
// density_tile's (or density_done's).
__device__ inline DensitySmem density_start(unsigned char* smem, const unsigned char* pack) {
    unsigned char* base = align1024(smem);
    const DensitySmem ds{base, base + DENSITY_PACK_SPAN};
    density_init(ds);
    if (threadIdx.x == 0) {
        mbar_expect_tx(ds.bar(), DENSITY_PACK);
        bulk_load(smem_u32(ds.pack), pack, DENSITY_PACK, ds.bar());
    }
    __syncthreads();
    return ds;
}

// One 64-row tile of warpgroup wg. Io supplies the rows and takes the
// results:
//   encode(slab, row, half) -> keep   writes row `row`'s f-major encoding,
//                                     its 3 + 6F columns (each row has two
//                                     threads, half 0 and 1; the padding
//                                     columns stay zero); half 0's keep
//                                     flag is the row's
//   density(row, raw, keep)           the raw f32 output of each row (one
//                                     thread a row)
// `ready` (per thread, false at first) records that the pack has arrived
// (phase 0 of its mbarrier); a caller that waits for the pack itself
// passes true. All 128 threads of the warpgroup call it.
template <class Io>
__device__ inline void density_tile(const DensitySmem& ds, const Io& io, int wg, bool& ready) {
    const int tid = threadIdx.x % 128, row = tid % WG_ROWS, half = tid / WG_ROWS;
    unsigned char* slab = ds.slab(wg);
    wg_sync(wg);  // the previous tile's readers of the slab and the keep flags are done
    const bool keep = io.encode(slab, row, half);
    if (half == 0) ds.keep(wg)[row] = keep;
    fence_proxy_async();
    wg_sync(wg);
    if (!ready) {
        mbar_wait(ds.bar(), 0);
        ready = true;
    }
    // thread (warp w, lane l) holds rows 16w + l/4 (+8) and columns
    // 8i + 2(l%4) (+1) at acc[4i + 2h + j]
    const int w = tid / 32, l = tid % 32;
    const float* bias = ds.bias();
    const float* wo = ds.w_out();
    float acc[DENSITY_N / 2];
#pragma unroll
    for (int i = 0; i < DENSITY_N / 8; ++i) {
        const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * (l % 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            acc[4 * i + 2 * h] = bv.x;
            acc[4 * i + 2 * h + 1] = bv.y;
        }
    }
    fence_regs<DENSITY_N / 2>(acc);
    wgmma_fence();
    const uint32_t a = smem_u32(slab), b = smem_u32(ds.pack);
#pragma unroll
    for (int s = 0; s < DENSITY_K / 16; ++s) wgmma_n128(acc, sw128_desc(a + s * 32), sw128_desc(b + s * 32), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DENSITY_N / 2>(acc);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < DENSITY_N / 8; ++i) {
        const float2 wv = *reinterpret_cast<const float2*>(wo + 8 * i + 2 * (l % 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t hv = relu_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
            sum[h] += wv.x * bf16_lo(hv) + wv.y * bf16_hi(hv);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    if (l % 4 == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + l / 4 + 8 * h;
            io.density(r, sum[h] + ds.b_out(), ds.keep(wg)[r] != 0);
        }
}

// A thread that ran no tile waits for the pack before it exits, so that no
// block retires with its copy in flight.
__device__ inline void density_done(const DensitySmem& ds, bool ready) {
    if (!ready) mbar_wait(ds.bar(), 0);
}

}  // namespace nek
