// The field MLP of K2, K4 and K5 (and of the MLP-alone launcher, field_mlp.cu)
// on Hopper's warpgroup matrix multiply: the base MLP (encoding -> hidden
// layers -> 16 = density + 15 geo features) and the colour head
// ([SH 16, geo 15, appearance E] -> hidden layers -> 3, an f32 reduce),
// over passes of 128 sample rows.
//
// Arithmetic: that of the TPU kernels (nerf_emitter_tpu/ops/fused_field.py
// `_mlp_rowsT`): bf16 operands, f32 accumulation, f32 bias, ReLU, re-cast
// to bf16; the head's output layer (at most 4 wide) is an f32 reduce with
// the f32 weight.
//
// Design.
// - Two consumer warpgroups per block (the block's 256 threads), each
//   owning 64 sample rows of the pass. A warpgroup's activations live in
//   its own shared-memory slab (64 x 256 bf16, 32 KB) in the K-major
//   128-byte-swizzled layout that wgmma's descriptors read: 64-column
//   blocks of 64 rows x 128 bytes, 16-byte chunk c of row r stored at chunk
//   c ^ (r % 8). A layer is wgmma.m64nNk16 (N = 256 one instruction; 128 and
//   64 as m64n64k16; the base output as m64n16k16) with A (the slab) and B
//   (the weights) from shared memory and the accumulator in registers
//   (128 f32 a thread at N = 256). After the last product of a layer the
//   epilogue (bias, ReLU, bf16) writes the warpgroup's rows back into its
//   slab in place. Between layers only the warpgroup synchronises (a named
//   barrier of 128 threads), never the block.
// - Weights are staged, not re-read per tile: the host packs every layer
//   (W^T, K-major, swizzled, in 64-K blocks) into one stream of chunks
//   whose bytes are the shared-memory image (kernels.FieldPack). A ring of
//   RING stages of 32 KB takes the chunks in order (one bulk async copy,
//   cp.async.bulk, per chunk, completing on an mbarrier); both warpgroups
//   read each stage, then each warp arrives on the stage's "empty"
//   mbarrier. Thread 0 refills a stage once all 8 warps have released it.
//   There is no producer warp: the block's 256 threads all compute, and
//   K5's proposal stage (density_mlp.cuh's block and a warp per ray) uses
//   all of them.
// - The chunk sequence of a pass is the same for every pass, so the ring
//   runs ahead across passes and ray groups: in K5 the first chunks of a
//   group's field stage arrive while its proposal stage runs.
//
// Bound: operations, 290,688 MACs a sample at the sdf-nerfacto width. The
// design's own floor is the weight stream: a pass moves the whole field
// (581,632 bytes of bf16 weights) from L2 into shared memory for 128
// samples, against 37 MMACs of tensor-core work, ~10 us of bf16 peak on one
// SM (989 TFLOP/s over 132 SMs). Keeping up with the tensor cores would
// take ~59 GB/s of L2 reads per SM, 7.7 TB/s in all, more than L2 gives
// (PERF.md has the measured per-layer times); the per-sample CUDA-core work
// (encoding, SH, head input, reduce, composite) adds to it.
#pragma once

#include "common.cuh"

namespace nek {

constexpr int WG_ROWS = 64;                  // sample rows per consumer warpgroup
constexpr int PASS_ROWS = 2 * WG_ROWS;       // rows per pass (the block's 2 warpgroups)
constexpr int RING = 3;                      // weight stages
constexpr int STAGE_BYTES = 32768;           // one stage: 64 K-rows x 256 columns of bf16
constexpr int SLAB_COLS = 256;               // widest activation row
constexpr int SLAB_BYTES = WG_ROWS * SLAB_COLS * 2;
constexpr int KBLOCK_BYTES = WG_ROWS * 128;  // one 64-column block of a slab
constexpr int FIELD_MAX_LAYERS = 16;         // wgmma layers: base + head hidden
constexpr int FIELD_MAX_CHUNKS = 64;         // chunks per pass
constexpr int FIELD_RAYS = 8;                // rays per K4 block / K5 group (384 samples: 3 passes)

struct WgLayer {
    int k;             // input width, a multiple of 64
    int n;             // output width: 64, 128 or 256; 16 for the base output
    int kb_per_chunk;  // 64-K blocks per stream chunk
    int n_chunks;
    int first_chunk;   // index of its first chunk in the pass
    const float* bias;
};

// The packed field: the wgmma layers (the base MLP's, then the head's
// hidden ones), the chunk stream and the head's f32 output layer.
struct FieldMlp {
    const unsigned char* stream;
    int n_base, n_head;
    WgLayer layer[FIELD_MAX_LAYERS];
    int n_chunks;                           // chunks per pass
    int chunk_off[FIELD_MAX_CHUNKS + 1];    // byte offsets in the stream
    const float* w_last;                    // head output layer (k_last, n_last) f32
    const float* b_last;
    int k_last, n_last;
};

// dims = [n_base, n_head, (k, n, kb_per_chunk) per wgmma layer, k_last,
// n_last, stream bytes]; ptrs = [stream, bias per wgmma layer, w_last,
// b_last] (kernels.FieldPack.args). False on a shape the kernels do not
// take (the host's check_field_widths raises first).
inline bool make_field_mlp(const int* dims, const long long* ptrs, FieldMlp* f) {
    *f = FieldMlp{};
    f->n_base = dims[0];
    f->n_head = dims[1];
    const int L = f->n_base + f->n_head;
    if (f->n_base < 2 || f->n_head < 1 || L > FIELD_MAX_LAYERS) return false;
    f->stream = reinterpret_cast<const unsigned char*>(ptrs[0]);
    int chunk = 0, off = 0;
    for (int l = 0; l < L; ++l) {
        WgLayer& y = f->layer[l];
        y.k = dims[2 + 3 * l];
        y.n = dims[3 + 3 * l];
        y.kb_per_chunk = dims[4 + 3 * l];
        y.bias = reinterpret_cast<const float*>(ptrs[1 + l]);
        const bool base_out = l == f->n_base - 1;
        const bool width_ok = base_out ? y.n == 16 : (y.n == 64 || y.n == 128 || y.n == 256);
        if (!width_ok || y.k < 64 || y.k > SLAB_COLS || y.k % 64 || y.kb_per_chunk < 1 ||
            (y.k / 64) % y.kb_per_chunk || y.kb_per_chunk * y.n * 128 > STAGE_BYTES)
            return false;
        if (l != 0 && l != f->n_base && y.k != f->layer[l - 1].n) return false;
        y.n_chunks = (y.k / 64) / y.kb_per_chunk;
        y.first_chunk = chunk;
        for (int c = 0; c < y.n_chunks; ++c) {
            if (chunk >= FIELD_MAX_CHUNKS) return false;
            f->chunk_off[chunk++] = off;
            off += y.kb_per_chunk * y.n * 128;
        }
    }
    f->n_chunks = chunk;
    f->chunk_off[chunk] = off;
    f->k_last = dims[2 + 3 * L];
    f->n_last = dims[3 + 3 * L];
    f->w_last = reinterpret_cast<const float*>(ptrs[1 + L]);
    f->b_last = reinterpret_cast<const float*>(ptrs[2 + L]);
    return off == dims[4 + 3 * L] && f->k_last == f->layer[L - 1].n && f->n_last >= 1 &&
           f->n_last <= 4;
}

// chunks of one pass through the first `depth` layers
__host__ __device__ inline int field_chunks(const FieldMlp& f, int depth) {
    const int L = f.n_base + f.n_head;
    if (depth >= L) return f.n_chunks;
    return f.layer[depth - 1].first_chunk + f.layer[depth - 1].n_chunks;
}

// Shared memory of the field stage, around its 1024-aligned base f (the
// ring): the mbarriers (full[RING], empty[RING]) at f - FIELD_PRE, per-row
// keep flags at f - 1024 and raw densities at f - 512; the ring of RING
// stages at f, then the slabs' region (two slabs, or `slab_bytes` when the
// region is shared with a larger buffer). With the alignment slack:
constexpr int FIELD_PRE = 1024 + 64;

__host__ __device__ inline size_t field_smem_bytes(size_t slab_bytes) {
    return 1024 + FIELD_PRE + (size_t)RING * STAGE_BYTES + slab_bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

struct FieldSmem {
    unsigned char* f;

    __device__ unsigned char* slab(int wg) const { return f + RING * STAGE_BYTES + wg * SLAB_BYTES; }
    __device__ int* keep() const { return reinterpret_cast<int*>(f - 1024); }
    __device__ float* raw() const { return reinterpret_cast<float*>(f - 512); }
};

// The field stage's memory at the start of the block's dynamic shared
// memory; the caller's own regions start at smem + field_smem_bytes.
__device__ inline FieldSmem carve_field(unsigned char* smem) {
    const uint32_t a = smem_u32(smem) + FIELD_PRE;
    return FieldSmem{smem + FIELD_PRE + ((1024 - (a & 1023)) & 1023)};
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, bulk copies, proxy fences, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}

// generic-proxy stores to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup wg (named barriers 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the asynchronous
// products
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused for this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

// D (64 x W, f32) (+)= A (64 x 16) B (16 x W); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// One k16 step of a layer N wide: B's rows (the output columns) lie 128
// bytes apart in the stage, so the n64 pieces of N = 128 are 8 KB apart.
template <int N>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t da, uint32_t b, int scale_d) {
    if constexpr (N == 256) {
        wgmma_n256(d, da, sw128_desc(b), scale_d);
    } else if constexpr (N == 16) {
        wgmma_n16(d, da, sw128_desc(b), scale_d);
    } else {
#pragma unroll
        for (int q = 0; q < N / 64; ++q) wgmma_n64(d + 32 * q, da, sw128_desc(b + q * 64 * 128), scale_d);
    }
}

// ---------------------------------------------------------------------------
// the slab layout
// ---------------------------------------------------------------------------

// byte offset of bf16 element (row, col) in a slab
__device__ __forceinline__ int swz(int row, int col) {
    return (col >> 6) * KBLOCK_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void st_bf16(unsigned char* slab, int row, int col, float v) {
    *reinterpret_cast<bf16*>(slab + swz(row, col)) = __float2bfloat16(v);
}

__device__ __forceinline__ float ld_bf16(const unsigned char* slab, int row, int col) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(slab + swz(row, col)));
}

// The 3 + 6F f-major encoding of x2 into a slab row, zero-filled to kpad:
// [x, sin(dim k, octave i) at 3 + 3 i + k, cos at 3 + 3F + 3 i + k] (the
// first layer's rows are permuted on the host to match), the octaves by
// the double-angle recurrence with the twins' unfused 1 - 2 s^2. The row's
// two threads each run the recurrence; half 0 writes x2 and the sines,
// half 1 the cosines and the padding.
__device__ inline void encode_row(unsigned char* slab, int row, int half, const float x2[3], int F,
                                  int kpad) {
    for (int k = 0; k < 3; ++k) {
        if (half == 0) st_bf16(slab, row, k, x2[k]);
        float th = x2[k] * TWO_PI;
        float s = sinf(th), c = cosf(th);
        for (int i = 0; i < F; ++i) {
            const int r = 3 * i + k;
            if (half == 0)
                st_bf16(slab, row, 3 + r, s);
            else
                st_bf16(slab, row, 3 + 3 * F + r, c);
            float s2 = (2.0f * s) * c;
            float c2 = __fsub_rn(1.0f, __fmul_rn(2.0f * s, s));
            s = s2;
            c = c2;
        }
    }
    if (half == 1)
        for (int j = 3 + 6 * F; j < kpad; ++j) st_bf16(slab, row, j, 0.0f);
}

// ---------------------------------------------------------------------------
// the weight ring
// ---------------------------------------------------------------------------

// Chunk j of the block's sequence is chunk j % per_pass of the pass and
// lands in stage j % RING. Every consumer thread keeps the same counter.
struct Ring {
    uint32_t f;  // shared address of stage 0; the mbarriers sit FIELD_PRE below
    int next, per_pass, total;

    __device__ uint32_t full(int s) const { return f - FIELD_PRE + 8 * s; }
    __device__ uint32_t empty(int s) const { return f - FIELD_PRE + 8 * (RING + s); }

    __device__ void fetch(const FieldMlp& fm, int j) const {
        const int s = j % RING, c = j % per_pass;
        const int bytes = fm.chunk_off[c + 1] - fm.chunk_off[c];
        mbar_expect_tx(full(s), bytes);
        bulk_load(f + s * STAGE_BYTES, fm.stream + fm.chunk_off[c], bytes, full(s));
    }

    // waits for chunk `next`; returns its stage's shared address
    __device__ uint32_t acquire() const {
        const int s = next % RING;
        mbar_wait(full(s), (next / RING) & 1);
        return f + s * STAGE_BYTES;
    }

    // this warp is done with chunk `next`; thread 0 refills its stage once
    // every warp is
    __device__ void release(const FieldMlp& fm) {
        const int s = next % RING;
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(empty(s));
        if (threadIdx.x == 0 && next + RING < total) {
            mbar_wait(empty(s), (next / RING) & 1);
            fetch(fm, next + RING);
        }
        __syncwarp();
        ++next;
    }
};

// All threads call it: barriers, then the first RING chunks in flight.
__device__ inline Ring ring_start(const FieldSmem& fs, const FieldMlp& fm, int per_pass, int total) {
    const Ring r{smem_u32(fs.f), 0, per_pass, total};
    if (threadIdx.x == 0) {
        for (int s = 0; s < RING; ++s) {
            mbar_init(r.full(s), 1);
            mbar_init(r.empty(s), THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int j = 0; j < RING && j < total; ++j) r.fetch(fm, j);
    }
    __syncthreads();
    return r;
}

// ---------------------------------------------------------------------------
// one pass: 128 rows through the field
// ---------------------------------------------------------------------------

// acc (64 x N of this warpgroup) = slab[:, :k] @ W; thread (warp w, lane l)
// holds rows 16w + l/4 (+8) and columns 8i + 2(l%4) (+1) at acc[4i + 2h + j]
template <int N>
__device__ inline void wg_gemm(Ring& ring, const FieldMlp& fm, const WgLayer& y, uint32_t slab_a,
                               float* acc) {
    for (int c = 0; c < y.n_chunks; ++c) {
        const uint32_t st = ring.acquire();
        fence_regs<N / 2>(acc);
        wgmma_fence();
        for (int b = 0; b < y.kb_per_chunk; ++b) {
            const int kk = c * y.kb_per_chunk + b;
#pragma unroll
            for (int s = 0; s < 4; ++s)
                wgmma_step<N>(acc, sw128_desc(slab_a + kk * KBLOCK_BYTES + s * 32), st + b * N * 128 + s * 32,
                              (kk | s) != 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<N / 2>(acc);
        ring.release(fm);
    }
}

// bias, ReLU, bf16, in place into the slab
template <int N>
__device__ inline void store_hidden(const float* acc, const float* __restrict__ bias, unsigned char* slab) {
    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
        const int col = 8 * i + 2 * (l % 4);
        const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 16 * w + l / 4 + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(slab + swz(row, col)) = __floats2bfloat162_rn(
                fmaxf(acc[4 * i + 2 * h] + b.x, 0.0f), fmaxf(acc[4 * i + 2 * h + 1] + b.y, 0.0f));
        }
    }
}

// The base output (16 wide, f32): column 0 is the raw density (to the row
// scratch), columns 1..15 the geo features, bf16 into the head's input row
// at 16..30; io.base_value sees every value.
template <class Io>
__device__ inline void store_base_out(const float* acc, const float* __restrict__ bias,
                                      unsigned char* slab, const FieldSmem& fs, const Io& io, int wg) {
    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int row = 16 * w + l / 4 + 8 * h, col = 8 * i + 2 * (l % 4) + j;
                const float v = acc[4 * i + 2 * h + j] + __ldg(bias + col);
                if (col == 0)
                    fs.raw()[wg * WG_ROWS + row] = v;
                else
                    st_bf16(slab, row, 15 + col, v);
                io.base_value(wg, row, col, v);
            }
}

// The head's output layer (at most 4 wide, f32 weight) on the last hidden
// layer's bf16 rows in the slab: two neighbouring lanes per row, each over
// every other 16-byte chunk of it, then summed across the pair.
template <class Io>
__device__ inline void reduce_out(const unsigned char* slab, const FieldMlp& fm, const Io& io, int wg) {
    const int tid = threadIdx.x % 128, row = tid / 2, part = tid % 2, n = fm.n_last;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = part; c < fm.k_last / 8; c += 2) {
        const uint4 v = *reinterpret_cast<const uint4*>(slab + swz(row, 8 * c));
        const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float x = __bfloat162float(h[e]);
#pragma unroll
            for (int o = 0; o < 4; ++o)
                if (o < n) sum[o] += __ldg(fm.w_last + (8 * c + e) * n + o) * x;
        }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) sum[o] += __shfl_xor_sync(0xffffffffu, sum[o], 1);
    if (part == 0)
        for (int o = 0; o < n; ++o) io.colour(wg, row, o, sum[o] + __ldg(fm.b_last + o));
}

template <int N, class Io>
__device__ inline void wg_layer(Ring& ring, const FieldMlp& fm, const WgLayer& y, unsigned char* slab,
                                const FieldSmem& fs, const Io& io, int wg) {
    float acc[N / 2];  // zeroed: ptxas then keeps it in registers (without, it spills)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    wg_gemm<N>(ring, fm, y, smem_u32(slab), acc);
    wg_sync(wg);  // every warp's products have read the slab
    if constexpr (N == 16)
        store_base_out(acc, y.bias, slab, fs, io, wg);
    else
        store_hidden<N>(acc, y.bias, slab);
}

// Runs the first `depth` layers of the field (all of them, the head's
// output layer included, when depth > n_base + n_head) on this warpgroup's
// 64 rows of the pass. Io supplies the rows and takes the results:
//   encode(slab, wg, row, half, kpad)   the base input rows
//   head_in(slab, wg, row, half, kpad)  the head input's SH and appearance
//                                        columns and padding
//   density(wg, row, raw)               the raw density, after the base MLP
//   colour(wg, row, o, raw)             the head's f32 outputs
//   base_value(wg, row, col, v)         each f32 base output
//   dump(slab, wg, row, half, n, l)     the slab after hidden layer l = depth-1
// Each row has two threads (half 0 and 1). All 256 threads of the block call it.
template <class Io>
__device__ inline void wg_field_pass(Ring& ring, const FieldMlp& fm, const FieldSmem& fs, const Io& io,
                                     int depth) {
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, row = tid % WG_ROWS, half = tid / WG_ROWS;
    unsigned char* slab = fs.slab(wg);
    const int L = fm.n_base + fm.n_head;
    wg_sync(wg);  // the previous pass's readers of the slab are done
    io.encode(slab, wg, row, half, fm.layer[0].k);
    fence_proxy_async();
    wg_sync(wg);
    for (int l = 0; l < L && l < depth; ++l) {
        const WgLayer& y = fm.layer[l];
        if (y.n == 256)
            wg_layer<256>(ring, fm, y, slab, fs, io, wg);
        else if (y.n == 128)
            wg_layer<128>(ring, fm, y, slab, fs, io, wg);
        else if (y.n == 64)
            wg_layer<64>(ring, fm, y, slab, fs, io, wg);
        else
            wg_layer<16>(ring, fm, y, slab, fs, io, wg);
        if (l == fm.n_base - 1) {
            wg_sync(wg);  // geo columns and raw densities are written
            io.head_in(slab, wg, row, half, fm.layer[l + 1].k);
            if (half == 0) io.density(wg, row, fs.raw()[wg * WG_ROWS + row]);
        }
        fence_proxy_async();
        wg_sync(wg);
        if (l == depth - 1 && l != fm.n_base - 1) io.dump(slab, wg, row, half, y.n, l);
    }
    if (depth > L) reduce_out(slab, fm, io, wg);
}

// Blocks per SM and SM count of a persistent kernel at `smem` bytes, asked
// of the runtime once per (device, shared memory size).
struct Occupancy {
    int dev = -1, per_sm = 0, sms = 0;
    size_t smem = 0;
};

template <class Kernel>
inline cudaError_t occupancy(Kernel kernel, size_t smem, Occupancy* o) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev == o->dev && smem == o->smem) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&o->sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o->per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    o->dev = dev;
    o->smem = smem;
    return cudaSuccess;
}

}  // namespace nek
