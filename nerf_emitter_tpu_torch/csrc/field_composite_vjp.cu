// The emitter query's backward for a frozen NeRF: K4 (field and composite)
// transposed. Given the final spacing bins, the rays and the gradient g
// (3, N) reaching the answer, it writes the gradients of the rays' origins
// and directions (3, N) and of their nears and fars (N).
//
// Replaces no TPU kernel: the JAX package differentiates the query with
// jax.vjp through XLA (nerf_emitter_tpu/ops/mega_query.py:746-755), which
// the port followed with a PyTorch recompute of the staged query. It serves
// _MegaQuery.backward when no NeRF parameter needs a gradient (the
// takeover's frozen emitter); the bins come from K3, the bins K5's forward
// used. sample_pdf stops the gradient at the weights, so the bins are
// constants: a ray's gradient reaches o and d through the positions
// o + d t and the SH of d, and near and far through t and the deltas. With
// the weights frozen, the backward through a ReLU layer needs the layer's
// weights and its ReLU mask, not its activations.
//
// Per group of 8 rays (384 samples at s2 = 48: 3 passes of 128 rows):
// - forward passes through field_mlp.cuh's wgmma field, as K4's, that keep
//   each sample's density, colour and activation flags, and each hidden
//   layer's ReLU mask as bits, in the fragment order of the thread that
//   wrote it (22 KB a pass at the sdf-nerfacto widths): the thread that
//   holds a gradient value in the backward held the activation there;
// - once a ray has all its samples, the composite and its backward, a warp
//   per ray: the gradients of each sample's raw density and raw colour and
//   of its delta (the transmittance's suffix sums, the last-sample
//   background, the keep mask through the density);
// - backward passes on the same weight stream: the head's f32 output layer
//   on the CUDA cores, then each wgmma layer from the last to the first,
//   the gradient (bf16) times the layer's weight tiles read transposed
//   (wgmma's MN-major B), f32 accumulation; each layer's input gradient is
//   rounded to bf16 and zeroed where the ReLU below it was off. That is
//   the plain version's arithmetic: autograd through `.to(bf16).float()`
//   rounds the gradient there. The head input's SH columns give d's share,
//   its geo columns the base output's gradient, whose density column joins
//   in f32; the encoding's derivative is taken analytically on the octaves'
//   recurrence;
// - a warp per ray sums its samples into g_o, g_d and, through the spacing
//   warp, g_near and g_far.
// A backward pass needs the composite of every ray its rows touch, so a
// group runs its passes F0 F1 B0 F2 B1 B2 (`vjp_order`) and keeps the
// masks of two passes. No atomics and no sum across rays: a ray's gradient
// does not depend on the batch it came in.
//
// Bound on an H100: operations, twice K4's (the forward again, then one
// product per layer back): 0.58 x 2 TFLOP at 2^16 rays, 3.70 ms of bf16
// tensor-core time, against 272 bytes of I/O a ray. As K4, the design's
// own floor is the weight stream from L2: six passes of the field's 581 KB
// a group, twice K4's three. Shared memory at the sdf-nerfacto widths and
// s2 = 48, 230,112 bytes: K4's field stage (162 KB), two passes' masks
// (44 KB) and 19 KB of per-ray and per-sample state.
#include "emitter_query.cuh"

using namespace nek;

constexpr int RAYS = FIELD_RAYS;
constexpr int MASK_SLOTS = 2;    // passes whose ReLU masks are kept at once
constexpr int MAX_S2 = 128;      // a ray then spans at most two passes
constexpr int LANE_SAMPLES = MAX_S2 / 32;  // a ray's samples a lane holds in the per-ray steps
constexpr int BASE_OUT = 16;     // the base MLP's output: density + 15 geo features

// What the launcher works out from the packed field and s2.
struct VjpPlan {
    int bwd[FIELD_MAX_CHUNKS];      // the chunks in a backward pass's order: layers last to first
    int mask_at[FIELD_MAX_LAYERS];  // a ReLU layer's first mask word (a thread's) in a slot
    int mask_words;                 // mask words a thread keeps for a pass
    int passes;                     // forward passes of a group, and backward ones
    unsigned order;                 // bit t: step t of a group is a backward pass
};

// The order of a group's passes: bit t is set when step t is a backward
// pass. Backward pass b runs once every ray its rows touch has had all its
// forward passes; forward passes run only as far as that needs.
__host__ __device__ inline unsigned vjp_order(int s2, int passes) {
    const int rows = RAYS * s2;
    unsigned order = 0;
    for (int t = 0, f = 0, b = 0; b < passes; ++t) {
        const int end = PASS_ROWS * (b + 1) < rows ? PASS_ROWS * (b + 1) : rows;
        const int need = ((end + s2 - 1) / s2 * s2 + PASS_ROWS - 1) / PASS_ROWS;
        if (f >= need) {
            order |= 1u << t;
            ++b;
        } else {
            ++f;
        }
    }
    return order;
}

static size_t vjp_smem_bytes(int s2, int mask_words) {
    return field_smem_bytes(2 * SLAB_BYTES) + (size_t)MASK_SLOTS * mask_words * THREADS * 4 +
           sizeof(float) * RAYS * ((s2 + 1) + 8 + 11 * s2) + (size_t)RAYS * s2;
}

// ---------------------------------------------------------------------------
// the weight ring over this kernel's chunk sequence
// ---------------------------------------------------------------------------

// field_mlp.cuh's `Ring` (its mbarriers, stages and refill) over a group's
// passes in `order`: a forward pass takes the chunks in stream order, a
// backward pass in plan.bwd's. `Ring` repeats one pass's sequence, which
// K2, K4 and K5 run; this kernel's forward pass (`gemm_fwd`,
// `forward_pass`) follows field_mlp.cuh's on this ring.
struct VjpRing {
    uint32_t f;
    int next, total, per_pass, period;
    const FieldMlp* fm;
    const VjpPlan* plan;

    __device__ uint32_t full(int s) const { return f - FIELD_PRE + 8 * s; }
    __device__ uint32_t empty(int s) const { return f - FIELD_PRE + 8 * (RING + s); }

    __device__ void fetch(int j) const {
        const int q = j % period, c = q % per_pass;
        const int k = (plan->order >> (q / per_pass)) & 1 ? plan->bwd[c] : c;
        const int s = j % RING, bytes = fm->chunk_off[k + 1] - fm->chunk_off[k];
        mbar_expect_tx(full(s), bytes);
        bulk_load(f + s * STAGE_BYTES, fm->stream + fm->chunk_off[k], bytes, full(s));
    }

    __device__ uint32_t acquire() const {
        const int s = next % RING;
        mbar_wait(full(s), (next / RING) & 1);
        return f + s * STAGE_BYTES;
    }

    __device__ void release() {
        const int s = next % RING;
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(empty(s));
        if (threadIdx.x == 0 && next + RING < total) {
            mbar_wait(empty(s), (next / RING) & 1);
            fetch(next + RING);
        }
        __syncwarp();
        ++next;
    }
};

__device__ inline VjpRing vjp_ring_start(const FieldSmem& fs, const FieldMlp& fm, const VjpPlan& plan,
                                         int total) {
    const VjpRing r{smem_u32(fs.f), 0, total, fm.n_chunks, 2 * plan.passes * fm.n_chunks, &fm, &plan};
    if (threadIdx.x == 0) {
        for (int s = 0; s < RING; ++s) {
            mbar_init(r.full(s), 1);
            mbar_init(r.empty(s), THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int j = 0; j < RING && j < total; ++j) r.fetch(j);
    }
    __syncthreads();
    return r;
}

// ---------------------------------------------------------------------------
// forward passes: field_mlp.cuh's field, keeping the ReLU masks
// ---------------------------------------------------------------------------

// field_mlp.cuh `wg_gemm` on this kernel's ring
template <int N>
__device__ inline void gemm_fwd(VjpRing& ring, const WgLayer& y, uint32_t slab_a, float* acc) {
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
        ring.release();
    }
}

// field_mlp.cuh `store_hidden` (bias, ReLU, bf16, in place), keeping each
// value's ReLU mask: value v of the thread's fragment is bit v % 32 of its
// word v / 32, a thread's words THREADS apart
template <int N>
__device__ inline void store_hidden_masked(const float* acc, const float* __restrict__ bias,
                                           unsigned char* slab, uint32_t* mask) {
    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    uint32_t bits[N / 64];
#pragma unroll
    for (int q = 0; q < N / 64; ++q) bits[q] = 0u;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
        const int col = 8 * i + 2 * (l % 4);
        const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 16 * w + l / 4 + 8 * h, v = 4 * i + 2 * h;
            const __nv_bfloat162 y =
                __floats2bfloat162_rn(fmaxf(acc[v] + b.x, 0.0f), fmaxf(acc[v + 1] + b.y, 0.0f));
            *reinterpret_cast<__nv_bfloat162*>(slab + swz(row, col)) = y;
            bits[v / 32] |= ((uint32_t)(__low2float(y) > 0.0f) << (v % 32)) |
                            ((uint32_t)(__high2float(y) > 0.0f) << ((v + 1) % 32));
        }
    }
#pragma unroll
    for (int q = 0; q < N / 64; ++q) mask[q * THREADS + threadIdx.x] = bits[q];
}

template <int N, class Io>
__device__ inline void forward_layer(VjpRing& ring, const WgLayer& y, unsigned char* slab, uint32_t* mask,
                                     const FieldSmem& fs, const Io& io, int wg) {
    float acc[N / 2];  // zeroed: ptxas then keeps it in registers
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    gemm_fwd<N>(ring, y, smem_u32(slab), acc);
    wg_sync(wg);  // every warp's products have read the slab
    if constexpr (N == 16)
        store_base_out(acc, y.bias, slab, fs, io, wg);
    else
        store_hidden_masked<N>(acc, y.bias, slab, mask);
}

// K4's rows (emitter_query.cuh `GroupIo`), also keeping which activations
// pass a gradient: bit 0 the density's (its clamp did not bind), bit 1 + o
// colour o's (HDR: its clamp did not bind)
struct VjpIo {
    GroupIo g;
    unsigned char* flags;

    __device__ void encode(unsigned char* slab, int wg, int row, int half, int kpad) const {
        g.encode(slab, wg, row, half, kpad);
    }
    __device__ void head_in(unsigned char* slab, int wg, int row, int half, int kpad) const {
        g.head_in(slab, wg, row, half, kpad);
    }
    __device__ void density(int wg, int row, float raw) const {
        g.density(wg, row, raw);
        const int j = g.sample(wg, row);
        if (j < g.total) flags[j] = raw - 1.0f <= SAFE_EXP_MAX;
    }
    __device__ void colour(int wg, int row, int o, float raw) const {
        g.colour(wg, row, o, raw);
        const int j = g.sample(wg, row);
        if (j < g.total && raw + g.rgb_bias <= SAFE_EXP_MAX) flags[j] |= 2 << o;
    }
    __device__ void base_value(int, int, int, float) const {}
};

// field_mlp.cuh `wg_field_pass` through every layer, with this kernel's
// ring and the hidden layers' masks into `masks` (a slot)
template <class Io>
__device__ inline void forward_pass(VjpRing& ring, const FieldMlp& fm, const VjpPlan& plan,
                                    const FieldSmem& fs, const Io& io, uint32_t* masks) {
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, row = tid % WG_ROWS, half = tid / WG_ROWS;
    unsigned char* slab = fs.slab(wg);
    wg_sync(wg);  // the previous pass's readers of the slab are done
    io.encode(slab, wg, row, half, fm.layer[0].k);
    fence_proxy_async();
    wg_sync(wg);
    for (int l = 0; l < fm.n_base + fm.n_head; ++l) {
        const WgLayer& y = fm.layer[l];
        uint32_t* mask = masks + plan.mask_at[l] * THREADS;
        if (y.n == 256)
            forward_layer<256>(ring, y, slab, mask, fs, io, wg);
        else if (y.n == 128)
            forward_layer<128>(ring, y, slab, mask, fs, io, wg);
        else if (y.n == 64)
            forward_layer<64>(ring, y, slab, mask, fs, io, wg);
        else
            forward_layer<16>(ring, y, slab, mask, fs, io, wg);
        if (l == fm.n_base - 1) {
            wg_sync(wg);  // geo columns and raw densities are written
            io.head_in(slab, wg, row, half, fm.layer[l + 1].k);
            if (half == 0) io.density(wg, row, fs.raw()[wg * WG_ROWS + row]);
        }
        fence_proxy_async();
        wg_sync(wg);
    }
    reduce_out(slab, fm, io, wg);
}

// ---------------------------------------------------------------------------
// the composite and its backward, a warp per ray
// ---------------------------------------------------------------------------

// lane l gets the sum of x over lanes l, l + 1, ..., 31
__device__ __forceinline__ float warp_suffix_sum(float x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_down_sync(FULL_MASK, x, off);
        if (lane + off < 32) x = __fadd_rn(x, y);
    }
    return x;
}

// One ray, by its warp: from its euclidean bins e (s2+1), its samples'
// densities and colours (dens, rgb) and the gradient g reaching its
// answer rgb = sum(w rgb) + rgb_last (1 - sum(w)), the gradients of each
// sample's raw density and raw colour (through the activations, where
// `flags` lets them through) in place of its density and colour, and of
// its delta into g_delta. w_i = (1 - exp(-dd_i)) T_i with dd_i = sigma_i
// delta_i and T_i = exp(-sum_{m<i} dd_m), so dL/d dd_i is
// gw_i exp(-dd_i) T_i minus the sum of gw_m w_m over the later samples.
__device__ inline void composite_vjp(const float* e, float* dens, float* rgb, const unsigned char* flags,
                                     float* g_delta, const float g[3], int s2, int hdr, int lane) {
    float w[LANE_SAMPLES], et[LANE_SAMPLES], gw[LANE_SAMPLES];
    float carry = 0.0f, acc_part = 0.0f;
#pragma unroll
    for (int q = 0; q < LANE_SAMPLES; ++q) {
        const int s = 32 * q + lane;
        const float dd = s < s2 ? __fmul_rn(dens[s], e[s + 1] - e[s]) : 0.0f;
        const float incl = warp_incl_sum(dd, lane);
        const float before = __shfl_up_sync(FULL_MASK, incl, 1);
        const float trans = expf(-__fadd_rn(carry, lane == 0 ? 0.0f : before));
        const float ed = expf(-dd);
        w[q] = s < s2 ? (1.0f - ed) * trans : 0.0f;
        et[q] = ed * trans;
        acc_part += w[q];
        carry = __fadd_rn(carry, __shfl_sync(FULL_MASK, incl, 31));
    }
    const float acc = warp_sum(acc_part);
    const float last[3] = {rgb[(s2 - 1) * 3], rgb[(s2 - 1) * 3 + 1], rgb[(s2 - 1) * 3 + 2]};
#pragma unroll
    for (int q = 0; q < LANE_SAMPLES; ++q) {
        const int s = 32 * q + lane;
        gw[q] = 0.0f;
        if (s < s2)
            for (int k = 0; k < 3; ++k) gw[q] += g[k] * (rgb[s * 3 + k] - last[k]);
    }
    __syncwarp();  // every lane has read the last sample's colour
    carry = 0.0f;
#pragma unroll
    for (int q = LANE_SAMPLES - 1; q >= 0; --q) {
        const int s = 32 * q + lane;
        const float incl = warp_suffix_sum(gw[q] * w[q], lane);
        const float after = __shfl_down_sync(FULL_MASK, incl, 1);
        const float later = __fadd_rn(carry, lane == 31 ? 0.0f : after);
        if (s < s2) {
            const float g_dd = gw[q] * et[q] - later;
            const float sigma = dens[s], delta = e[s + 1] - e[s];
            g_delta[s] = g_dd * sigma;
            dens[s] = flags[s] & 1 ? g_dd * delta * sigma : 0.0f;
            for (int k = 0; k < 3; ++k) {
                const float c = rgb[s * 3 + k];
                const float gc = g[k] * w[q] + (s == s2 - 1 ? g[k] * (1.0f - acc) : 0.0f);
                rgb[s * 3 + k] = gc * (hdr ? ((flags[s] >> (1 + k)) & 1 ? c : 0.0f) : c * (1.0f - c));
            }
        }
        carry = __fadd_rn(carry, __shfl_sync(FULL_MASK, incl, 0));
    }
}

// ---------------------------------------------------------------------------
// backward passes
// ---------------------------------------------------------------------------

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), B read MN-major
__device__ __forceinline__ void wgmma_n64_tb(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// An MN-major B tile (K 16 rows x N 64 columns) of a packed weight: rows
// 128 bytes apart with the 128-byte swizzle, 8-row groups 1024 bytes apart.
// The tile is one swizzle atom wide, so only the K-direction group stride
// is read; it goes into both offset fields, whichever one the hardware
// reads for it.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

// acc (64 x KW of this warpgroup) = slab[:, :n] @ W^T for a layer W (KW x n):
// the layer's chunks hold W^T's 64-column blocks, each n rows of 128 bytes
// (kernels.pack_wgmma_layer), which wgmma reads MN-major as B (n x 64):
// block kk gives the output's columns 64 kk ... 64 kk + 63.
template <int KW>
__device__ inline void gemm_bwd(VjpRing& ring, int n, int kb_per_chunk, uint32_t slab_a, float* acc) {
    uint32_t st = 0;
#pragma unroll
    for (int kk = 0; kk < KW / 64; ++kk) {
        const int b = kk % kb_per_chunk;
        if (b == 0) {
            st = ring.acquire();
            fence_regs<KW / 2>(acc);
            wgmma_fence();
        }
        for (int s = 0; s < n / 16; ++s)
            wgmma_n64_tb(acc + 32 * kk, sw128_desc(slab_a + (s / 4) * KBLOCK_BYTES + (s % 4) * 32),
                         mn_desc(st + b * n * 128 + s * 2048), s != 0);
        if (b == kb_per_chunk - 1) {
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<KW / 2>(acc);
            ring.release();
        }
    }
}

// The gradient at a layer's input (acc, KW wide) rounded to bf16 and, with
// a mask, zeroed where the ReLU below it was off, in place into the slab
template <int KW>
__device__ inline void store_grad(const float* acc, unsigned char* slab, const uint32_t* mask) {
    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    uint32_t bits[(KW + 63) / 64];
#pragma unroll
    for (int q = 0; q < (KW + 63) / 64; ++q) bits[q] = mask ? mask[q * THREADS + threadIdx.x] : ~0u;
#pragma unroll
    for (int i = 0; i < KW / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 16 * w + l / 4 + 8 * h, col = 8 * i + 2 * (l % 4), v = 4 * i + 2 * h;
            const float x = (bits[v / 32] >> (v % 32)) & 1u ? acc[v] : 0.0f;
            const float y = (bits[v / 32] >> ((v + 1) % 32)) & 1u ? acc[v + 1] : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(slab + swz(row, col)) = __floats2bfloat162_rn(x, y);
        }
}

// A backward pass's rows and the group's per-sample state
struct Rows {
    const Box& bx;
    const float* eb;      // the group's euclidean bins, rows of s2+1
    const float* ray;     // o, d, s_near, s_far: 8 floats a ray
    const float* g_dens;  // the gradient of each sample's raw density
    const float* g_rgb;   // ... and of its raw colour (3)
    float* gp;            // out: of its position (3)
    float* gdsh;          // out: of its direction through the SH (3)
    int c0, total, s2, F;

    __device__ int sample(int wg, int row) const { return c0 + wg * WG_ROWS + row; }
};

// The base output's density column, in f32 (the other columns, the geo
// features' bf16 gradients, went through wgmma with a 0 in its place):
// acc += g_raw_density x the column's bf16 weights w0 (f32)
template <int KW>
__device__ inline void add_density_term(float* acc, const float* __restrict__ w0, const Rows& rows, int wg) {
    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    float gd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = rows.sample(wg, 16 * w + l / 4 + 8 * h);
        gd[h] = j < rows.total ? rows.g_dens[j] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < KW / 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const float wc = __ldg(w0 + 8 * i + 2 * (l % 4) + jj);
#pragma unroll
            for (int h = 0; h < 2; ++h) acc[4 * i + 2 * h + jj] += gd[h] * wc;
        }
}

// One wgmma layer back: the gradient at its output in the slab -> the one
// at its input, in place (masked by `mask`, the ReLU below, if any)
template <int KW>
__device__ inline void backward_layer(VjpRing& ring, const WgLayer& y, unsigned char* slab, const uint32_t* mask,
                                      const float* w0, const Rows& rows, int wg) {
    float acc[KW / 2];
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) acc[i] = 0.0f;
    gemm_bwd<KW>(ring, y.n, y.kb_per_chunk, smem_u32(slab), acc);
    wg_sync(wg);  // every warp's products have read the slab
    if (y.n == BASE_OUT) add_density_term<KW>(acc, w0, rows, wg);
    store_grad<KW>(acc, slab, mask);
}

// The gradient at the head's last hidden layer, N wide: the f32 output
// layer transposed on the CUDA cores, at the thread's own fragment
// positions, rounded to bf16 and masked by that layer's ReLU
template <int N>
__device__ inline void head_out_grad(const FieldMlp& fm, const Rows& rows, unsigned char* slab,
                                     const uint32_t* mask, int wg) {
    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    float gr[2][3], acc[N / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = rows.sample(wg, 16 * w + l / 4 + 8 * h);
        for (int o = 0; o < 3; ++o) gr[h][o] = j < rows.total ? rows.g_rgb[j * 3 + o] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const float* wl = fm.w_last + (8 * i + 2 * (l % 4) + jj) * 3;
            const float w0 = __ldg(wl), w1 = __ldg(wl + 1), w2 = __ldg(wl + 2);
#pragma unroll
            for (int h = 0; h < 2; ++h) acc[4 * i + 2 * h + jj] = gr[h][0] * w0 + gr[h][1] * w1 + gr[h][2] * w2;
        }
    store_grad<N>(acc, slab, mask);
}

// d(sum_m g_m sh_m(x, y, z)) / d(x, y, z) for common.cuh's `sh4`
__device__ inline void sh4_vjp(float x, float y, float z, const float g[16], float out[3]) {
    const float c1 = 0.48860251190291987f, c2 = 1.0925484305920792f, c3 = 0.94617469575755997f,
                c5 = 0.54627421529603959f, c6 = 0.59004358992664352f, c7 = 2.8906114426405538f,
                c8 = 0.45704579946446572f, c9 = 0.3731763325901154f, c10 = 1.4453057213202769f;
    const float xx = x * x, yy = y * y, zz = z * z;
    out[0] = -c1 * g[3] + c2 * y * g[4] - c2 * z * g[7] + 2.0f * c5 * x * g[8] - 6.0f * c6 * x * y * g[9] +
             c7 * y * z * g[10] + c8 * (1.0f - 5.0f * zz) * g[13] + 2.0f * c10 * x * z * g[14] +
             3.0f * c6 * (yy - xx) * g[15];
    out[1] = -c1 * g[1] + c2 * x * g[4] - c2 * z * g[5] - 2.0f * c5 * y * g[8] + 3.0f * c6 * (yy - xx) * g[9] +
             c7 * x * z * g[10] + c8 * (1.0f - 5.0f * zz) * g[11] - 2.0f * c10 * y * z * g[14] +
             6.0f * c6 * x * y * g[15];
    out[2] = c1 * g[2] - c2 * y * g[5] + 2.0f * c3 * z * g[6] - c2 * x * g[7] + c7 * x * y * g[10] -
             10.0f * c8 * y * z * g[11] + c9 * (15.0f * zz - 3.0f) * g[12] - 10.0f * c8 * x * z * g[13] +
             c10 * (xx - yy) * g[14];
}

// The head input's gradient (bf16 in the slab, [SH 16, geo 15, appearance]),
// by the row's two threads: the SH columns give the sample's d share
// (half 0); the geo columns move to columns 1..15 behind a 0 (half 1), the
// base output's gradient with its density column left for f32
__device__ inline void head_input_grad(unsigned char* slab, const Rows& rows, int wg, int row, int half) {
    const int j = rows.sample(wg, row);
    float geo[BASE_OUT - 1];
    if (half == 0) {
        float g[16], out[3];
        for (int q = 0; q < 16; ++q) g[q] = ld_bf16(slab, row, q);
        const float* dr = rows.ray + (j < rows.total ? j / rows.s2 : 0) * 8 + 3;
        sh4_vjp(dr[0], dr[1], dr[2], g, out);
        if (j < rows.total)
            for (int k = 0; k < 3; ++k) rows.gdsh[j * 3 + k] = out[k];
    } else {
        for (int q = 0; q < BASE_OUT - 1; ++q) geo[q] = ld_bf16(slab, row, 16 + q);
    }
    wg_sync(wg);  // the SH columns are read
    if (half == 1) {
        st_bf16(slab, row, 0, 0.0f);
        for (int q = 0; q < BASE_OUT - 1; ++q) st_bf16(slab, row, 1 + q, geo[q]);
    }
}

// The encoding's gradient (bf16 in the slab, f-major: [x, sin(dim k,
// octave i) at 3 + 3 i + k, cos at 3 + 3F + 3 i + k]) -> the sample's
// position's, by the row's two threads (half 0 dims 0 and 1, half 1 dim 2):
// d sin_i / dx = 2 pi 2^i cos_i and d cos_i / dx = -2 pi 2^i sin_i on the
// forward's own octaves (encode_row's recurrence), then the affine map
__device__ inline void encoding_grad(const unsigned char* slab, const Rows& rows, int wg, int row, int half) {
    const int j = rows.sample(wg, row);
    if (j >= rows.total) return;
    const int r = j / rows.s2, si = j % rows.s2, F = rows.F;
    const float* e = rows.eb + r * (rows.s2 + 1);
    const float* ray = rows.ray + r * 8;
    const float mid = (e[si] + e[si + 1]) / 2.0f;
    float p[3], x2[3];
    for (int k = 0; k < 3; ++k) p[k] = __fadd_rn(ray[k], __fmul_rn(ray[3 + k], mid));
    contract_and_select(rows.bx, p, x2);
    for (int k = half == 0 ? 0 : 2; k < (half == 0 ? 2 : 3); ++k) {
        const float th = x2[k] * TWO_PI;
        float g = ld_bf16(slab, row, k), s = sinf(th), c = cosf(th), scale = TWO_PI;
        for (int i = 0; i < F; ++i) {
            g += scale * (ld_bf16(slab, row, 3 + 3 * i + k) * c - ld_bf16(slab, row, 3 + 3 * F + 3 * i + k) * s);
            const float s2 = (2.0f * s) * c;
            const float c2 = __fsub_rn(1.0f, __fmul_rn(2.0f * s, s));
            s = s2;
            c = c2;
            scale *= 2.0f;
        }
        rows.gp[j * 3 + k] = g * 2.0f * rows.bx.inv_ext[k];
    }
}

// One backward pass of 128 rows: from the gradients of their raw colours
// and densities to those of their positions and (through the SH) their
// directions, the layers last to first on the masks of their forward pass
__device__ inline void backward_pass(VjpRing& ring, const FieldMlp& fm, const VjpPlan& plan, const FieldSmem& fs,
                                     const Rows& rows, const uint32_t* masks, const float* w0) {
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, row = tid % WG_ROWS, half = tid / WG_ROWS;
    unsigned char* slab = fs.slab(wg);
    const int L = fm.n_base + fm.n_head;
    wg_sync(wg);  // the previous pass's readers of the slab are done
    const uint32_t* top = masks + plan.mask_at[L - 1] * THREADS;
    if (fm.k_last == 256)
        head_out_grad<256>(fm, rows, slab, top, wg);
    else if (fm.k_last == 128)
        head_out_grad<128>(fm, rows, slab, top, wg);
    else
        head_out_grad<64>(fm, rows, slab, top, wg);
    fence_proxy_async();
    wg_sync(wg);
    for (int l = L - 1; l >= 0; --l) {
        const WgLayer& y = fm.layer[l];
        const uint32_t* mask = l != 0 && l != fm.n_base ? masks + plan.mask_at[l - 1] * THREADS : nullptr;
        if (y.k == 256)
            backward_layer<256>(ring, y, slab, mask, w0, rows, wg);
        else if (y.k == 192)
            backward_layer<192>(ring, y, slab, mask, w0, rows, wg);
        else if (y.k == 128)
            backward_layer<128>(ring, y, slab, mask, w0, rows, wg);
        else
            backward_layer<64>(ring, y, slab, mask, w0, rows, wg);
        if (l == fm.n_base || l == 0) {
            wg_sync(wg);  // the layer's input gradient is in
            if (l == 0)
                encoding_grad(slab, rows, wg, row, half);
            else
                head_input_grad(slab, rows, wg, row, half);
        }
        fence_proxy_async();
        wg_sync(wg);
    }
}

// ---------------------------------------------------------------------------
// a ray's samples summed
// ---------------------------------------------------------------------------

// d spacing_pw_inv(x) / dx at the sample edge x = sb (sf - sn) + sn
__device__ inline float edge_slope(float sb, float sn, float sf) {
    const float x = __fadd_rn(__fmul_rn(sb, sf - sn), sn);
    if (x < 0.5f) return 2.0f;
    const float den = 2.0f - 2.0f * x;
    return den >= 1e-10f ? 2.0f / (den * den) : 0.0f;
}

// d spacing_pw(t) / dt
__device__ inline float spacing_slope(float t) { return t < 1.0f ? 0.5f : 0.5f / (t * t); }

// Ray r of the group (column gr), by its warp: the samples' gradients
// summed into g_o and g_d (the positions o + d mid, the SH), and through
// the midpoints and deltas into the bin edges, the spacing warp's inverse
// and s_near, s_far into g_near and g_far.
__device__ inline void ray_grads(int r, long long gr, long long n, int s2, const float* eb, const float* ray,
                                 const float* gp, const float* gdsh, const float* g_delta,
                                 const float* __restrict__ sbins, const float* __restrict__ near,
                                 const float* __restrict__ far, float* __restrict__ g_o, float* __restrict__ g_d,
                                 float* __restrict__ g_near, float* __restrict__ g_far, int lane) {
    const float* e = eb + r * (s2 + 1);
    const float* rr = ray + r * 8;
    float sum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // g_o, g_d, g_s_near, g_s_far
    for (int s = lane; s < s2; s += 32) {
        const int j = r * s2 + s;
        const float mid = (e[s] + e[s + 1]) / 2.0f;
        float g_mid = 0.0f;
        for (int k = 0; k < 3; ++k) {
            const float gpk = gp[j * 3 + k];
            sum[k] += gpk;
            sum[3 + k] += gpk * mid + gdsh[j * 3 + k];
            g_mid += gpk * rr[3 + k];
        }
        const float sb0 = sbins[s * n + gr], sb1 = sbins[(s + 1) * n + gr];
        const float g0 = (0.5f * g_mid - g_delta[j]) * edge_slope(sb0, rr[6], rr[7]);
        const float g1 = (0.5f * g_mid + g_delta[j]) * edge_slope(sb1, rr[6], rr[7]);
        sum[6] += g0 * (1.0f - sb0) + g1 * (1.0f - sb1);
        sum[7] += g0 * sb0 + g1 * sb1;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = warp_sum(sum[k]);
    if (lane == 0) {
        for (int k = 0; k < 3; ++k) {
            g_o[k * n + gr] = sum[k];
            g_d[k * n + gr] = sum[3 + k];
        }
        g_near[gr] = sum[6] * spacing_slope(near[gr]);
        g_far[gr] = sum[7] * spacing_slope(far[gr]);
    }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
field_composite_vjp_kernel(const float* __restrict__ sbins, const float* __restrict__ o,
                           const float* __restrict__ d, const float* __restrict__ near,
                           const float* __restrict__ far, const float* __restrict__ g,
                           const float* __restrict__ emb, int n_emb, long long n,
                           const __grid_constant__ FieldMlp fm, const __grid_constant__ VjpPlan plan,
                           const float* __restrict__ w0, const __grid_constant__ Box bx, int F, int s2, int hdr,
                           float rgb_bias, float* __restrict__ g_o, float* __restrict__ g_d,
                           float* __restrict__ g_near, float* __restrict__ g_far) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const FieldSmem fs = carve_field(smem);
    uint32_t* masks = reinterpret_cast<uint32_t*>(smem + field_smem_bytes(2 * SLAB_BYTES));  // slots
    float* eb = reinterpret_cast<float*>(masks + MASK_SLOTS * plan.mask_words * THREADS);  // RAYS x (s2 + 1)
    float* ray = eb + RAYS * (s2 + 1);        // RAYS x 8: o, d, s_near, s_far
    float* dens = ray + RAYS * 8;             // RAYS x s2: densities, then their raw values' gradients
    float* rgb = dens + RAYS * s2;            // RAYS x s2 x 3: colours, then theirs
    float* g_delta = rgb + RAYS * s2 * 3;     // RAYS x s2
    float* gp = g_delta + RAYS * s2;          // RAYS x s2 x 3
    float* gdsh = gp + RAYS * s2 * 3;         // RAYS x s2 x 3
    unsigned char* flags = reinterpret_cast<unsigned char*>(gdsh + RAYS * s2 * 3);  // RAYS x s2
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const long long groups = (n + RAYS - 1) / RAYS;
    const long long mine = (groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
    VjpRing ring = vjp_ring_start(fs, fm, plan, (int)(mine * 2 * plan.passes * fm.n_chunks));
    for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
        const long long r0 = gi * RAYS;
        const int n_rays = (int)min((long long)RAYS, n - r0), total = n_rays * s2;
        if (t < n_rays) {
            const long long gr = r0 + t;
            for (int k = 0; k < 3; ++k) {
                ray[t * 8 + k] = o[k * n + gr];
                ray[t * 8 + 3 + k] = d[k * n + gr];
            }
            ray[t * 8 + 6] = spacing_pw(near[gr]);
            ray[t * 8 + 7] = spacing_pw(far[gr]);
            euclid_bins(eb + t * (s2 + 1), sbins + gr, n, s2, ray[t * 8 + 6], ray[t * 8 + 7]);
        }
        __syncthreads();
        for (int step = 0, f = 0, b = 0, done = 0; step < 2 * plan.passes; ++step) {
            if ((plan.order >> step) & 1) {
                const Rows rows{bx, eb, ray, dens, rgb, gp, gdsh, PASS_ROWS * b, total, s2, F};
                backward_pass(ring, fm, plan, fs, rows, masks + (b % MASK_SLOTS) * plan.mask_words * THREADS, w0);
                ++b;
            } else {
                const VjpIo io{GroupIo{fs, bx, eb, ray, dens, rgb, emb, 8, PASS_ROWS * f, total, s2, F, n_emb, hdr,
                                       rgb_bias},
                               flags};
                forward_pass(ring, fm, plan, fs, io, masks + (f % MASK_SLOTS) * plan.mask_words * THREADS);
                ++f;
                __syncthreads();  // the pass's densities and colours are in
                const int ready = min(n_rays, PASS_ROWS * f / s2);  // rays with all their samples
                if (warp >= done && warp < ready) {
                    const long long gr = r0 + warp;
                    const float gw[3] = {g[gr], g[n + gr], g[2 * n + gr]};
                    composite_vjp(eb + warp * (s2 + 1), dens + warp * s2, rgb + warp * s2 * 3, flags + warp * s2,
                                  g_delta + warp * s2, gw, s2, hdr, lane);
                }
                done = ready;
                __syncthreads();
            }
        }
        __syncthreads();  // every sample's gradient is in
        if (warp < n_rays)
            ray_grads(warp, r0 + warp, n, s2, eb, ray, gp, gdsh, g_delta, sbins, near, far, g_o, g_d, g_near,
                      g_far, lane);
        __syncthreads();  // the next group overwrites the rays' state
    }
}

// The plan of a packed field at s2 samples; false where the kernel does
// not take it (the host's checks raise first).
static bool make_plan(const FieldMlp& fm, int s2, VjpPlan* plan) {
    *plan = VjpPlan{};
    const int L = fm.n_base + fm.n_head;
    if (s2 < 1 || s2 > MAX_S2) return false;
    if (fm.k_last != 64 && fm.k_last != 128 && fm.k_last != 256) return false;
    int c = 0, words = 0;
    for (int l = L - 1; l >= 0; --l)
        for (int q = 0; q < fm.layer[l].n_chunks; ++q) plan->bwd[c++] = fm.layer[l].first_chunk + q;
    for (int l = 0; l < L; ++l) {
        const WgLayer& y = fm.layer[l];
        if (y.k != 64 && y.k != 128 && y.k != 192 && y.k != 256) return false;
        plan->mask_at[l] = words;
        if (l != fm.n_base - 1) words += y.n / 64;  // every wgmma layer but the base output has a ReLU
    }
    plan->mask_words = words;
    plan->passes = field_passes(RAYS, s2);
    if (2 * plan->passes > 32) return false;
    plan->order = vjp_order(s2, plan->passes);
    // each forward pass's masks are read by its backward pass before the
    // forward pass two later overwrites their slot
    for (int t = 0, f = 0, b = 0; t < 2 * plan->passes; ++t) {
        if ((plan->order >> t) & 1)
            ++b;
        else if (++f - b > MASK_SLOTS)
            return false;
    }
    return true;
}

NEK_ERROR_STRING_FN

static Occupancy occ;

// Blocks per SM, SM count and dynamic shared memory of the kernel at s2
// with mask_words mask words a thread a pass.
extern "C" int nek_field_composite_vjp_occupancy(int s2, int mask_words, int* blocks_per_sm, int* sms,
                                                 long long* smem) {
    const size_t bytes = vjp_smem_bytes(s2, mask_words);
    const cudaError_t e = occupancy(field_composite_vjp_kernel, bytes, &occ);
    *blocks_per_sm = occ.per_sm;
    *sms = occ.sms;
    *smem = (long long)bytes;
    return (int)e;
}

// w0: the base output layer's density column as its bf16 values (f32, the
// base's last hidden width); g: (3, n); g_o, g_d: (3, n); g_near, g_far: (n)
extern "C" int nek_field_composite_vjp(const float* sbins, const float* o, const float* d, const float* near,
                                       const float* far, const float* g, const float* emb, int n_emb,
                                       long long n, const int* field_dims, const long long* field_ptrs,
                                       const float* w0, const float* box, int F, int s2, int hdr,
                                       float rgb_bias, float* g_o, float* g_d, float* g_near, float* g_far,
                                       void* stream) {
    FieldMlp fm;
    VjpPlan plan;
    if (!make_field_mlp(field_dims, field_ptrs, &fm) || fm.n_last != 3 || fm.layer[fm.n_base].k < 31 + n_emb ||
        !make_plan(fm, s2, &plan))
        return (int)cudaErrorInvalidValue;
    const size_t smem = vjp_smem_bytes(s2, plan.mask_words);
    cudaError_t e = occupancy(field_composite_vjp_kernel, smem, &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long groups = (n + RAYS - 1) / RAYS;
    const long long resident = (long long)occ.per_sm * occ.sms;
    const long long blocks = groups < resident ? groups : resident;
    if (blocks > 0)
        field_composite_vjp_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
            sbins, o, d, near, far, g, emb, n_emb, n, fm, plan, w0, make_box(box), F, s2, hdr, rgb_bias, g_o, g_d,
            g_near, g_far);
    return (int)cudaGetLastError();
}
