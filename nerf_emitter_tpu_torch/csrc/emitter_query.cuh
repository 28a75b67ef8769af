// The per-ray and per-group device code of the emitter query, shared by K3
// (proposal.cu), K4 (field_composite.cu), K5 (mega_pipeline.cu) and the
// profiling kernels P2 (proposal.cu, `proposal_variant`) and P3
// (resample.cu).
//
// Proposals (kernel A of nerf_emitter_tpu/ops/mega_query.py): per ray, s0+1
// uniform spacing bins between near and far under the piecewise warp;
// level-0 density at the s0 bin midpoints; weights alpha * exp(-exclusive
// cumsum); deterministic inverse-CDF resample to s1+1 bins (histogram pad
// 0.01, eps 1e-5, u_i = i (1-eps)/n + 1/(2(n+1))); level-1 density; the same
// resample to s2+1 bins. A group of 8 rays runs its densities on
// density_mlp.cuh's wgmma block (`ProposalIo` rows) and its per-ray steps
// one warp a ray.
//
// Field and composite (kernel B): spacing bins -> euclidean bins -> s2
// midpoint positions; base MLP + SH / appearance head; weights; rgb =
// sum(w rgb) + rgb_last (1 - acc).
//
// K5 must reproduce K3 + K4 bit for bit: every f32 step that feeds the bins
// and the answer lives here once, so all kernels compile the same
// expressions. The steps that place samples (the bin warp, the positions,
// the transmittance sum and the resample's interpolation) are pinned to
// separate f32 multiplies and adds (__fmul_rn, __fadd_rn), the rounding of
// the plain PyTorch twins: a fused multiply-add there moves a midpoint by
// an ulp, which can carry it across the scene-box face, flip its keep mask
// and move the ray's CDF by a whole sample's weight.
#pragma once

#include "density_mlp.cuh"

namespace nek {

enum ProposalMode { kFull = 0, kDensOnly = 1, kResampleOnly = 2 };

constexpr int GROUP_RAYS = FIELD_RAYS;  // rays per proposal group: one warp each
static_assert(GROUP_RAYS == WARPS, "the per-ray steps run one warp a ray");
constexpr unsigned FULL_MASK = 0xffffffffu;

// The proposal state of a group: per-ray rows of smax+1 floats.
struct ProposalSmem {
    float* sb_a;   // rays x (smax + 1) spacing bins
    float* sb_b;
    float* eb;     // rays x (smax + 1) euclidean bins of the current level
    float* cdf;    // rays x (smax + 1)
    float* dens;   // rays x smax: densities, then weights
    float* ray;    // rays x 8: o (3), d (3), s_near, s_far
    float* end;    // first float after the proposal state
};

__host__ __device__ inline size_t proposal_state_bytes(int smax, int rays) {
    return sizeof(float) * rays * (4 * (smax + 1) + smax + 8);
}

__device__ inline ProposalSmem carve_proposal(float* state, int smax, int rays) {
    ProposalSmem p;
    const int row = smax + 1;
    p.sb_a = state;
    p.sb_b = p.sb_a + rays * row;
    p.eb = p.sb_b + rays * row;
    p.cdf = p.eb + rays * row;
    p.dens = p.cdf + rays * row;
    p.ray = p.dens + rays * smax;
    p.end = p.ray + rays * 8;
    return p;
}

// The proposal stage's density block: one pack per level (the level's
// proposal MLP, 1024-aligned, DENSITY_PACK_SPAN apart) sharing one work
// area, whose mbarrier both packs' copies complete on.
struct ProposalDensity {
    DensitySmem level[2];

    __device__ uint32_t bar() const { return level[0].bar(); }
};

__device__ inline ProposalDensity proposal_density(unsigned char* packs, unsigned char* work) {
    return ProposalDensity{{DensitySmem{packs, work}, DensitySmem{packs + DENSITY_PACK_SPAN, work}}};
}

// Thread 0: the bulk copies of both levels' packs (kernels.DensityPack
// buffers, 16-byte aligned), one phase of the mbarrier.
__device__ inline void load_proposal_packs(const ProposalDensity& pd, const unsigned char* pack0,
                                           const unsigned char* pack1) {
    mbar_expect_tx(pd.bar(), 2 * DENSITY_PACK);
    bulk_load(smem_u32(pd.level[0].pack), pack0, DENSITY_PACK, pd.bar());
    bulk_load(smem_u32(pd.level[1].pack), pack1, DENSITY_PACK, pd.bar());
}

// The rows of one proposal density tile: row j of a level is ray j / S,
// bin j % S, at the midpoint of the ray's euclidean bins (row stride
// smax+1); rows past the group's n_rays x S encode zeros and write nothing.
struct ProposalIo {
    const Box& bx;
    const float* eb;
    const float* ray;  // the group's rays, 8 floats each
    float* dens;       // rays x smax
    int c0, total, S, smax, F;  // first row of the tile; rows of the level

    __device__ bool encode(unsigned char* slab, int row, int half) const {
        const int j = c0 + row;
        if (j >= total) {
            for (int c = half; c < 3 + 6 * F; c += 2) st_bf16(slab, row, c, 0.0f);
            return false;
        }
        const int r = j / S, s = j % S;
        const float* e = eb + r * (smax + 1);
        const float mid = (e[s] + e[s + 1]) / 2.0f;
        float p[3], x2[3];
        for (int k = 0; k < 3; ++k) p[k] = __fadd_rn(ray[r * 8 + k], __fmul_rn(ray[r * 8 + 3 + k], mid));
        const bool keep = contract_and_select(bx, p, x2);
        encode_row(slab, row, half, x2, F, 3 + 6 * F);  // no padding: it stays zero
        return keep;
    }

    __device__ void density(int row, float raw, bool keep) const {
        const int j = c0 + row;
        if (j < total) dens[(j / S) * smax + j % S] = density_of(raw, keep, bx.avg_density);
    }
};

// ---------------------------------------------------------------------------
// the per-ray steps, one warp a ray: lane l takes elements l, l + 32, ...
// ---------------------------------------------------------------------------

// Inclusive sum over the warp's lanes: Hillis-Steele, five shifted adds
// (the TPU kernel's own scan, nerf_emitter_tpu/ops/mega_query.py
// `_cumsum_rows`, over 32 lanes)
__device__ __forceinline__ float warp_incl_sum(float x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_up_sync(FULL_MASK, x, off);
        if (lane >= off) x = __fadd_rn(x, y);
    }
    return x;
}

// Sum over the warp's lanes by butterfly; every lane gets the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int m = 16; m > 0; m /= 2) x = __fadd_rn(x, __shfl_xor_sync(FULL_MASK, x, m));
    return x;
}

__device__ __forceinline__ float euclid_bin(float sb, float sn, float sf) {
    return spacing_pw_inv(__fadd_rn(__fmul_rn(sb, sf - sn), sn));
}

// n+1 spacing bins sb (element stride `stride`) -> euclidean bins eb, the
// elements first, first + step, ... (a warp passes its lane and 32)
__device__ inline void euclid_bins(float* eb, const float* sb, long long stride, int n, float sn,
                                   float sf, int first = 0, int step = 1) {
    for (int i = first; i <= n; i += step) eb[i] = euclid_bin(sb[i * stride], sn, sf);
}

// One ray's weights from its densities, by its warp: w (S, in place over
// the densities) = alpha * exp(-exclusive cumsum) with the deltas of the
// S+1 euclidean bins. The cumsum runs over 32-sample strips: a warp scan
// of the strip, plus the sum of the strips before it.
__device__ inline void ray_weights(float* w, const float* eb, int S, int lane) {
    float carry = 0.0f;
    for (int base = 0; base < S; base += 32) {
        const int s = base + lane;
        const float dd = s < S ? __fmul_rn(w[s], eb[s + 1] - eb[s]) : 0.0f;
        const float incl = warp_incl_sum(dd, lane);
        const float before = __shfl_up_sync(FULL_MASK, incl, 1);
        const float excl = __fadd_rn(carry, lane == 0 ? 0.0f : before);
        if (s < S) w[s] = (1.0f - expf(-dd)) * expf(-excl);
        carry = __fadd_rn(carry, __shfl_sync(FULL_MASK, incl, 31));
    }
}

// One ray's CDF (S+1) of S given weights (padded in place by the histogram
// pad), by its warp: the weights' sum by lane partials and a butterfly,
// the pdf's running sum by strips as in ray_weights.
__device__ inline void build_cdf(float* w, float* cdf, int S, int lane) {
    float part = 0.0f;
    for (int s = lane; s < S; s += 32) {
        w[s] += HIST_PAD;
        part += w[s];
    }
    float w_sum = warp_sum(part);
    const float padding = fmaxf(PDF_EPS - w_sum, 0.0f);
    w_sum += padding;
    float carry = 0.0f;
    for (int base = 0; base < S - 1; base += 32) {
        const int s = base + lane;
        const float pdf = s < S - 1 ? (w[s] + padding / S) / w_sum : 0.0f;
        const float incl = __fadd_rn(carry, warp_incl_sum(pdf, lane));
        if (s < S - 1) cdf[s + 1] = fminf(1.0f, incl);
        carry = __shfl_sync(FULL_MASK, incl, 31);
    }
    if (lane == 0) {
        cdf[0] = 0.0f;
        cdf[S] = 1.0f;
    }
}

// u_i of the deterministic resample to n_out bins
__device__ inline float resample_u(int i, int n_out) {
    const double step = (1.0 - 1e-5) / n_out, u0 = 1.0 / (2.0 * (n_out + 1));
    return (float)(i * step + u0);
}

// One ray's inverse CDF, by its warp: S given weights w (clobbered) over
// spacing bins sb_in (S+1) -> sb_out (n_out+1); cdf is S+1 scratch. The
// TPU kernel's telescoped ramp sum is replaced by an exact per-segment
// interpolation: the same function without the ramp form's cancellation.
// Each u_i finds its segment b by binary search, the count of cdf[1..S-1]
// at or below it (torch.searchsorted(right=True), as the twin).
__device__ inline void inverse_cdf(float* w, float* cdf, int S, const float* sb_in, int n_out,
                                   float* sb_out, int lane) {
    build_cdf(w, cdf, S, lane);
    __syncwarp();
    for (int i = lane; i <= n_out; i += 32) {
        const float u = resample_u(i, n_out);
        int lo = 1, hi = S;  // the first k in [1, S) with cdf[k] > u, else S
        while (lo < hi) {
            const int mid = (lo + hi) / 2;
            if (cdf[mid] <= u)
                lo = mid + 1;
            else
                hi = mid;
        }
        const int b = lo - 1;
        const float frac = fminf(fmaxf((u - cdf[b]) / fmaxf(cdf[b + 1] - cdf[b], PDF_EPS), 0.0f), 1.0f);
        sb_out[i] = __fadd_rn(sb_in[b], __fmul_rn(sb_in[b + 1] - sb_in[b], frac));
    }
}

// One proposal level of the group: densities at p.eb on the density block
// `ds` (or, in kResampleOnly, 0.3 x the far bin edge), then per ray, by its
// warp, the weights and the resample of sb_in (S+1) to sb_out (n_out+1)
// (or, in kDensOnly, uniform bins i/n_out), and with next_eb the euclidean
// bins of sb_out in p.eb. The pack must have arrived. All threads call it;
// it ends with a barrier.
template <int MODE>
__device__ inline void proposal_level(const ProposalSmem& p, const DensitySmem& ds, const Box& bx,
                                      int F, int S, int n_out, int n_rays, int smax, float* sb_in,
                                      float* sb_out, bool next_eb) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row = smax + 1;
    if (MODE != kResampleOnly) {
        const int wg = threadIdx.x / 128, total = n_rays * S;
        bool ready = true;
        for (int c0 = 0; c0 < total; c0 += PASS_ROWS)
            density_tile(ds, ProposalIo{bx, p.eb, p.ray, p.dens, c0 + wg * WG_ROWS, total, S, smax, F}, wg,
                         ready);
        __syncthreads();  // every density is in
    }
    if (warp < n_rays) {
        float* w = p.dens + warp * smax;
        float* eb = p.eb + warp * row;
        float* out = sb_out + warp * row;
        if (MODE == kResampleOnly)
            for (int s = lane; s < S; s += 32) w[s] = eb[s + 1] * 0.3f;
        ray_weights(w, eb, S, lane);
        __syncwarp();  // the lanes' reads of eb are done
        if (MODE == kDensOnly)
            for (int i = lane; i <= n_out; i += 32) out[i] = (float)i / (float)n_out;
        else
            inverse_cdf(w, p.cdf + warp * row, S, sb_in + warp * row, n_out, out, lane);
        // each lane reads the bins it wrote
        if (next_eb) euclid_bins(eb, out, 1, n_out, p.ray[warp * 8 + 6], p.ray[warp * 8 + 7], lane, 32);
    }
    __syncthreads();
}

// Kernel A for the n_rays rays from r0 of (3, n) / (1, n) ray arrays: the
// final s2+1 spacing bins land in p.sb_a (row stride smax+1). The packs of
// `pd` arrive on the phase of its mbarrier with parity `parity`. All
// threads call it; it ends with a barrier.
template <int MODE>
__device__ inline void proposal_group(const ProposalSmem& p, const ProposalDensity& pd, int parity,
                                      const float* __restrict__ o, const float* __restrict__ d,
                                      const float* __restrict__ near, const float* __restrict__ far,
                                      long long n, long long r0, int n_rays, const Box& bx, int F0,
                                      int F1, int s0, int s1, int s2, int smax) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row = smax + 1;
    if (warp < n_rays) {
        const long long g = r0 + warp;
        float* ray = p.ray + warp * 8;
        if (lane < 3)
            ray[lane] = o[lane * n + g];
        else if (lane < 6)
            ray[lane] = d[(lane - 3) * n + g];
        else if (lane < 8)
            ray[lane] = spacing_pw(lane == 6 ? near[g] : far[g]);
        __syncwarp();
        float* sb = p.sb_a + warp * row;
        float* eb = p.eb + warp * row;
        for (int i = lane; i <= s0; i += 32) {
            const float v = (float)i / (float)s0;
            sb[i] = v;
            eb[i] = euclid_bin(v, ray[6], ray[7]);
        }
    }
    mbar_wait(pd.bar(), parity);
    __syncthreads();
    proposal_level<MODE>(p, pd.level[0], bx, F0, s0, s1, n_rays, smax, p.sb_a, p.sb_b, true);
    proposal_level<MODE>(p, pd.level[1], bx, F1, s1, s2, n_rays, smax, p.sb_b, p.sb_a, false);
}

// Kernel B's field, one pass of 128 samples of a ray group: the rows of
// field_mlp.cuh `wg_field_pass`. Sample j of the group is ray j / s2, bin
// j % s2; eb holds the group's euclidean bins (row stride s2+1), ray its
// o and d at r * ray_stride.
struct GroupIo {
    const FieldSmem fs;
    const Box& bx;
    const float* eb;
    const float* ray;
    float* dens;
    float* rgb;
    const float* __restrict__ emb;
    int ray_stride, c0, total, s2, F, n_emb, hdr;
    float rgb_bias;

    __device__ int sample(int wg, int row) const { return c0 + wg * WG_ROWS + row; }

    __device__ void encode(unsigned char* slab, int wg, int row, int half, int kpad) const {
        const int j = sample(wg, row);
        const bool valid = j < total;
        const int r = valid ? j / s2 : 0, si = valid ? j % s2 : 0;
        float p[3] = {0.0f, 0.0f, 0.0f}, x2[3];
        if (valid) {
            const float mid = (eb[r * (s2 + 1) + si] + eb[r * (s2 + 1) + si + 1]) / 2.0f;
            for (int k = 0; k < 3; ++k)
                p[k] = __fadd_rn(ray[r * ray_stride + k], __fmul_rn(ray[r * ray_stride + 3 + k], mid));
        }
        const bool keep = contract_and_select(bx, p, x2) && valid;
        if (half == 0) fs.keep()[wg * WG_ROWS + row] = keep;
        encode_row(slab, row, half, x2, F, kpad);
    }

    // the head input [SH 16, geo 15 (written by the base output), emb]
    __device__ void head_in(unsigned char* slab, int wg, int row, int half, int kpad) const {
        const int j = sample(wg, row);
        if (half == 0) {
            const float* dr = ray + (j < total ? j / s2 : 0) * ray_stride + 3;
            float sh[16];
            sh4(dr[0], dr[1], dr[2], sh);
            for (int q = 0; q < 16; ++q) st_bf16(slab, row, q, sh[q]);
        } else {
            for (int q = 0; q < n_emb; ++q) st_bf16(slab, row, 31 + q, emb[q]);
            for (int q = 31 + n_emb; q < kpad; ++q) st_bf16(slab, row, q, 0.0f);
        }
    }

    __device__ void density(int wg, int row, float raw) const {
        const int j = sample(wg, row);
        if (j < total) dens[j] = density_of(raw, fs.keep()[wg * WG_ROWS + row], bx.avg_density);
    }

    __device__ void colour(int wg, int row, int o, float raw) const {
        const int j = sample(wg, row);
        if (j < total) rgb[j * 3 + o] = rgb_of(raw, hdr, rgb_bias);
    }

    __device__ void base_value(int, int, int, float) const {}
    __device__ void dump(const unsigned char*, int, int, int, int, int) const {}
};

// passes of the field for a group of n_rays rays of s2 samples
__host__ __device__ inline int field_passes(int n_rays, int s2) {
    return (n_rays * s2 + PASS_ROWS - 1) / PASS_ROWS;
}

// chunks the block's ring takes over the groups g = first, first + stride,
// ... below `groups` (rays per group `rays`, n rays in all)
__device__ inline int ring_total(long long first, long long stride, long long groups, long long n,
                                 int rays, int s2, int per_pass) {
    int total = 0;
    for (long long g = first; g < groups; g += stride)
        total += field_passes((int)min((long long)rays, n - g * rays), s2) * per_pass;
    return total;
}

// Kernel B's field for the n_rays rays of a group: per-sample density into
// dens (n_rays x s2) and colour into rgb (n_rays x s2 x 3), in passes of
// 128 samples through the wgmma field (field_mlp.cuh). All threads call it;
// it ends with a barrier.
__device__ inline void field_group(Ring& ring, const FieldMlp& fm, const FieldSmem& fs,
                                   const float* eb, const float* ray, int ray_stride, float* dens,
                                   float* rgb, int n_rays, const Box& bx,
                                   const float* __restrict__ emb, int n_emb, int F, int s2, int hdr,
                                   float rgb_bias) {
    const int total = n_rays * s2;
    for (int c0 = 0; c0 < total; c0 += PASS_ROWS) {
        const GroupIo io{fs, bx, eb, ray, dens, rgb, emb, ray_stride, c0, total, s2, F, n_emb, hdr,
                         rgb_bias};
        wg_field_pass(ring, fm, fs, io, FIELD_MAX_LAYERS + 1);
    }
    __syncthreads();
}

// One ray's composite from its euclidean bins e (s2+1), densities and
// colours: rgb_out (3, n) at column g, and with aux_out (4, n) the
// accumulation and the last-sample colour.
__device__ inline void composite_ray(const float* e, const float* dens, const float* rgb, int s2,
                                     long long n, long long g, float* __restrict__ rgb_out,
                                     float* __restrict__ aux_out) {
    float excl = 0.0f, acc = 0.0f, comp[3] = {0.0f, 0.0f, 0.0f};
    for (int si = 0; si < s2; ++si) {
        const float dd = dens[si] * (e[si + 1] - e[si]);
        const float w = (1.0f - expf(-dd)) * expf(-excl);
        excl += dd;
        acc += w;
        for (int k = 0; k < 3; ++k) comp[k] += w * rgb[si * 3 + k];
    }
    const float* bg = rgb + (s2 - 1) * 3;
    for (int k = 0; k < 3; ++k) rgb_out[k * n + g] = comp[k] + bg[k] * (1.0f - acc);
    if (aux_out) {
        aux_out[g] = acc;
        for (int k = 0; k < 3; ++k) aux_out[(k + 1) * n + g] = bg[k];
    }
}

}  // namespace nek
