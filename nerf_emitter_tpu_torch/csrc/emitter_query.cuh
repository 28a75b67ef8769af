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
// resample to s2+1 bins.
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

#include "field_mlp.cuh"

namespace nek {

enum ProposalMode { kFull = 0, kDensOnly = 1, kResampleOnly = 2 };

// Shared memory of the proposal stage for `rays` rays: the MLP tile buffers
// and per-ray rows of smax+1 floats.
struct ProposalSmem {
    MlpSmem mlp;
    float* sb_a;   // rays x (smax + 1) spacing bins
    float* sb_b;
    float* eb;     // rays x (smax + 1) euclidean bins of the current level
    float* cdf;    // rays x (smax + 1)
    float* dens;   // rays x smax: densities, then weights
    float* ray;    // rays x 8: o (3), d (3), s_near, s_far
    float* end;    // first float after the proposal state
};

inline size_t proposal_smem_bytes(int ld, int out_max, int smax, int rays) {
    return mlp_smem_bytes(ld, out_max) + sizeof(float) * rays * (4 * (smax + 1) + smax + 8);
}

// The MLP tile buffers at `mlp`, the per-ray rows at `state`.
__device__ inline ProposalSmem carve_proposal(unsigned char* mlp, float* state, int ld, int out_max,
                                              int smax, int rays) {
    ProposalSmem p;
    p.mlp = carve_mlp_smem(mlp, ld, out_max);
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

// The per-ray rows right after the MLP tile buffers.
__device__ inline ProposalSmem carve_proposal(unsigned char* smem, int ld, int out_max, int smax,
                                              int rays) {
    return carve_proposal(smem, carve_mlp_smem(smem, ld, out_max).scratch + WARPS * 256, ld, out_max,
                          smax, rays);
}

// n+1 spacing bins sb (element stride `stride`) -> euclidean bins eb
__device__ inline void euclid_bins(float* eb, const float* sb, long long stride, int n, float sn,
                                   float sf) {
    for (int i = 0; i <= n; ++i)
        eb[i] = spacing_pw_inv(__fadd_rn(__fmul_rn(sb[i * stride], sf - sn), sn));
}

// densities of the n_rays x S samples at the midpoints of p.eb (row stride
// smax+1) into p.dens (row stride smax). All threads call it.
__device__ inline void density_pass(const ProposalSmem& p, const Mlp& mlp, const Box& bx, int F,
                                    int S, int n_rays, int smax, int ld) {
    const int total = n_rays * S;
    for (int c0 = 0; c0 < total; c0 += TILE) {
        const int t = threadIdx.x;
        bool keep = false;
        if (t < TILE) {
            const int j = c0 + t;
            float pt[3] = {0.0f, 0.0f, 0.0f}, x2[3];
            if (j < total) {
                const int r = j / S, sidx = j % S;
                const float* eb = p.eb + r * (smax + 1);
                const float mid = (eb[sidx] + eb[sidx + 1]) / 2.0f;
                const float* ray = p.ray + r * 8;
                for (int k = 0; k < 3; ++k) pt[k] = __fadd_rn(ray[k], __fmul_rn(ray[3 + k], mid));
            }
            keep = contract_and_select(bx, pt, x2) && j < total;
            freq_encode(p.mlp.a + (size_t)t * ld, x2, F, mlp.k[0]);
        }
        run_mlp(mlp, p.mlp, ld);
        if (t < TILE && c0 + t < total)
            p.dens[((c0 + t) / S) * smax + (c0 + t) % S] =
                density_of(p.mlp.out[t], keep, bx.avg_density);
        __syncthreads();
    }
}

// weights from densities: w (S, in place over the densities) =
// alpha * exp(-exclusive cumsum) with the deltas of the S+1 euclidean bins
__device__ inline void ray_weights(float* w, const float* eb, int S) {
    float excl = 0.0f;
    for (int s = 0; s < S; ++s) {
        const float dd = __fmul_rn(w[s], eb[s + 1] - eb[s]);
        w[s] = (1.0f - expf(-dd)) * expf(-excl);
        excl = __fadd_rn(excl, dd);
    }
}

// CDF (S+1) of S given weights (padded in place by the histogram pad)
__device__ inline void build_cdf(float* w, float* cdf, int S) {
    float w_sum = 0.0f;
    for (int s = 0; s < S; ++s) {
        w[s] += HIST_PAD;
        w_sum += w[s];
    }
    const float padding = fmaxf(PDF_EPS - w_sum, 0.0f);
    w_sum += padding;
    float run = 0.0f;
    cdf[0] = 0.0f;
    for (int s = 0; s < S - 1; ++s) {
        run += (w[s] + padding / S) / w_sum;
        cdf[s + 1] = fminf(1.0f, run);
    }
    cdf[S] = 1.0f;
}

// u_i of the deterministic resample to n_out bins
__device__ inline float resample_u(int i, int n_out) {
    const double step = (1.0 - 1e-5) / n_out, u0 = 1.0 / (2.0 * (n_out + 1));
    return (float)(i * step + u0);
}

// Inverse CDF of S given weights w (clobbered) over spacing bins sb_in (S+1)
// -> sb_out (n_out+1); cdf is S+1 scratch. The TPU kernel's telescoped ramp
// sum is replaced by a merge walk of the monotone u grid against the CDF
// and an exact per-segment interpolation: the same function without the
// ramp form's cancellation.
__device__ inline void inverse_cdf(float* w, float* cdf, int S, const float* sb_in, int n_out,
                                   float* sb_out) {
    build_cdf(w, cdf, S);
    int b = 0;
    for (int i = 0; i <= n_out; ++i) {
        const float u = resample_u(i, n_out);
        while (b < S - 1 && cdf[b + 1] <= u) ++b;
        const float frac = fminf(fmaxf((u - cdf[b]) / fmaxf(cdf[b + 1] - cdf[b], PDF_EPS), 0.0f), 1.0f);
        sb_out[i] = __fadd_rn(sb_in[b], __fmul_rn(sb_in[b + 1] - sb_in[b], frac));
    }
}

// One proposal level of the group: densities at p.eb (or, in
// kResampleOnly, 0.3 x the far bin edge), weights, then the resample of
// sb_in (S+1) to sb_out (n_out+1) (or, in kDensOnly, uniform bins i/n_out),
// and with next_eb the euclidean bins of sb_out in p.eb.
template <int MODE>
__device__ inline void proposal_level(const ProposalSmem& p, const Mlp& mlp, const Box& bx, int F,
                                      int S, int n_out, int n_rays, int smax, int ld,
                                      float* sb_in, float* sb_out, bool next_eb) {
    const int t = threadIdx.x, row = smax + 1;
    if (MODE != kResampleOnly) density_pass(p, mlp, bx, F, S, n_rays, smax, ld);
    if (t < n_rays) {
        float* w = p.dens + t * smax;
        const float* eb = p.eb + t * row;
        float* out = sb_out + t * row;
        if (MODE == kResampleOnly)
            for (int s = 0; s < S; ++s) w[s] = eb[s + 1] * 0.3f;
        ray_weights(w, eb, S);
        if (MODE == kDensOnly)
            for (int i = 0; i <= n_out; ++i) out[i] = (float)i / (float)n_out;
        else
            inverse_cdf(w, p.cdf + t * row, S, sb_in + t * row, n_out, out);
        if (next_eb) euclid_bins(p.eb + t * row, out, 1, n_out, p.ray[t * 8 + 6], p.ray[t * 8 + 7]);
    }
    __syncthreads();
}

// Kernel A for the n_rays rays from r0 of (3, n) / (1, n) ray arrays: the
// final s2+1 spacing bins land in p.sb_a (row stride smax+1). All threads
// call it.
template <int MODE>
__device__ inline void proposal_group(const ProposalSmem& p, const float* __restrict__ o,
                                      const float* __restrict__ d, const float* __restrict__ near,
                                      const float* __restrict__ far, long long n, long long r0,
                                      int n_rays, const Mlp& mlp0, const Mlp& mlp1, const Box& bx,
                                      int F0, int F1, int s0, int s1, int s2, int smax, int ld) {
    const int t = threadIdx.x, row = smax + 1;
    if (t < n_rays) {
        float* ray = p.ray + t * 8;
        for (int k = 0; k < 3; ++k) {
            ray[k] = o[k * n + r0 + t];
            ray[3 + k] = d[k * n + r0 + t];
        }
        ray[6] = spacing_pw(near[r0 + t]);
        ray[7] = spacing_pw(far[r0 + t]);
        float* sb = p.sb_a + t * row;
        for (int i = 0; i <= s0; ++i) sb[i] = (float)i / (float)s0;
        euclid_bins(p.eb + t * row, sb, 1, s0, ray[6], ray[7]);
    }
    __syncthreads();
    proposal_level<MODE>(p, mlp0, bx, F0, s0, s1, n_rays, smax, ld, p.sb_a, p.sb_b, true);
    proposal_level<MODE>(p, mlp1, bx, F1, s1, s2, n_rays, smax, ld, p.sb_b, p.sb_a, false);
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
