// Per-edge graph attention for Hopper (sm_90a), in two score modes:
//   additive (GAT):  s_e = leaky(a_dst[r, h] + a_src[src_e, h])
//   dot (UniMP's TransformerConv, GAT's many-head fallback):
//                    s_e = leaky(q[r, h-slice] . k[src_e, h-slice])
// for edge e into row r and head h, then
//   out[r]  = sum_e keep_e * softmax_r(s)_e * v[src_e] / (1 - rate)
//   lse[r]  = log sum_e exp(s_e)                             (per head)
// and its flash-style backward.
//
// Replaces the TPU kernels of pgl_tpu/ops/pallas/attention_kernels.py in
// both modes (`fused_gat_attention`, `fused_graph_attention`):
// `_attn_kernel` (:86, forward, K9), `_attn_bwd_dq_kernel` (:288, the CSC
// pass: d a_dst, or dq = sum_e ds_e k[src_e]) and `_attn_bwd_dkv_kernel`
// (:403, the CSR pass: d a_src or dk = sum_e ds_e q[dst_e], and dv) (K10).
//
// What bounds it: bytes and latency, not arithmetic. Per edge the forward
// reads one index, H scores (additive) or the H * dsh columns of k, and the
// C = H * dvh values of the source row; the backward passes read as much
// again plus the cotangent row. In dot mode at UniMP's width (2 heads of
// 128) that is 2 KB of gathered rows an edge, so the gathers, not the
// per-edge arithmetic (a few exps per column), set the pace. The design:
//   * one warp walks one piece of at most ET edges of a row, the work list
//     of `segment_kernels.cut_rows` built on the host, so a hub row (38% of
//     the edges of the bench GAT graph) spreads over many SMs; there is no
//     [E, C] gathered stream in device memory (the TPU kernels DMA one);
//     each gathered row is read by the warp's lanes on neighbouring
//     addresses (128-byte transactions);
//   * lanes take "slots": head h owns a power-of-two group of consecutive
//     slots (dvh_p in additive mode; max(dsh_p, dvh_p) in dot mode, score
//     and value columns in the same slots), slot j = lane + 32 k, so the
//     lanes of one head sit in one aligned group and a per-head dot product
//     (q . k, g . v) is a shuffle reduction inside the group (<= 32 slots)
//     or a sum in the lane and then across the warp (`head_sum`);
//   * the dot score is one device function (`head_dot`) with the same slot
//     map and tree in all three passes, so the backward's p = exp(s - lse)
//     sees the forward's bits (the reference runs its score dots at HIGHEST
//     precision for the same reason);
//   * the forward keeps an online (max, sum, acc) per slot, the backward
//     recomputes p = exp(s - lse) from the saved lse;
//   * the dot-mode K10-dkv (`dot_dkv_staged`), the largest of them, stages
//     each edge's q | g rows and its lse and delta in a shared-memory ring
//     by cp.async two steps ahead of the step it computes, two edges a step
//     at UniMP's shape, so its registers hold no loads in flight (at most
//     128 up to NC = 8: two blocks of 8 warps an SM);
//   * a row of one piece stores its result directly, an empty row stores
//     zeros (out and lse, as the reference); a row of several pieces stores
//     per-piece partials that a second launch merges in piece order
//     (rescaled by exp(m_i - m) in the forward, summed in the backward). No
//     float atomics: every run gives the same bits.
//
// Attention dropout is the reference's counter hash `_drop_keep` of the
// edge's CSC position, seed and head, in uint32 arithmetic (the reference's
// int32 wrap-around and logical shifts). The CSC passes use the edge's own
// position; the CSR pass reads it from `eidx` (the reference's `perm`).
// The softmax sum stays undropped; `acc`, the dv term and the g.v term use
// the dropped probability, the delta term the undropped one.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes outputs and partials), and returns
// cudaGetLastError(). `thresh` < 0 turns dropout off.

#include "attention_common.cuh"

namespace {

// K9, one warp per CSC piece (row, begin, end, slot).
template <int NC, int U>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_pieces(const float* __restrict__ a_dst,
               const float* __restrict__ a_src, const float* __restrict__ v,
               const int* __restrict__ indices,
               const int4* __restrict__ pieces, int n_pieces, int H, int dvh,
               int dvh_p, float slope, const int* __restrict__ seed_p,
               int thresh, float inv_keep, float* __restrict__ out,
               float* __restrict__ lse, float* __restrict__ partials) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const Slots<NC> sl(lane, H, dvh, dvh_p);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;

  float ad[NC], m[NC], l[NC], acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    ad[k] = __ldg(a_dst + static_cast<size_t>(pc.x) * H + sl.head[k]);
    m[k] = kMaskValue;
    l[k] = 0.f;
    acc[k] = 0.f;
  }
  // each lane holds one index of the current 32-edge batch
  int mine = lane < pc.z - pc.y ? __ldg(indices + pc.y + lane) : 0;
  for (long long base = pc.y; base < pc.z; base += 32) {
    const int n = static_cast<int>(min(32LL, pc.z - base));
    const long long next_e = base + 32 + lane;
    const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
    for (int j0 = 0; j0 < n; j0 += U) {
      float as[U][NC], vv[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int s = __shfl_sync(kFull, mine, j & 31);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          as[u][k] = j < n ? __ldg(a_src + static_cast<size_t>(s) * H +
                                   sl.head[k])
                           : 0.f;
          vv[u][k] = (j < n && sl.col[k] >= 0)
                         ? __ldg(v + static_cast<size_t>(s) * C + sl.col[k])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= n) break;  // uniform
        const uint32_t e = static_cast<uint32_t>(base + j);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float s = leaky(ad[k] + as[u][k], slope);
          const float mn = fmaxf(m[k], s);
          const float sc = expf(m[k] - mn);
          const float p = expf(s - mn);
          l[k] = l[k] * sc + p;
          const float pk =
              (!drop || drop_keep(e, seed, sl.hc[k], thresh)) ? p : 0.f;
          acc[k] = acc[k] * sc + pk * vv[u][k];
          m[k] = mn;
        }
      }
    }
    mine = next;
  }
  if (pc.w < 0) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const bool row = l[k] > 0.f;  // an empty row stores zeros
      if (sl.col[k] >= 0)
        out[static_cast<size_t>(pc.x) * C + sl.col[k]] =
            row ? acc[k] * (inv_keep / fmaxf(l[k], 1e-30f)) : 0.f;
      if (sl.lead[k])
        lse[static_cast<size_t>(pc.x) * H + sl.head[k]] =
            row ? m[k] + logf(l[k]) : 0.f;
    }
  } else {
    // partial row: acc [C] | m [H] | l [H]
    float* part = partials + static_cast<size_t>(pc.w) * (C + 2 * H);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sl.col[k] >= 0) part[sl.col[k]] = acc[k];
      if (sl.lead[k]) {
        part[C + sl.head[k]] = m[k];
        part[C + H + sl.head[k]] = l[k];
      }
    }
  }
}

// K10-dq, one warp per CSC piece: d a_dst[r, h] = sum_e ds_e.
template <int NC, int U>
__global__ void __launch_bounds__(kWarps * 32)
gat_dq_pieces(const float* __restrict__ a_dst,
              const float* __restrict__ a_src, const float* __restrict__ v,
              const float* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta,
              const int* __restrict__ indices,
              const int4* __restrict__ pieces, int n_pieces, int H, int dvh,
              int dvh_p, float slope, const int* __restrict__ seed_p,
              int thresh, float inv_keep, float* __restrict__ da_dst,
              float* __restrict__ partials) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;
  const int lane = threadIdx.x & 31;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const Slots<NC> sl(lane, H, dvh, dvh_p);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;

  float ad[NC], ls[NC], dl[NC], gr[NC], da[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const size_t rh = static_cast<size_t>(pc.x) * H + sl.head[k];
    ad[k] = __ldg(a_dst + rh);
    ls[k] = __ldg(lse + rh);
    dl[k] = __ldg(delta + rh);
    gr[k] = sl.col[k] >= 0
                ? __ldg(g + static_cast<size_t>(pc.x) * C + sl.col[k])
                : 0.f;
    da[k] = 0.f;
  }
  int mine = lane < pc.z - pc.y ? __ldg(indices + pc.y + lane) : 0;
  for (long long base = pc.y; base < pc.z; base += 32) {
    const int n = static_cast<int>(min(32LL, pc.z - base));
    const long long next_e = base + 32 + lane;
    const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
    for (int j0 = 0; j0 < n; j0 += U) {
      float as[U][NC], vv[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int s = __shfl_sync(kFull, mine, j & 31);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          as[u][k] = j < n ? __ldg(a_src + static_cast<size_t>(s) * H +
                                   sl.head[k])
                           : 0.f;
          vv[u][k] = (j < n && sl.col[k] >= 0)
                         ? __ldg(v + static_cast<size_t>(s) * C + sl.col[k])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= n) break;  // uniform
        const uint32_t e = static_cast<uint32_t>(base + j);
        float gv[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) gv[k] = gr[k] * vv[u][k];
        head_sum<NC>(gv, dvh_p);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float sr = ad[k] + as[u][k];
          const float p = expf(leaky(sr, slope) - ls[k]);
          const float q =
              drop ? (drop_keep(e, seed, sl.hc[k], thresh) ? p * inv_keep
                                                           : 0.f)
                   : p;
          da[k] += (q * gv[k] - p * dl[k]) * leaky_grad(sr, slope);
        }
      }
    }
    mine = next;
  }
  float* dst = pc.w < 0 ? da_dst + static_cast<size_t>(pc.x) * H
                        : partials + static_cast<size_t>(pc.w) * H;
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if (sl.lead[k]) dst[sl.head[k]] = da[k];
}

// K10-dkv, one warp per CSR piece (the row is the source node s):
// d a_src[s, h] = sum_e ds_e, dv[s, c] = sum_e q_e * g[dst_e, c]. Every
// out-edge reads its destination's a_dst, lse, delta and g row directly,
// and its CSC position from eidx for the dropout hash.
template <int NC, int U>
__global__ void __launch_bounds__(kWarps * 32)
gat_dkv_pieces(const float* __restrict__ a_dst,
               const float* __restrict__ a_src, const float* __restrict__ v,
               const float* __restrict__ g, const float* __restrict__ lse,
               const float* __restrict__ delta,
               const int* __restrict__ indices, const int* __restrict__ eidx,
               const int4* __restrict__ pieces, int n_pieces, int H, int dvh,
               int dvh_p, float slope, const int* __restrict__ seed_p,
               int thresh, float inv_keep, float* __restrict__ da_src,
               float* __restrict__ dv, float* __restrict__ partials) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;
  const int lane = threadIdx.x & 31;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const Slots<NC> sl(lane, H, dvh, dvh_p);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;

  float as[NC], vs[NC], da[NC], dva[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    as[k] = __ldg(a_src + static_cast<size_t>(pc.x) * H + sl.head[k]);
    vs[k] = sl.col[k] >= 0
                ? __ldg(v + static_cast<size_t>(pc.x) * C + sl.col[k])
                : 0.f;
    da[k] = 0.f;
    dva[k] = 0.f;
  }
  const bool has = lane < pc.z - pc.y;
  int mine = has ? __ldg(indices + pc.y + lane) : 0;
  int mpos = has && drop ? __ldg(eidx + pc.y + lane) : 0;
  for (long long base = pc.y; base < pc.z; base += 32) {
    const int n = static_cast<int>(min(32LL, pc.z - base));
    const long long next_e = base + 32 + lane;
    const bool nhas = next_e < pc.z;
    const int next = nhas ? __ldg(indices + next_e) : 0;
    const int npos = nhas && drop ? __ldg(eidx + next_e) : 0;
    for (int j0 = 0; j0 < n; j0 += U) {
      float ad[U][NC], ls[U][NC], dl[U][NC], gd[U][NC];
      uint32_t pos[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int d = __shfl_sync(kFull, mine, j & 31);
        pos[u] = static_cast<uint32_t>(__shfl_sync(kFull, mpos, j & 31));
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const size_t dh = static_cast<size_t>(d) * H + sl.head[k];
          ad[u][k] = j < n ? __ldg(a_dst + dh) : 0.f;
          ls[u][k] = j < n ? __ldg(lse + dh) : 0.f;
          dl[u][k] = j < n ? __ldg(delta + dh) : 0.f;
          gd[u][k] = (j < n && sl.col[k] >= 0)
                         ? __ldg(g + static_cast<size_t>(d) * C + sl.col[k])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= n) break;  // uniform
        float gv[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) gv[k] = gd[u][k] * vs[k];
        head_sum<NC>(gv, dvh_p);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float sr = ad[u][k] + as[k];
          const float p = expf(leaky(sr, slope) - ls[u][k]);
          const float q =
              drop ? (drop_keep(pos[u], seed, sl.hc[k], thresh)
                          ? p * inv_keep
                          : 0.f)
                   : p;
          da[k] += (q * gv[k] - p * dl[u][k]) * leaky_grad(sr, slope);
          dva[k] += q * gd[u][k];
        }
      }
    }
    mine = next;
    mpos = npos;
  }
  if (pc.w < 0) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sl.lead[k]) da_src[static_cast<size_t>(pc.x) * H + sl.head[k]] = da[k];
      if (sl.col[k] >= 0) dv[static_cast<size_t>(pc.x) * C + sl.col[k]] = dva[k];
    }
  } else {
    // partial row: d a_src [H] | dv [C]
    float* part = partials + static_cast<size_t>(pc.w) * (H + C);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sl.lead[k]) part[sl.head[k]] = da[k];
      if (sl.col[k] >= 0) part[H + sl.col[k]] = dva[k];
    }
  }
}

// Dot-mode K9, one warp per CSC piece (row, begin, end, slot): q's row is
// resident, each edge gathers k's and v's source rows.
template <int NC, int U>
__global__ void __launch_bounds__(kWarps * 32)
dot_fwd_pieces(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ indices,
               const int4* __restrict__ pieces, int n_pieces, int H, int dsh,
               int dvh, int wp, float slope, const int* __restrict__ seed_p,
               int thresh, float inv_keep, float* __restrict__ out,
               float* __restrict__ lse, float* __restrict__ partials) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int DS = H * dsh;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const DotSlots<NC> sl(lane, H, dsh, dvh, wp);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;

  float qr[NC], m[NC], l[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    qr[c] = sl.scol[c] >= 0
                ? __ldg(q + static_cast<size_t>(pc.x) * DS + sl.scol[c])
                : 0.f;
    m[c] = kMaskValue;
    l[c] = 0.f;
    acc[c] = 0.f;
  }
  int mine = lane < pc.z - pc.y ? __ldg(indices + pc.y + lane) : 0;
  for (long long base = pc.y; base < pc.z; base += 32) {
    const int n = static_cast<int>(min(32LL, pc.z - base));
    const long long next_e = base + 32 + lane;
    const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
    for (int j0 = 0; j0 < n; j0 += U) {
      float kk[U][NC], vv[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int s = __shfl_sync(kFull, mine, j & 31);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          kk[u][c] = (j < n && sl.scol[c] >= 0)
                         ? __ldg(k + static_cast<size_t>(s) * DS + sl.scol[c])
                         : 0.f;
          vv[u][c] = (j < n && sl.vcol[c] >= 0)
                         ? __ldg(v + static_cast<size_t>(s) * C + sl.vcol[c])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= n) break;  // uniform
        const uint32_t e = static_cast<uint32_t>(base + j);
        float sd[NC];
        head_dot<NC>(qr, kk[u], wp, sd);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float s = leaky(sd[c], slope);
          const float mn = fmaxf(m[c], s);
          const float sc = expf(m[c] - mn);
          const float p = expf(s - mn);
          l[c] = l[c] * sc + p;
          const float pk =
              (!drop || drop_keep(e, seed, sl.hc[c], thresh)) ? p : 0.f;
          acc[c] = acc[c] * sc + pk * vv[u][c];
          m[c] = mn;
        }
      }
    }
    mine = next;
  }
  if (pc.w < 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool row = l[c] > 0.f;  // an empty row stores zeros
      if (sl.vcol[c] >= 0)
        out[static_cast<size_t>(pc.x) * C + sl.vcol[c]] =
            row ? acc[c] * (inv_keep / fmaxf(l[c], 1e-30f)) : 0.f;
      if (sl.lead[c])
        lse[static_cast<size_t>(pc.x) * H + sl.head[c]] =
            row ? m[c] + logf(l[c]) : 0.f;
    }
  } else {
    // partial row: acc [C] | m [H] | l [H] (the additive mode's, so
    // gat_fwd_combine merges it)
    float* part = partials + static_cast<size_t>(pc.w) * (C + 2 * H);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (sl.vcol[c] >= 0) part[sl.vcol[c]] = acc[c];
      if (sl.lead[c]) {
        part[C + sl.head[c]] = m[c];
        part[C + H + sl.head[c]] = l[c];
      }
    }
  }
}

// Dot-mode K10-dq, one warp per CSC piece: dq[r, h-slice] = sum_e ds_e *
// k[src_e, h-slice], with q's and g's rows and lse and delta resident.
template <int NC, int U>
__global__ void __launch_bounds__(kWarps * 32)
dot_dq_pieces(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ indices,
              const int4* __restrict__ pieces, int n_pieces, int H, int dsh,
              int dvh, int wp, float slope, const int* __restrict__ seed_p,
              int thresh, float inv_keep, float* __restrict__ dq,
              float* __restrict__ partials) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;
  const int lane = threadIdx.x & 31;
  const int DS = H * dsh;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const DotSlots<NC> sl(lane, H, dsh, dvh, wp);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;

  float qr[NC], gr[NC], ls[NC], dl[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const size_t rh = static_cast<size_t>(pc.x) * H + sl.head[c];
    qr[c] = sl.scol[c] >= 0
                ? __ldg(q + static_cast<size_t>(pc.x) * DS + sl.scol[c])
                : 0.f;
    gr[c] = sl.vcol[c] >= 0
                ? __ldg(g + static_cast<size_t>(pc.x) * C + sl.vcol[c])
                : 0.f;
    ls[c] = __ldg(lse + rh);
    dl[c] = __ldg(delta + rh);
    acc[c] = 0.f;
  }
  int mine = lane < pc.z - pc.y ? __ldg(indices + pc.y + lane) : 0;
  for (long long base = pc.y; base < pc.z; base += 32) {
    const int n = static_cast<int>(min(32LL, pc.z - base));
    const long long next_e = base + 32 + lane;
    const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
    for (int j0 = 0; j0 < n; j0 += U) {
      float kk[U][NC], vv[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int s = __shfl_sync(kFull, mine, j & 31);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          kk[u][c] = (j < n && sl.scol[c] >= 0)
                         ? __ldg(k + static_cast<size_t>(s) * DS + sl.scol[c])
                         : 0.f;
          vv[u][c] = (j < n && sl.vcol[c] >= 0)
                         ? __ldg(v + static_cast<size_t>(s) * C + sl.vcol[c])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= n) break;  // uniform
        const uint32_t e = static_cast<uint32_t>(base + j);
        float sd[NC], gv[NC];
        head_dot<NC>(qr, kk[u], wp, sd);
#pragma unroll
        for (int c = 0; c < NC; ++c) gv[c] = gr[c] * vv[u][c];
        head_sum<NC>(gv, wp);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float p = expf(leaky(sd[c], slope) - ls[c]);
          const float qe =
              drop ? (drop_keep(e, seed, sl.hc[c], thresh) ? p * inv_keep
                                                           : 0.f)
                   : p;
          const float ds =
              (qe * gv[c] - p * dl[c]) * leaky_grad(sd[c], slope);
          acc[c] += ds * kk[u][c];
        }
      }
    }
    mine = next;
  }
  float* dst = pc.w < 0 ? dq + static_cast<size_t>(pc.x) * DS
                        : partials + static_cast<size_t>(pc.w) * DS;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (sl.scol[c] >= 0) dst[sl.scol[c]] = acc[c];
}

// Dot-mode K10-dkv, one warp per CSR piece (the row is the source node s):
// dk[s, h-slice] = sum_e ds_e * q[dst_e, h-slice], dv[s, h-slice] =
// sum_e q_e * g[dst_e, h-slice], with k's and v's rows resident in
// registers; every out-edge gathers its destination's q and g rows, lse and
// delta, and its CSC position from eidx for the dropout hash.
//
// The gathers are staged: each warp keeps a ring of kDkvSteps steps of P
// edges in shared memory, an edge's q row | g row | lse | delta (each part
// padded to 16 bytes), and fills it by cp.async (16-byte copies where every
// row is 16-byte aligned, else 4-byte) kDkvSteps - 1 steps ahead of the step
// it computes, so the loads in flight hold no registers. The step's P edges
// are computed together, so their head reductions' shuffles interleave. A
// lane's slots (head, score and value column) are computed from the lane
// and NC, not stored; lse and delta are copied once per head an edge.
// The score is `head_dot(q, k)` on the slot map of `DotSlots`, as in K9 and
// K10-dq, so p = exp(s - lse) sees the forward's bits.
constexpr int kDkvSteps = 3;

template <int NC>
struct DkvEdges {  // P: edges a step
  static constexpr int value = NC <= 2 ? 4 : (NC <= 4 ? 2 : 1);
};

// at most 128 registers (two blocks of 8 warps an SM) up to NC = 8
template <int NC>
struct DkvBlocks {
  static constexpr int value = NC <= 8 ? 2 : 1;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The warp copies n floats from src to dst (both 16-byte aligned when vec).
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n,
                                          bool vec, int lane) {
  if (vec) {
    for (int c = lane; c < n / 4; c += 32) cp_async16(dst + 4 * c, src + 4 * c);
  } else {
    for (int c = lane; c < n; c += 32) cp_async4(dst + c, src + c);
  }
}

// Floats of one staged edge: q [DS] | g [C] | lse [H] | delta [H], each
// part rounded up to 4 floats.
__host__ __device__ __forceinline__ int dkv_edge_floats(int DS, int C, int H) {
  const auto up4 = [](int v) { return (v + 3) & ~3; };
  return up4(DS) + up4(C) + 2 * up4(H);
}

template <int NC>
__host__ __device__ __forceinline__ int dkv_warp_floats(int DS, int C, int H) {
  // the ring, then one int a ring edge (its CSC position), rounded to 4
  constexpr int ring = kDkvSteps * DkvEdges<NC>::value;
  return ring * dkv_edge_floats(DS, C, H) + ((ring + 3) & ~3);
}

// entry `base + lane` of a piece's list `a` from `y` (0 past its n)
__device__ __forceinline__ int piece_entry(const int* __restrict__ a,
                                           int y, int base, int n,
                                           int lane) {
  return base + lane < n ? __ldg(a + y + base + lane) : 0;
}

// FULL: every slot is a real score and value column (dsh == dvh == wp and
// H * wp == 32 NC, as at UniMP's shape), so a slot's column is its index
// and no slot is masked.
template <int NC, bool FULL>
__global__ void __launch_bounds__(kWarps * 32, DkvBlocks<NC>::value)
dot_dkv_staged(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ indices, const int* __restrict__ eidx,
               const int4* __restrict__ pieces, int n_pieces, int H, int dsh,
               int dvh, int wp, bool vec, float slope,
               const int* __restrict__ seed_p, int thresh, float inv_keep,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ partials) {
  constexpr int P = DkvEdges<NC>::value;
  constexpr int S = kDkvSteps;
  extern __shared__ float4 dkv_smem[];
  const int wb = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarps + wb;
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int DS = H * dsh;
  const int C = H * dvh;
  const int ES = dkv_edge_floats(DS, C, H);
  const int o_g = (DS + 3) & ~3;
  const int o_l = o_g + ((C + 3) & ~3);
  const int o_d = o_l + ((H + 3) & ~3);
  float* ring = reinterpret_cast<float*>(dkv_smem) +
                static_cast<size_t>(wb) * dkv_warp_floats<NC>(DS, C, H);
  int* ring_pos = reinterpret_cast<int*>(ring + S * P * ES);
  const int4 pc = pieces[warp];
  const int n = pc.z - pc.y;
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  // slot c of this lane: slot j = lane + 32 c is column j % wp of head
  // j / wp (DotSlots; wp is a power of two)
  const int lwp = __ffs(wp) - 1;
  const int kph = wp > 32 ? wp >> 5 : 1;  // slots of one head in a lane

  float kr[NC], vr[NC], dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
    kr[c] = FULL || (h < H && w < dsh)
                ? __ldg(k + static_cast<size_t>(pc.x) * DS +
                        (FULL ? j : h * dsh + w))
                : 0.f;
    vr[c] = FULL || (h < H && w < dvh)
                ? __ldg(v + static_cast<size_t>(pc.x) * C +
                        (FULL ? j : h * dvh + w))
                : 0.f;
    dka[c] = 0.f;
    dva[c] = 0.f;
  }

  // the issue side's 32-edge batch of destinations (and CSC positions), a
  // lane each, and the batch after it
  int ib = 0;
  int imine = piece_entry(indices, pc.y, 0, n, lane);
  int inext = piece_entry(indices, pc.y, 32, n, lane);
  int pmine = drop ? piece_entry(eidx, pc.y, 0, n, lane) : 0;
  int pnext = drop ? piece_entry(eidx, pc.y, 32, n, lane) : 0;
  const int steps = (n + P - 1) / P;
  // iteration t stages step t + S - 1 into ring slot (t + S - 1) % S (one
  // commit group a step, empty past the piece), then computes step t
  for (int t = 1 - S; t < steps; ++t) {
    const int ts = t + S - 1;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const int j = ts * P + e;
      if (j < n) {  // uniform
        if (j >= ib + 32) {
          ib += 32;
          imine = inext;
          pmine = pnext;
          inext = piece_entry(indices, pc.y, ib + 32, n, lane);
          if (drop) pnext = piece_entry(eidx, pc.y, ib + 32, n, lane);
        }
        const size_t d =
            static_cast<size_t>(__shfl_sync(kFull, imine, j & 31));
        const int pos = __shfl_sync(kFull, pmine, j & 31);
        float* st = ring + ((ts % S) * P + e) * ES;
        stage_row(st, q + d * DS, DS, vec, lane);
        stage_row(st + o_g, g + d * C, C, vec, lane);
        for (int h = lane; h < H; h += 32) {
          cp_async4(st + o_l + h, lse + d * H + h);
          cp_async4(st + o_d + h, delta + d * H + h);
        }
        if (lane == 0) ring_pos[(ts % S) * P + e] = pos;
      }
    }
    cp_async_commit();
    if (t < 0) continue;  // uniform
    cp_async_wait<S - 1>();  // this lane's copies of step t have landed
    __syncwarp();            // and every lane's
    const float* st0 = ring + (t % S) * P * ES;
    // the step's scores and g . v first, their shuffles interleaved; q and
    // g are read again from the ring below rather than held
    float sd[P][NC], gv[P][NC];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const float* st = st0 + e * ES;
      float qd[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
        qd[c] = FULL || (h < H && w < dsh) ? st[FULL ? j : h * dsh + w]
                                           : 0.f;
        gv[e][c] = FULL || (h < H && w < dvh)
                       ? st[o_g + (FULL ? j : h * dvh + w)] * vr[c]
                       : 0.f;
      }
      head_dot<NC>(qd, kr, wp, sd[e]);
      head_sum<NC>(gv[e], wp);
    }
#pragma unroll
    for (int e = 0; e < P; ++e) {
      if (t * P + e >= n) break;  // uniform
      const float* st = st0 + e * ES;
      const uint32_t pos = static_cast<uint32_t>(ring_pos[(t % S) * P + e]);
      // p, its kept value and ds are a head's: computed at the first of
      // the head's kph slots in this lane and kept for the others
      float p = 0.f, qe = 0.f, ds = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
        if ((c & (kph - 1)) == 0) {  // uniform
          const int hd = FULL ? h : min(h, H - 1);
          p = expf(leaky(sd[e][c], slope) - st[o_l + hd]);
          qe = drop ? (drop_keep(pos, seed,
                                 static_cast<uint32_t>(hd) * 0x632BE5ABu,
                                 thresh)
                           ? p * inv_keep
                           : 0.f)
                    : p;
          ds = (qe * gv[e][c] - p * st[o_d + hd]) *
               leaky_grad(sd[e][c], slope);
        }
        if (FULL || (h < H && w < dsh))
          dka[c] += ds * st[FULL ? j : h * dsh + w];
        if (FULL || (h < H && w < dvh))
          dva[c] += qe * st[o_g + (FULL ? j : h * dvh + w)];
      }
    }
    __syncwarp();  // every lane is done with slot t % S before it refills
  }
  cp_async_wait<0>();

  float* pdk = pc.w < 0 ? dk + static_cast<size_t>(pc.x) * DS
                        : partials + static_cast<size_t>(pc.w) * (DS + C);
  float* pdv = pc.w < 0 ? dv + static_cast<size_t>(pc.x) * C : pdk + DS;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
    if (FULL || (h < H && w < dsh)) pdk[FULL ? j : h * dsh + w] = dka[c];
    if (FULL || (h < H && w < dvh)) pdv[FULL ? j : h * dvh + w] = dva[c];
  }
}

}  // namespace

extern "C" int pgl_gat_fwd_f32(int device, const float* a_dst,
                               const float* a_src, const float* v,
                               const int* indices, const int* pieces,
                               int n_pieces, const int* split_rows,
                               const int* split_ptr, int n_split, int H,
                               int dvh, float slope, const int* seed,
                               int thresh, float inv_keep, float* out,
                               float* lse, float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dvh_p = pow2_at_least(dvh);
  const int nc = slots_per_lane(H, dvh_p);
  if (nc == 0 || H <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  PGL_NC_SWITCH(nc, {
    gat_fwd_pieces<NC, unroll_for(NC)><<<blocks_for(n_pieces), kWarps * 32,
                                         0, s>>>(
        a_dst, a_src, v, indices, pc, n_pieces, H, dvh, dvh_p, slope, seed,
        thresh, inv_keep, out, lse, partials);
    if (n_split > 0)
      gat_fwd_combine<NC><<<n_split, CombineWarps<NC>::value * 32, 0, s>>>(
          partials, split_rows, split_ptr, H, dvh, dvh_p, inv_keep, out,
          lse);
  })
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgl_gat_dq_f32(int device, const float* a_dst,
                              const float* a_src, const float* v,
                              const float* g, const float* lse,
                              const float* delta, const int* indices,
                              const int* pieces, int n_pieces,
                              const int* split_rows, const int* split_ptr,
                              int n_split, int H, int dvh, float slope,
                              const int* seed, int thresh, float inv_keep,
                              float* da_dst, float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dvh_p = pow2_at_least(dvh);
  const int nc = slots_per_lane(H, dvh_p);
  if (nc == 0 || H <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  PGL_NC_SWITCH(nc, {
    gat_dq_pieces<NC, unroll_for(NC)><<<blocks_for(n_pieces), kWarps * 32, 0,
                                        s>>>(
        a_dst, a_src, v, g, lse, delta, indices, pc, n_pieces, H, dvh, dvh_p,
        slope, seed, thresh, inv_keep, da_dst, partials);
  })
  if (n_split > 0)
    sum_combine<<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, 0, da_dst, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgl_gat_dkv_f32(int device, const float* a_dst,
                               const float* a_src, const float* v,
                               const float* g, const float* lse,
                               const float* delta, const int* indices,
                               const int* eidx, const int* pieces,
                               int n_pieces, const int* split_rows,
                               const int* split_ptr, int n_split, int H,
                               int dvh, float slope, const int* seed,
                               int thresh, float inv_keep, float* da_src,
                               float* dv, float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dvh_p = pow2_at_least(dvh);
  const int nc = slots_per_lane(H, dvh_p);
  if (nc == 0 || H <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  PGL_NC_SWITCH(nc, {
    gat_dkv_pieces<NC, unroll_for(NC)><<<blocks_for(n_pieces), kWarps * 32,
                                         0, s>>>(
        a_dst, a_src, v, g, lse, delta, indices, eidx, pc, n_pieces, H, dvh,
        dvh_p, slope, seed, thresh, inv_keep, da_src, dv, partials);
  })
  if (n_split > 0)
    sum_combine<<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, H * dvh, da_src, dv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgl_dot_fwd_f32(int device, const float* q, const float* k,
                               const float* v, const int* indices,
                               const int* pieces, int n_pieces,
                               const int* split_rows, const int* split_ptr,
                               int n_split, int H, int dsh, int dvh,
                               float slope, const int* seed, int thresh,
                               float inv_keep, float* out, float* lse,
                               float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int wp = 0;
  const int nc = dot_slots(H, dsh, dvh, &wp);
  const int dvh_p = pow2_at_least(dvh);
  const int ncv = slots_per_lane(H, dvh_p);
  if (nc == 0 || H <= 0 || dsh <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  PGL_NC_SWITCH(nc, {
    dot_fwd_pieces<NC, unroll_for(NC)><<<blocks_for(n_pieces), kWarps * 32,
                                         0, s>>>(
        q, k, v, indices, pc, n_pieces, H, dsh, dvh, wp, slope, seed, thresh,
        inv_keep, out, lse, partials);
  })
  if (n_split > 0) {
    PGL_NC_SWITCH(ncv, {
      gat_fwd_combine<NC><<<n_split, CombineWarps<NC>::value * 32, 0, s>>>(
          partials, split_rows, split_ptr, H, dvh, dvh_p, inv_keep, out,
          lse);
    })
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgl_dot_dq_f32(int device, const float* q, const float* k,
                              const float* v, const float* g,
                              const float* lse, const float* delta,
                              const int* indices, const int* pieces,
                              int n_pieces, const int* split_rows,
                              const int* split_ptr, int n_split, int H,
                              int dsh, int dvh, float slope, const int* seed,
                              int thresh, float inv_keep, float* dq,
                              float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int wp = 0;
  const int nc = dot_slots(H, dsh, dvh, &wp);
  if (nc == 0 || H <= 0 || dsh <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  PGL_NC_SWITCH(nc, {
    dot_dq_pieces<NC, unroll_for(NC)><<<blocks_for(n_pieces), kWarps * 32, 0,
                                        s>>>(
        q, k, v, g, lse, delta, indices, pc, n_pieces, H, dsh, dvh, wp, slope,
        seed, thresh, inv_keep, dq, partials);
  })
  if (n_split > 0)
    sum_combine<<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H * dsh, 0, dq, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgl_dot_dkv_f32(int device, const float* q, const float* k,
                               const float* v, const float* g,
                               const float* lse, const float* delta,
                               const int* indices, const int* eidx,
                               const int* pieces, int n_pieces,
                               const int* split_rows, const int* split_ptr,
                               int n_split, int H, int dsh, int dvh,
                               float slope, const int* seed, int thresh,
                               float inv_keep, float* dk, float* dv,
                               float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int wp = 0;
  const int nc = dot_slots(H, dsh, dvh, &wp);
  if (nc == 0 || H <= 0 || dsh <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(g);
  const bool vec = (H * dsh) % 4 == 0 && (H * dvh) % 4 == 0 && (ptrs & 15) == 0;
  const bool full = dsh == dvh && dsh == wp && H * wp == 32 * nc;
  PGL_NC_SWITCH(nc, {
    const size_t smem =
        sizeof(float) * kWarps * dkv_warp_floats<NC>(H * dsh, H * dvh, H);
    const auto kernel =
        full ? dot_dkv_staged<NC, true> : dot_dkv_staged<NC, false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks_for(n_pieces), kWarps * 32, smem, s>>>(
        q, k, v, g, lse, delta, indices, eidx, pc, n_pieces, H, dsh, dvh, wp,
        vec, slope, seed, thresh, inv_keep, dk, dv, partials);
  })
  if (n_split > 0)
    sum_combine<<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H * dsh, H * dvh, dk, dv);
  return static_cast<int>(cudaGetLastError());
}
