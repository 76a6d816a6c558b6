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
//   * the forward keeps an online (max, sum, acc), the backward
//     recomputes p = exp(s - lse) from the saved lse;
//   * the three dot-mode kernels (`dot_fwd_staged`, `dot_dq_staged`,
//     `dot_dkv_staged`, in dot_staged.cuh, which the count-matrix dot
//     attention shares in its cell form), the largest of them, stage each
//     edge's gathered rows in a shared-memory ring by cp.async two steps
//     ahead of the step they compute, so their registers hold no loads in
//     flight (at most 128 up to NC = 8: two blocks of 8 warps an SM), and
//     do the softmax work once a head rather than once a slot (the note
//     there);
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
#include "dot_staged.cuh"

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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dot_fwd_run<false>(q, k, v, indices, nullptr, nullptr, pieces,
                            n_pieces, split_rows, split_ptr, n_split, H, dsh,
                            dvh, slope, seed, thresh, inv_keep, out, lse,
                            partials, static_cast<cudaStream_t>(stream));
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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dot_dq_run<false>(q, k, v, g, lse, delta, indices, nullptr, nullptr,
                           pieces, n_pieces, split_rows, split_ptr, n_split,
                           H, dsh, dvh, slope, seed, thresh, inv_keep, dq,
                           partials, static_cast<cudaStream_t>(stream));
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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dot_dkv_run<false>(q, k, v, g, lse, delta, indices, eidx, nullptr,
                            nullptr, pieces, n_pieces, split_rows, split_ptr,
                            n_split, H, dsh, dvh, slope, seed, thresh,
                            inv_keep, dk, dv, partials,
                            static_cast<cudaStream_t>(stream));
}
