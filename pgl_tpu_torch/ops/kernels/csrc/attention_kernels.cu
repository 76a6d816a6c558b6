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
//   * K9 and the dot kernels: one warp walks one piece of at most ET edges
//     of a row, the work list of `segment_kernels.cut_rows` built on the
//     host, so a hub row (38% of the edges of the bench GAT graph) spreads
//     over many SMs; there is no [E, C] gathered stream in device memory
//     (the TPU kernels DMA one); each gathered row is read by the warp's
//     lanes on neighbouring addresses (128-byte transactions);
//   * there lanes take "slots": head h owns a power-of-two group of
//     consecutive slots (dvh_p in additive mode; max(dsh_p, dvh_p) in dot
//     mode, score and value columns in the same slots), slot j = lane + 32
//     k, so the lanes of one head sit in one aligned group and a per-head
//     dot product (q . k, g . v) is a shuffle reduction inside the group (<=
//     32 slots) or a sum in the lane and then across the warp (`head_sum`);
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
//   * the additive K10 (`gat_dq_groups`, `gat_dkv_groups`) gathers few
//     bytes an edge (288 B at GAT's (H, dvh) = (8, 8) in dq, 68 B at (1,
//     16)), so the instructions an edge set its pace, not the bytes. A lane
//     holds 16-byte vectors of one head (`VecSlots`), a lane group of G <=
//     32 lanes a row, and a warp 32 / G edges at once (2 at (8, 8), 8 at
//     (1, 16)), U edges in flight a group; the softmax work (p, leaky', the
//     keep bit) runs once an edge and head a lane holds, and a head's g . v
//     is a sum in the lane and log2(dvh_p / 4) shuffles. Its work list
//     (`attention_kernels.k10_work_list`) has no entry for an empty row
//     (78% of the bench GAT graph's destinations): the grid's last blocks
//     store those rows' zeros over a compact list. A row of more than
//     PACK_ROW edges keeps its pieces of ET edges, a warp each, whose
//     groups take even shares of the piece's edges and are summed by a
//     fixed shuffle tree; every other row is one group's, the rows sorted
//     by length, so a warp's groups walk rows of about one length (the CSR
//     side's rows of ~16 edges, 8 rows a warp at (1, 16));
//   * a row of one piece stores its result directly, an empty row stores
//     zeros (out and lse, as the reference); a row of several pieces stores
//     per-piece partials that a second launch merges in piece order
//     (rescaled by exp(m_i - m) in the forward, summed in the backward). No
//     float atomics: every run gives the same bits.

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

#include <type_traits>

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

// -- the additive K10: lane groups ----------------------------------------
//
// A lane group of G lanes (a power of two up to 32) holds one row's C = H *
// dvh columns as vectors of VEC consecutive columns of one head: head h owns
// the lh = dvh_p / VEC vector slots h * lh ... (dvh_p: dvh rounded up to a
// power of two; VEC = 4 where dvh_p >= 4, else 1), slot s lies in lane
// s % 32 of the group as its vector s / 32, and a lane holds NV vectors (NV
// > 1 only where G = 32). The host chooses (VEC, lh, G, NV)
// (`attention_kernels.k10_lanes`). So a vector lies in one head: a lane
// does the softmax work (p, leaky', the keep bit) once for each edge and
// head it holds, and a head's g . v is a sum in the lane, then log2(lh)
// shuffles inside the group (`head_sum` with the vector slots as slots).

// The vectors of lane l of a group: head (clamped to H - 1 past the last),
// first column (-1 where the vector holds none), its live columns (dvh may
// be no multiple of VEC), the head's hash constant, and whether the vector
// is its head's first (it writes per-head values).
template <int VEC, int NV>
struct VecSlots {
  int head[NV];
  int col[NV];
  int live[NV];
  uint32_t hc[NV];
  bool lead[NV];

  __device__ __forceinline__ VecSlots(int l, int H, int dvh, int lh) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int s = l + 32 * k;
      const int h = s / lh;
      const int w = (s - h * lh) * VEC;
      const bool ok = h < H && w < dvh;
      head[k] = min(h, H - 1);
      col[k] = ok ? h * dvh + w : -1;
      live[k] = ok ? min(VEC, dvh - w) : 0;
      hc[k] = static_cast<uint32_t>(head[k]) * 0x632BE5ABu;
      lead[k] = ok && w == 0;
    }
  }
};

// x <- the vector of `row` (a row of the table) at `col` with `live`
// columns (zeros past them, and everywhere where `on` is false); V4: one
// 16-byte load (every vector live whole: dvh % 4 == 0, rows aligned).
template <int VEC, bool V4>
__device__ __forceinline__ void load_vec(const float* __restrict__ row,
                                         int col, int live, bool on,
                                         float (&x)[VEC]) {
  if constexpr (V4) {
    if (on && col >= 0) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + col));
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) x[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      x[c] = on && c < live ? __ldg(row + col + c) : 0.f;
  }
}

// Edges in flight a lane group in K10-dq: four where an edge's gathered
// vectors hold at most 4 floats a lane, two up to 8, else one; K10-dkv,
// which gathers three scalars more an edge and head, half that. Measured
// at GAT's shapes (experiments/torch_spmm/k10_variants.py, H100): dq at
// (8, 8) 0.0725 ms at four, 0.0858 at two, 0.0957 at eight; dkv 0.0742 at
// two, 0.0837 at four, 0.189 at eight (150 registers); at (1, 16) dkv
// 0.0218 at two against 0.0237, dq 0.0295 against 0.0300.
template <int VEC, int NV, bool DKV>
struct K10Unroll {
  static constexpr int dq = VEC * NV <= 4 ? 4 : (VEC * NV <= 8 ? 2 : 1);
  static constexpr int value = DKV && dq > 1 ? dq / 2 : dq;
};

// K10's work list (`attention_kernels.k10_work_list`): n_long pieces
// (row, begin, end, slot), a warp each, then n_short whole rows (row,
// begin, end, -1), a lane group each, 32 / group of them a warp; n_empty
// rows without edges, which the blocks from item_blocks on zero.
struct K10Work {
  const int4* items;
  int n_long, n_short;
  const int* empty;
  int n_empty, item_warps, item_blocks;
  int lh, group;
};

// What one lane group walks: edges [b, e) of row `row` (-1: none), into
// its partial slot `slot` (-1: the row itself); `merge`: the warp's groups
// share one piece and are summed before group 0 stores it.
struct GroupTask {
  int row, b, e, slot;
  bool merge;
};

__device__ __forceinline__ GroupTask group_task(const K10Work& w, int warp,
                                                int grp) {
  const int W = 32 / w.group;
  if (warp < w.n_long) {  // uniform across the warp
    const int4 pc = __ldg(w.items + warp);
    const long long n = pc.z - pc.y;
    return {pc.x, pc.y + static_cast<int>(grp * n / W),
            pc.y + static_cast<int>((grp + 1) * n / W), pc.w, true};
  }
  const int i = (warp - w.n_long) * W + grp;
  if (i >= w.n_short) return {-1, 0, 0, -1, false};
  const int4 pc = __ldg(w.items + w.n_long + i);
  return {pc.x, pc.y, pc.z, -1, false};
}

// The blocks past the items' zero the empty rows: `width` floats a row, the
// first n1 into out1 [., n1], the rest into out2 [., width - n1].
__device__ __forceinline__ void zero_empty(const K10Work& w, int width,
                                           int n1, float* __restrict__ out1,
                                           float* __restrict__ out2) {
  const long long t =
      static_cast<long long>(blockIdx.x - w.item_blocks) * blockDim.x +
      threadIdx.x;
  if (t >= static_cast<long long>(w.n_empty) * width) return;
  const size_t r = __ldg(w.empty + t / width);
  const int c = static_cast<int>(t % width);
  if (c < n1) {
    out1[r * n1 + c] = 0.f;
  } else {
    const int n2 = width - n1;
    out2[r * n2 + (c - n1)] = 0.f;
  }
}

// The edges of a group's task walked in order, U at a time, their indices
// (and CSC positions, `pos` non-null) loaded a step ahead. Every lane runs
// the same number of steps (the longest task of the warp), so the head
// sums' shuffles see the whole warp: `step(idx, position, e0, left)` takes
// a step's U edges, edges e0 ... of the layout, of which the first `left`
// are the task's (the rest read nothing and add nothing).
template <int U, typename Step>
__device__ __forceinline__ void walk_task(const GroupTask& t,
                                          const int* __restrict__ indices,
                                          const int* __restrict__ pos,
                                          Step&& step) {
  const int n = t.e - t.b;
  const int steps = __reduce_max_sync(kFull, n);
  int cur[U], cpos[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cur[u] = u < n ? __ldg(indices + t.b + u) : 0;
    cpos[u] = pos != nullptr && u < n ? __ldg(pos + t.b + u) : 0;
  }
  for (int j0 = 0; j0 < steps; j0 += U) {
    int nxt[U], npos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + U + u;
      nxt[u] = j < n ? __ldg(indices + t.b + j) : 0;
      npos[u] = pos != nullptr && j < n ? __ldg(pos + t.b + j) : 0;
    }
    step(cur, cpos, t.b + j0, j0 < n ? n - j0 : 0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = nxt[u];
      cpos[u] = npos[u];
    }
  }
}

// K10-dq over the CSC side: d a_dst[r, h] = sum over r's edges of ds_e.
template <int VEC, int NV, bool V4>
__global__ void __launch_bounds__(kWarps * 32)
gat_dq_groups(const float* __restrict__ a_dst,
              const float* __restrict__ a_src, const float* __restrict__ v,
              const float* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta,
              const int* __restrict__ indices, const K10Work w, int H,
              int dvh, float slope, const int* __restrict__ seed_p,
              int thresh, float inv_keep, float* __restrict__ da_dst,
              float* __restrict__ partials) {
  constexpr int U = K10Unroll<VEC, NV, false>::value;
  if (static_cast<int>(blockIdx.x) >= w.item_blocks) {
    zero_empty(w, H, H, da_dst, nullptr);
    return;
  }
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= w.item_warps) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / w.group;
  const int C = H * dvh;
  const GroupTask t = group_task(w, warp, grp);
  const VecSlots<VEC, NV> sl(lane & (w.group - 1), H, dvh, w.lh);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  const size_t r = max(t.row, 0);  // a group without a task reads row 0

  float ad[NV], ls[NV], dl[NV], gr[NV][VEC], da[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const size_t rh = r * H + sl.head[k];
    ad[k] = __ldg(a_dst + rh);
    ls[k] = __ldg(lse + rh);
    dl[k] = __ldg(delta + rh);
    load_vec<VEC, V4>(g + r * C, sl.col[k], sl.live[k], true, gr[k]);
    da[k] = 0.f;
  }
  walk_task<U>(
      t, indices, nullptr,
      [&](const int (&src)[U], const int (&)[U], int e0, int left) {
        float as[U][NV], vv[U][NV][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const size_t s = src[u];
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            as[u][k] = u < left ? __ldg(a_src + s * H + sl.head[k]) : 0.f;
            load_vec<VEC, V4>(v + s * C, sl.col[k], sl.live[k], u < left,
                              vv[u][k]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float gv[NV];
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            gv[k] = 0.f;
#pragma unroll
            for (int c = 0; c < VEC; ++c) gv[k] += gr[k][c] * vv[u][k][c];
          }
          head_sum<NV>(gv, w.lh);
          if (u < left) {
            const uint32_t e = static_cast<uint32_t>(e0 + u);
#pragma unroll
            for (int k = 0; k < NV; ++k) {
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
      });
  if (t.merge) {  // uniform: a fixed tree over the warp's groups
    for (int off = w.group; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < NV; ++k) da[k] += __shfl_xor_sync(kFull, da[k], off);
  }
  if (t.row < 0 || (t.merge && grp != 0)) return;
  float* dst = t.slot < 0 ? da_dst + r * H
                          : partials + static_cast<size_t>(t.slot) * H;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (sl.lead[k]) dst[sl.head[k]] = da[k];
}

// K10-dkv over the CSR side (the row is the source node s): d a_src[s, h] =
// sum over s's out-edges of ds_e, dv[s, c] = sum of q_e * g[dst_e, c]. Every
// edge gathers its destination's a_dst, lse, delta and g row, and its CSC
// position from eidx for the dropout hash.
template <int VEC, int NV, bool V4>
__global__ void __launch_bounds__(kWarps * 32)
gat_dkv_groups(const float* __restrict__ a_dst,
               const float* __restrict__ a_src, const float* __restrict__ v,
               const float* __restrict__ g, const float* __restrict__ lse,
               const float* __restrict__ delta,
               const int* __restrict__ indices, const int* __restrict__ eidx,
               const K10Work w, int H, int dvh, float slope,
               const int* __restrict__ seed_p, int thresh, float inv_keep,
               float* __restrict__ da_src, float* __restrict__ dv,
               float* __restrict__ partials) {
  constexpr int U = K10Unroll<VEC, NV, true>::value;
  const int C = H * dvh;
  if (static_cast<int>(blockIdx.x) >= w.item_blocks) {
    zero_empty(w, H + C, H, da_src, dv);
    return;
  }
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= w.item_warps) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / w.group;
  const GroupTask t = group_task(w, warp, grp);
  const VecSlots<VEC, NV> sl(lane & (w.group - 1), H, dvh, w.lh);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  const size_t r = max(t.row, 0);  // a group without a task reads row 0

  float as[NV], vs[NV][VEC], da[NV], dva[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    as[k] = __ldg(a_src + r * H + sl.head[k]);
    load_vec<VEC, V4>(v + r * C, sl.col[k], sl.live[k], true, vs[k]);
    da[k] = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) dva[k][c] = 0.f;
  }
  walk_task<U>(
      t, indices, drop ? eidx : nullptr,
      [&](const int (&dst)[U], const int (&pos)[U], int, int left) {
        float ad[U][NV], ls[U][NV], dl[U][NV], gd[U][NV][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const size_t d = dst[u];
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const size_t dh = d * H + sl.head[k];
            const bool on = u < left;
            ad[u][k] = on ? __ldg(a_dst + dh) : 0.f;
            ls[u][k] = on ? __ldg(lse + dh) : 0.f;
            dl[u][k] = on ? __ldg(delta + dh) : 0.f;
            load_vec<VEC, V4>(g + d * C, sl.col[k], sl.live[k], on,
                              gd[u][k]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float gv[NV];
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            gv[k] = 0.f;
#pragma unroll
            for (int c = 0; c < VEC; ++c) gv[k] += gd[u][k][c] * vs[k][c];
          }
          head_sum<NV>(gv, w.lh);
          if (u < left) {
            const uint32_t e = static_cast<uint32_t>(pos[u]);
#pragma unroll
            for (int k = 0; k < NV; ++k) {
              const float sr = ad[u][k] + as[k];
              const float p = expf(leaky(sr, slope) - ls[u][k]);
              const float q =
                  drop ? (drop_keep(e, seed, sl.hc[k], thresh) ? p * inv_keep
                                                               : 0.f)
                       : p;
              da[k] += (q * gv[k] - p * dl[u][k]) * leaky_grad(sr, slope);
#pragma unroll
              for (int c = 0; c < VEC; ++c) dva[k][c] += q * gd[u][k][c];
            }
          }
        }
      });
  if (t.merge) {  // uniform: a fixed tree over the warp's groups
    for (int off = w.group; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        da[k] += __shfl_xor_sync(kFull, da[k], off);
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          dva[k][c] += __shfl_xor_sync(kFull, dva[k][c], off);
      }
  }
  if (t.row < 0 || (t.merge && grp != 0)) return;
  // partial row: d a_src [H] | dv [C] (summed by sum_combine)
  float* part = partials + static_cast<size_t>(max(t.slot, 0)) * (H + C);
  float* ds_row = t.slot < 0 ? da_src + r * H : part;
  float* dv_row = t.slot < 0 ? dv + r * C : part + H;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (sl.lead[k]) ds_row[sl.head[k]] = da[k];
    if (V4 && t.slot < 0) {
      if (sl.col[k] >= 0)
        *reinterpret_cast<float4*>(dv_row + sl.col[k]) =
            make_float4(dva[k][0], dva[k][1], dva[k][2], dva[k][3]);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        if (c < sl.live[k]) dv_row[sl.col[k] + c] = dva[k][c];
    }
  }
}

// Calls f(VEC, NV, V4) as compile-time constants at the lane map's (vec,
// nv) and the load path v4; false where no instantiation matches.
template <int A>
using IntC = std::integral_constant<int, A>;
template <bool A>
using BoolC = std::integral_constant<bool, A>;

template <typename F>
bool k10_dispatch(int vec, int nv, bool v4, F&& f) {
  if (vec == 4) {
    const auto pick = [&](auto NVc) {
      if (v4) {
        f(IntC<4>{}, NVc, BoolC<true>{});
      } else {
        f(IntC<4>{}, NVc, BoolC<false>{});
      }
    };
    switch (nv) {
      case 1: pick(IntC<1>{}); return true;
      case 2: pick(IntC<2>{}); return true;
      case 4: pick(IntC<4>{}); return true;
      default: return false;
    }
  }
  if (vec != 1 || v4) return false;
  switch (nv) {
    case 1: f(IntC<1>{}, IntC<1>{}, BoolC<false>{}); return true;
    case 2: f(IntC<1>{}, IntC<2>{}, BoolC<false>{}); return true;
    case 4: f(IntC<1>{}, IntC<4>{}, BoolC<false>{}); return true;
    case 8: f(IntC<1>{}, IntC<8>{}, BoolC<false>{}); return true;
    case 16: f(IntC<1>{}, IntC<16>{}, BoolC<false>{}); return true;
    default: return false;
  }
}

// The K10 work of one call and its grid: item blocks (one warp a long
// piece, 32 / group whole rows a warp), then the blocks that zero `width`
// floats of each empty row. Returns false on a lane map that does not hold
// H heads of dvh columns.
bool k10_work(const int* items, int n_long, int n_short, const int* empty,
              int n_empty, int H, int dvh, int vec, int lh, int group,
              int nv, int width, K10Work* w, int* blocks) {
  const bool pow2 = group > 0 && group <= 32 && (group & (group - 1)) == 0 &&
                    lh > 0 && (lh & (lh - 1)) == 0;
  if (!pow2 || H <= 0 || dvh <= 0 || n_long < 0 || n_short < 0 ||
      n_empty < 0 || lh * vec < dvh || H * lh > group * nv ||
      (nv > 1 && group != 32))
    return false;
  const int W = 32 / group;  // lane groups a warp
  const int item_warps = n_long + (n_short + W - 1) / W;
  const long long zeros = static_cast<long long>(n_empty) * width;
  *w = K10Work{reinterpret_cast<const int4*>(items), n_long, n_short, empty,
               n_empty, item_warps, blocks_for(item_warps), lh, group};
  *blocks = w->item_blocks +
            static_cast<int>((zeros + kWarps * 32 - 1) / (kWarps * 32));
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// K10-dq additive: d a_dst [N, H]; partials [n_partials, H] of the split
// rows (K9's) summed by a second launch.
extern "C" int pgl_gat_dq_f32(int device, const float* a_dst,
                              const float* a_src, const float* v,
                              const float* g, const float* lse,
                              const float* delta, const int* indices,
                              const int* items, int n_long, int n_short,
                              const int* empty, int n_empty,
                              const int* split_rows, const int* split_ptr,
                              int n_split, int H, int dvh, int vec, int lh,
                              int group, int nv, float slope,
                              const int* seed, int thresh, float inv_keep,
                              float* da_dst, float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  K10Work w;
  int blocks = 0;
  if (!k10_work(items, n_long, n_short, empty, n_empty, H, dvh, vec, lh,
                group, nv, H, &w, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool v4 = vec == 4 && dvh % 4 == 0 && aligned16(v) && aligned16(g);
  if (!k10_dispatch(vec, nv, v4, [&](auto VEC, auto NV, auto V4) {
        gat_dq_groups<decltype(VEC)::value, decltype(NV)::value,
                      decltype(V4)::value><<<blocks, kWarps * 32, 0, s>>>(
            a_dst, a_src, v, g, lse, delta, indices, w, H, dvh, slope, seed,
            thresh, inv_keep, da_dst, partials);
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_split > 0)
    sum_combine<<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, 0, da_dst, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K10-dkv additive: d a_src [N, H] and dv [N, H * dvh]; partials
// [n_partials, H + H * dvh] of the split rows summed by a second launch.
extern "C" int pgl_gat_dkv_f32(int device, const float* a_dst,
                               const float* a_src, const float* v,
                               const float* g, const float* lse,
                               const float* delta, const int* indices,
                               const int* eidx, const int* items, int n_long,
                               int n_short, const int* empty, int n_empty,
                               const int* split_rows, const int* split_ptr,
                               int n_split, int H, int dvh, int vec, int lh,
                               int group, int nv, float slope,
                               const int* seed, int thresh, float inv_keep,
                               float* da_src, float* dv, float* partials,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  K10Work w;
  int blocks = 0;
  if (!k10_work(items, n_long, n_short, empty, n_empty, H, dvh, vec, lh,
                group, nv, H + H * dvh, &w, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool v4 = vec == 4 && dvh % 4 == 0 && aligned16(v) && aligned16(g) &&
                  aligned16(dv);
  if (!k10_dispatch(vec, nv, v4, [&](auto VEC, auto NV, auto V4) {
        gat_dkv_groups<decltype(VEC)::value, decltype(NV)::value,
                       decltype(V4)::value><<<blocks, kWarps * 32, 0, s>>>(
            a_dst, a_src, v, g, lse, delta, indices, eidx, w, H, dvh, slope,
            seed, thresh, inv_keep, da_src, dv, partials);
      }))
    return static_cast<int>(cudaErrorInvalidValue);
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
