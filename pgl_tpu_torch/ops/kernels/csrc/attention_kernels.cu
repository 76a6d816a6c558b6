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
//   * the dot kernels: one warp walks one piece of at most ET edges of a
//     row, the work list of `segment_kernels.cut_rows` built on the host,
//     so a hub row (38% of the edges of the bench GAT graph) spreads over
//     many SMs; there is no [E, C] gathered stream in device memory (the
//     TPU kernels DMA one); each gathered row is read by the warp's lanes
//     on neighbouring addresses (128-byte transactions);
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
//   * the additive K9 and K10 (`gat_fwd_groups`, in additive_groups.cuh,
//     which the count-matrix K7 shares in its cell form; `gat_dq_groups`,
//     `gat_dkv_groups`) gather few bytes an edge (288 B at GAT's (H, dvh)
//     = (8, 8) in K9 and K10-dq, 68 B at (1, 16)), so the instructions an
//     edge set their pace, not the bytes. A lane holds 16-byte vectors of
//     one head (`VecSlots`), a lane group of G <= 32 lanes a row, and a
//     warp 32 / G edges at once (2 at (8, 8), 8 at (1, 16)), U edges in
//     flight a group; the softmax work (K9's online max and sum; p,
//     leaky'; the keep bit) runs once an edge and head a lane holds, and a
//     head's g . v is a sum in the lane and log2(dvh_p / 4) shuffles (K9
//     sums nothing across lanes an edge). Their work list
//     (`attention_kernels.k10_work_list`) has no entry for an empty row
//     (78% of the bench GAT graph's destinations): the grid's last blocks
//     store those rows' zeros over a compact list. A row of more than
//     PACK_ROW edges keeps its pieces of ET edges, a warp each, whose
//     groups take even shares of the piece's edges and are summed (K9:
//     merged) by a fixed shuffle tree; every other row is one group's, the
//     rows sorted by length, so a warp's groups walk rows of about one
//     length (the CSR side's rows of ~16 edges, 8 rows a warp at (1, 16));
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
// bf16 (`pgl_gat_*_bf16`, `pgl_dot_*_bf16`, in the library
// attention_kernels_bf16 built from this source): every kernel here and
// its combine is instantiated on the tables' element type T. The reference
// takes bf16 tables into the same kernels: it rounds p to the value dtype
// before p . v, forms its dot scores in f32 at HIGHEST precision, keeps
// lse f32, forms delta from bf16 g and out, and rounds lse and delta to
// bf16 in its CSR pass's `ld` stream. Here the tables (a_dst, a_src or q,
// k; v; g) are loaded as bf16 and widened to f32; scores, exps, the online
// max and sum, p, p . v and the gradients' products and sums are f32; lse
// and delta are f32 tensors, the split rows' partials f32; out, d a_dst or
// dq, d a_src or dk, and dv are each rounded once to bf16 when stored. So
// the port rounds less often than the reference. The dropout hash is
// integer arithmetic on the CSC position, the same on both types. The
// dot K10-dq and K10-dkv stage bf16 rows into a bf16 ring by cp.async
// (`stage_ring`; 16- or 4-byte copies by the rows' alignment, plain loads
// for rows on a 2-byte boundary) and widen them exactly as they read them;
// the dot K9 stages a bf16 row by plain loads widened into its f32 ring
// (`stage_row`); the additive kernels load 16-byte vectors of 8 bf16.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes outputs and partials), and returns
// cudaGetLastError(). `thresh` < 0 turns dropout off.

#include "additive_groups.cuh"
#include "attention_common.cuh"
#include "dot_staged.cuh"

namespace {

// K10-dq over the CSC side: d a_dst[r, h] = sum over r's edges of ds_e.
template <typename T, int VEC, int NV, bool V4>
__global__ void __launch_bounds__(kWarps * 32)
gat_dq_groups(const T* __restrict__ a_dst, const T* __restrict__ a_src,
              const T* __restrict__ v, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ indices, const K10Work w, int H,
              int dvh, float slope, const int* __restrict__ seed_p,
              int thresh, float inv_keep, T* __restrict__ da_dst,
              float* __restrict__ partials) {
  constexpr int U = K10Unroll<VEC, NV, false>::value;
  if (static_cast<int>(blockIdx.x) >= w.item_blocks) {
    zero_empty<T, T>(w, H, H, da_dst, nullptr);
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
    ad[k] = ld_f(a_dst + rh);
    ls[k] = __ldg(lse + rh);
    dl[k] = __ldg(delta + rh);
    load_vec<T, VEC, V4>(g + r * C, sl.col[k], sl.live[k], true, gr[k]);
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
            as[u][k] = u < left ? ld_f(a_src + s * H + sl.head[k]) : 0.f;
            load_vec<T, VEC, V4>(v + s * C, sl.col[k], sl.live[k], u < left,
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
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!sl.lead[k]) continue;
    if (t.slot < 0)
      da_dst[r * H + sl.head[k]] = from_f<T>(da[k]);
    else
      partials[static_cast<size_t>(t.slot) * H + sl.head[k]] = da[k];
  }
}

// K10-dkv over the CSR side (the row is the source node s): d a_src[s, h] =
// sum over s's out-edges of ds_e, dv[s, c] = sum of q_e * g[dst_e, c]. Every
// edge gathers its destination's a_dst, lse, delta and g row, and its CSC
// position from eidx for the dropout hash.
template <typename T, int VEC, int NV, bool V4>
__global__ void __launch_bounds__(kWarps * 32)
gat_dkv_groups(const T* __restrict__ a_dst, const T* __restrict__ a_src,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ indices, const int* __restrict__ eidx,
               const K10Work w, int H, int dvh, float slope,
               const int* __restrict__ seed_p, int thresh, float inv_keep,
               T* __restrict__ da_src, T* __restrict__ dv,
               float* __restrict__ partials) {
  constexpr int U = K10Unroll<VEC, NV, true>::value;
  const int C = H * dvh;
  if (static_cast<int>(blockIdx.x) >= w.item_blocks) {
    zero_empty<T, T>(w, H + C, H, da_src, dv);
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
    as[k] = ld_f(a_src + r * H + sl.head[k]);
    load_vec<T, VEC, V4>(v + r * C, sl.col[k], sl.live[k], true, vs[k]);
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
            ad[u][k] = on ? ld_f(a_dst + dh) : 0.f;
            ls[u][k] = on ? __ldg(lse + dh) : 0.f;
            dl[u][k] = on ? __ldg(delta + dh) : 0.f;
            load_vec<T, VEC, V4>(g + d * C, sl.col[k], sl.live[k], on,
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
  if (t.slot < 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (sl.lead[k]) da_src[r * H + sl.head[k]] = from_f<T>(da[k]);
      if (!V4 || sl.col[k] >= 0)
        store_vec<T, VEC, V4>(dv + r * C + max(sl.col[k], 0), dva[k], 1.f,
                              sl.live[k]);
    }
    return;
  }
  // partial row: d a_src [H] | dv [C] (summed by sum_combine)
  float* part = partials + static_cast<size_t>(t.slot) * (H + C);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (sl.lead[k]) part[sl.head[k]] = da[k];
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (c < sl.live[k]) part[H + sl.col[k] + c] = dva[k][c];
  }
}

// The launches of K10-dq over one work list: gat_dq_groups, then
// sum_combine over the split rows.
template <typename T>
int dq_groups_run(const T* a_dst, const T* a_src, const T* v, const T* g,
                  const float* lse, const float* delta, const int* indices,
                  const int* items, int n_long, int n_short,
                  const int* empty, int n_empty, const int* split_rows,
                  const int* split_ptr, int n_split, int H, int dvh, int vec,
                  int lh, int group, int nv, float slope, const int* seed,
                  int thresh, float inv_keep, T* da_dst, float* partials,
                  cudaStream_t s) {
  K10Work w;
  int blocks = 0;
  if (!k10_work(items, n_long, n_short, empty, n_empty, H, dvh, vec, lh,
                group, nv, H, &w, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool v4 = vec == kVecElems<T> && dvh % vec == 0 && aligned16(v) &&
                  aligned16(g);
  if (!k10_dispatch<T>(vec, nv, v4, [&](auto VEC, auto NV, auto V4) {
        gat_dq_groups<T, decltype(VEC)::value, decltype(NV)::value,
                      decltype(V4)::value><<<blocks, kWarps * 32, 0, s>>>(
            a_dst, a_src, v, g, lse, delta, indices, w, H, dvh, slope, seed,
            thresh, inv_keep, da_dst, partials);
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_split > 0)
    sum_combine<T><<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, 0, da_dst, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The launches of K10-dkv over one work list: gat_dkv_groups, then
// sum_combine over the split rows.
template <typename T>
int dkv_groups_run(const T* a_dst, const T* a_src, const T* v, const T* g,
                   const float* lse, const float* delta, const int* indices,
                   const int* eidx, const int* items, int n_long,
                   int n_short, const int* empty, int n_empty,
                   const int* split_rows, const int* split_ptr, int n_split,
                   int H, int dvh, int vec, int lh, int group, int nv,
                   float slope, const int* seed, int thresh, float inv_keep,
                   T* da_src, T* dv, float* partials, cudaStream_t s) {
  K10Work w;
  int blocks = 0;
  if (!k10_work(items, n_long, n_short, empty, n_empty, H, dvh, vec, lh,
                group, nv, H + H * dvh, &w, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool v4 = vec == kVecElems<T> && dvh % vec == 0 && aligned16(v) &&
                  aligned16(g) && aligned16(dv);
  if (!k10_dispatch<T>(vec, nv, v4, [&](auto VEC, auto NV, auto V4) {
        gat_dkv_groups<T, decltype(VEC)::value, decltype(NV)::value,
                       decltype(V4)::value><<<blocks, kWarps * 32, 0, s>>>(
            a_dst, a_src, v, g, lse, delta, indices, eidx, w, H, dvh, slope,
            seed, thresh, inv_keep, da_src, dv, partials);
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_split > 0)
    sum_combine<T><<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, H * dvh, da_src, dv);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// Each entry point sets the device and launches its pass's kernels on
// `stream`: the _f32 ones on float tables, the _bf16 ones on bf16 tables
// (passed as raw 16-bit words; lse, delta and partials f32 either way).
#define PGL_ON_DEVICE(device)                          \
  do {                                                 \
    const cudaError_t err_ = cudaSetDevice(device);    \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

// K9 additive: out [N, H * dvh] and lse [N, H] over the work list of
// `attention_kernels.k10_work_list` (the additive K10's); partials
// [n_partials, H * dvh + 2H] of the split rows merged by a second launch.
#define PGL_GAT_FWD(NAME, T, P)                                              \
  extern "C" int NAME(int device, const P* a_dst, const P* a_src,           \
                      const P* v, const int* indices, const int* items,      \
                      int n_long, int n_short, const int* empty,             \
                      int n_empty, const int* split_rows,                    \
                      const int* split_ptr, int n_split, int H, int dvh,     \
                      int vec, int lh, int group, int nv, float slope,       \
                      const int* seed, int thresh, float inv_keep, P* out,   \
                      float* lse, float* partials, void* stream) {           \
    PGL_ON_DEVICE(device);                                                   \
    return fwd_groups_run<false>(                                            \
        static_cast<const T*>(a_dst), static_cast<const T*>(a_src),          \
        static_cast<const T*>(v), indices, nullptr, nullptr, items, n_long,  \
        n_short, empty, n_empty, split_rows, split_ptr, n_split, H, dvh,     \
        vec, lh, group, nv, slope, seed, thresh, inv_keep,                   \
        static_cast<T*>(out), lse, partials,                                 \
        static_cast<cudaStream_t>(stream));                                  \
  }

// K10-dq additive: d a_dst [N, H]; partials [n_partials, H] of the split
// rows (K9's) summed by a second launch.
#define PGL_GAT_DQ(NAME, T, P)                                               \
  extern "C" int NAME(int device, const P* a_dst, const P* a_src,           \
                      const P* v, const P* g, const float* lse,              \
                      const float* delta, const int* indices,                \
                      const int* items, int n_long, int n_short,             \
                      const int* empty, int n_empty, const int* split_rows,  \
                      const int* split_ptr, int n_split, int H, int dvh,     \
                      int vec, int lh, int group, int nv, float slope,       \
                      const int* seed, int thresh, float inv_keep,           \
                      P* da_dst, float* partials, void* stream) {            \
    PGL_ON_DEVICE(device);                                                   \
    return dq_groups_run(                                                    \
        static_cast<const T*>(a_dst), static_cast<const T*>(a_src),          \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        indices, items, n_long, n_short, empty, n_empty, split_rows,         \
        split_ptr, n_split, H, dvh, vec, lh, group, nv, slope, seed, thresh, \
        inv_keep, static_cast<T*>(da_dst), partials,                         \
        static_cast<cudaStream_t>(stream));                                  \
  }

// K10-dkv additive: d a_src [N, H] and dv [N, H * dvh]; partials
// [n_partials, H + H * dvh] of the split rows summed by a second launch.
#define PGL_GAT_DKV(NAME, T, P)                                              \
  extern "C" int NAME(int device, const P* a_dst, const P* a_src,           \
                      const P* v, const P* g, const float* lse,              \
                      const float* delta, const int* indices,                \
                      const int* eidx, const int* items, int n_long,         \
                      int n_short, const int* empty, int n_empty,            \
                      const int* split_rows, const int* split_ptr,           \
                      int n_split, int H, int dvh, int vec, int lh,          \
                      int group, int nv, float slope, const int* seed,       \
                      int thresh, float inv_keep, P* da_src, P* dv,          \
                      float* partials, void* stream) {                       \
    PGL_ON_DEVICE(device);                                                   \
    return dkv_groups_run(                                                   \
        static_cast<const T*>(a_dst), static_cast<const T*>(a_src),          \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        indices, eidx, items, n_long, n_short, empty, n_empty, split_rows,   \
        split_ptr, n_split, H, dvh, vec, lh, group, nv, slope, seed, thresh, \
        inv_keep, static_cast<T*>(da_src), static_cast<T*>(dv), partials,    \
        static_cast<cudaStream_t>(stream));                                  \
  }

// K9 dot: out [N, H * dvh] and lse [N, H] over the pieces of `cut_rows`;
// partials [n_partials, H * dvh + 2H] merged by gat_fwd_combine.
#define PGL_DOT_FWD(NAME, T, P)                                              \
  extern "C" int NAME(int device, const P* q, const P* k, const P* v,       \
                      const int* indices, const int* pieces, int n_pieces,   \
                      const int* split_rows, const int* split_ptr,           \
                      int n_split, int H, int dsh, int dvh, float slope,     \
                      const int* seed, int thresh, float inv_keep, P* out,   \
                      float* lse, float* partials, void* stream) {           \
    PGL_ON_DEVICE(device);                                                   \
    return dot_fwd_run<false>(                                               \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), indices, nullptr, nullptr, pieces,         \
        n_pieces, split_rows, split_ptr, n_split, H, dsh, dvh, slope, seed,  \
        thresh, inv_keep, static_cast<T*>(out), lse, partials,               \
        static_cast<cudaStream_t>(stream));                                  \
  }

// K10-dq dot: dq [N, H * dsh]; partials [n_partials, H * dsh].
#define PGL_DOT_DQ(NAME, T, P)                                               \
  extern "C" int NAME(int device, const P* q, const P* k, const P* v,       \
                      const P* g, const float* lse, const float* delta,      \
                      const int* indices, const int* pieces, int n_pieces,   \
                      const int* split_rows, const int* split_ptr,           \
                      int n_split, int H, int dsh, int dvh, float slope,     \
                      const int* seed, int thresh, float inv_keep, P* dq,    \
                      float* partials, void* stream) {                       \
    PGL_ON_DEVICE(device);                                                   \
    return dot_dq_run<false>(                                                \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        indices, nullptr, nullptr, pieces, n_pieces, split_rows, split_ptr,  \
        n_split, H, dsh, dvh, slope, seed, thresh, inv_keep,                 \
        static_cast<T*>(dq), partials, static_cast<cudaStream_t>(stream));   \
  }

// K10-dkv dot: dk [N, H * dsh] and dv [N, H * dvh]; partials
// [n_partials, H * (dsh + dvh)].
#define PGL_DOT_DKV(NAME, T, P)                                              \
  extern "C" int NAME(int device, const P* q, const P* k, const P* v,       \
                      const P* g, const float* lse, const float* delta,      \
                      const int* indices, const int* eidx,                   \
                      const int* pieces, int n_pieces,                       \
                      const int* split_rows, const int* split_ptr,           \
                      int n_split, int H, int dsh, int dvh, float slope,     \
                      const int* seed, int thresh, float inv_keep, P* dk,    \
                      P* dv, float* partials, void* stream) {                \
    PGL_ON_DEVICE(device);                                                   \
    return dot_dkv_run<false>(                                               \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        indices, eidx, nullptr, nullptr, pieces, n_pieces, split_rows,       \
        split_ptr, n_split, H, dsh, dvh, slope, seed, thresh, inv_keep,      \
        static_cast<T*>(dk), static_cast<T*>(dv), partials,                  \
        static_cast<cudaStream_t>(stream));                                  \
  }

// The depth of the dot backward passes' ring on T (RingSteps): steps of
// StageEdges<NC> items, S - 1 of them staged ahead of the one computed.
#define PGL_RING_STEPS(NAME, T) \
  extern "C" int NAME(void) { return RingSteps<T>::value; }

// The float32 entry points, or (built with -DPGL_BF16, the library
// attention_kernels_bf16) the bf16 ones: each half instantiates only its
// element type, so the two build in parallel.
#ifndef PGL_BF16
PGL_RING_STEPS(pgl_dot_ring_steps_f32, float)
PGL_GAT_FWD(pgl_gat_fwd_f32, float, float)
PGL_GAT_DQ(pgl_gat_dq_f32, float, float)
PGL_GAT_DKV(pgl_gat_dkv_f32, float, float)
PGL_DOT_FWD(pgl_dot_fwd_f32, float, float)
PGL_DOT_DQ(pgl_dot_dq_f32, float, float)
PGL_DOT_DKV(pgl_dot_dkv_f32, float, float)
#else
PGL_RING_STEPS(pgl_dot_ring_steps_bf16, __nv_bfloat16)
PGL_GAT_FWD(pgl_gat_fwd_bf16, __nv_bfloat16, void)
PGL_GAT_DQ(pgl_gat_dq_bf16, __nv_bfloat16, void)
PGL_GAT_DKV(pgl_gat_dkv_bf16, __nv_bfloat16, void)
PGL_DOT_FWD(pgl_dot_fwd_bf16, __nv_bfloat16, void)
PGL_DOT_DQ(pgl_dot_dq_bf16, __nv_bfloat16, void)
PGL_DOT_DKV(pgl_dot_dkv_bf16, __nv_bfloat16, void)
#endif  // PGL_BF16
