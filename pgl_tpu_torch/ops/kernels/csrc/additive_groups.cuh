// The additive attention's lane groups, shared by attention_kernels.cu
// (the per-edge K9 and K10) and dedup_attention.cu (the count-matrix K7):
// the lane map (`VecSlots`, `load_vec`), the work list of long pieces,
// whole rows and empty rows (`K10Work`, `group_task`, `zero_empty`,
// `k10_work`), the instantiation switch (`k10_dispatch`), and the forward
// `gat_fwd_groups` in its per-edge (K9) and cell (K7) forms with its host
// launcher `fwd_groups_run`.
//
// The forward (replaces `_attn_kernel`, pgl_tpu/ops/pallas/
// attention_kernels.py:86, and `_attn_fwd_kernel`, pgl_tpu/ops/pallas/
// dedup_attention.py:102): per row r and head h over r's edges (cells) e,
//   s_e = leaky(a_dst[r, h] + a_src[src_e, h]),  c_e = 1 (an edge) or the
//   cell's count,  l = sum c_e exp(s_e - m),  out[r] = sum keep_e c_e
//   exp(s_e - m) v[src_e] / (1 - rate) / l,  lse[r] = m + log l
// (zeros in both for a row without edges). What bounds it on this card:
// the gathers, a_src and v of each edge's source (288 B an edge at GAT's
// (H, dvh) = (8, 8), 68 B at (1, 16)), small rows whose tables sit in the
// 50 MB L2, so the instructions an edge set its pace. The design is
// the additive K10's: a lane group of 16-byte columns a row, 32 / group
// rows (or one piece's shares) a warp; the softmax work (leaky, the
// online max and sum, the keep hash) once an edge and head a lane holds,
// with one exp (exp(-|s - m|) is the rescale where s raises the max and p
// where it does not: the same bits as two); no cross-lane sum an edge, so
// each group runs its own trip count, and a warp meets only to merge a
// split piece's group states by a fixed xor tree; no warp for an empty
// row (the grid's last blocks store its zeros); a row of several pieces
// stores per-piece partials acc | m | l that `gat_fwd_combine` merges in
// piece order (32 warps where the dot mode takes 16). No float atomics:
// every run gives the same bits.
//
// On bf16 tables (T = __nv_bfloat16: K9, K10 and the cell form K7) a
// 16-byte vector holds 8 bf16, widened to f32 as it is
// loaded: at GAT's (8, 8) a head is one vector, a lane group 8 lanes and a
// warp 4 edges at once (2 on float), at (1, 16) 16 (8). The online max and
// sum, the exps, p and the products are f32 as on float; out and the
// gradients are rounded once to bf16 when stored, lse and the split rows'
// partials stay f32.

#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

// -- the additive K10: lane groups ----------------------------------------
//
// A lane group of G lanes (a power of two up to 32) holds one row's C = H *
// dvh columns as vectors of VEC consecutive columns of one head: head h owns
// the lh = dvh_p / VEC vector slots h * lh ... (dvh_p: dvh rounded up to a
// power of two; VEC = 4 where dvh_p >= 4, else 1, on float; on bf16 VEC = 8
// where dvh_p >= 8, else 1: a 16-byte vector either way), slot s lies in lane
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
// columns, as f32 (zeros past them, and everywhere where `on` is false);
// V4: one 16-byte load of VEC = kVecElems<T> elements (every vector live
// whole: dvh % VEC == 0, rows aligned).
template <typename T, int VEC, bool V4>
__device__ __forceinline__ void load_vec(const T* __restrict__ row,
                                         int col, int live, bool on,
                                         float (&x)[VEC]) {
  if constexpr (V4) {
    static_assert(VEC == kVecElems<T>, "a 16-byte vector");
    if (on && col >= 0) {
      if constexpr (std::is_same_v<T, float>) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(row + col));
        x[0] = t.x;
        x[1] = t.y;
        x[2] = t.z;
        x[3] = t.w;
      } else {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(row + col));
        const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 p = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          x[2 * i] = p.x;
          x[2 * i + 1] = p.y;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) x[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      x[c] = on && c < live ? ld_f(row + col + c) : 0.f;
  }
}

// The vector x times `scale` stored at `o` as T, each value rounded once:
// V4 one 16-byte store, else the `live` first columns one by one.
template <typename T, int VEC, bool V4>
__device__ __forceinline__ void store_vec(T* __restrict__ o,
                                          const float (&x)[VEC], float scale,
                                          int live) {
  if constexpr (V4 && std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(o) =
        make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  } else if constexpr (V4) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(x[2 * i] * scale, x[2 * i + 1] * scale);
      w[i] = *reinterpret_cast<const unsigned*>(&p);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (c < live) o[c] = from_f<T>(x[c] * scale);
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

// The blocks past the items' zero the empty rows: `width` values a row, the
// first n1 into out1 [., n1], the rest into out2 [., width - n1].
template <typename T1, typename T2>
__device__ __forceinline__ void zero_empty(const K10Work& w, int width,
                                           int n1, T1* __restrict__ out1,
                                           T2* __restrict__ out2) {
  const long long t =
      static_cast<long long>(blockIdx.x - w.item_blocks) * blockDim.x +
      threadIdx.x;
  if (t >= static_cast<long long>(w.n_empty) * width) return;
  const size_t r = __ldg(w.empty + t / width);
  const int c = static_cast<int>(t % width);
  if (c < n1) {
    out1[r * n1 + c] = from_f<T1>(0.f);
  } else {
    const int n2 = width - n1;
    out2[r * n2 + (c - n1)] = from_f<T2>(0.f);
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

// Edges in flight a lane group in the forward: as K10-dq, whose gathers
// an edge it shares (one a_src scalar and the v vectors); cells, which
// load a count and a key more each, half that. Measured at GAT's (8, 8)
// on the bench GAT graph, rate 0, with the merge of split rows
// (experiments/torch_spmm/fwd_variants.py, H100): K9 0.098 device ms at
// four, 0.099 at two, 0.112 at one, 0.130 at eight; K7 0.061 at two
// against 0.072 at four (55 registers against 79) and 0.087 at one.
template <int VEC, int NV, bool CELLS>
struct FwdUnroll {
  static constexpr int edges = VEC * NV <= 4 ? 4 : (VEC * NV <= 8 ? 2 : 1);
  static constexpr int value = CELLS && edges > 1 ? edges / 2 : edges;
};

// The online softmax state (m, l) takes score s of weight c (1 an edge,
// the count a cell): sc rescales the old sums, p = c exp(s - m') joins
// them. One exp: exp(-|s - m|) is sc where s raises the max and p / c
// where it does not, the other being exp(0) = 1, so the bits are those of
// exp(m - m') and exp(s - m'). Two exps ran 1.03x slower at GAT's (8, 8)
// (experiments/torch_spmm/fwd_variants.py, H100).
__device__ __forceinline__ void online_step(float s, float c, float& m,
                                            float& l, float& sc, float& p) {
  const float t = expf(-fabsf(s - m));
  const bool up = s > m;
  sc = up ? t : 1.f;
  p = c * (up ? 1.f : t);
  m = up ? s : m;
  l = l * sc + p;
}

// `merge` (attention_common.cuh) of a state whose acc is a vector.
template <int VEC>
__device__ __forceinline__ void merge_vec(float& M, float& L, float (&A)[VEC],
                                          float m, float l,
                                          const float (&a)[VEC]) {
  const float mn = fmaxf(M, m);
  const float s1 = expf(M - mn);
  const float s2 = expf(m - mn);
  L = L * s1 + l * s2;
#pragma unroll
  for (int c = 0; c < VEC; ++c) A[c] = A[c] * s1 + a[c] * s2;
  M = mn;
}

// K9 (CELLS false: edges of the CSC layout, `src` their sources, the
// dropout keyed by the edge's CSC position) and K7 (CELLS: the count
// matrix's cells in row order, `src` their nodes, `cnt` their counts,
// `key` their dropout keys `_cell_idx`) over the work list `w`: out [N, C]
// and lse [N, H], or a split row's partial rows acc [C] | m [H] | l [H].
template <typename T, int VEC, int NV, bool V4, bool CELLS>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_groups(const T* __restrict__ a_dst, const T* __restrict__ a_src,
               const T* __restrict__ v, const int* __restrict__ src,
               const int* __restrict__ cnt, const int* __restrict__ key,
               const K10Work w, int H, int dvh, float slope,
               const int* __restrict__ seed_p, int thresh, float inv_keep,
               T* __restrict__ out, float* __restrict__ lse,
               float* __restrict__ partials) {
  constexpr int U = FwdUnroll<VEC, NV, CELLS>::value;
  const int C = H * dvh;
  if (static_cast<int>(blockIdx.x) >= w.item_blocks) {
    zero_empty<T, float>(w, C + H, C, out, lse);
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

  float ad[NV], m[NV], l[NV], acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    ad[k] = ld_f(a_dst + r * H + sl.head[k]);
    m[k] = kMaskValue;
    l[k] = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[k][c] = 0.f;
  }
  // the group's edges in order, U at a time, each step's indices (and a
  // cell's count and key) loaded a step ahead; the group runs its own
  // trip count
  const int n = t.e - t.b;
  int cur[U], ccnt[U], ckey[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cur[u] = u < n ? __ldg(src + t.b + u) : 0;
    ccnt[u] = CELLS && u < n ? __ldg(cnt + t.b + u) : 1;
    ckey[u] = CELLS && u < n ? __ldg(key + t.b + u) : 0;
  }
  for (int j0 = 0; j0 < n; j0 += U) {
    const int left = n - j0;
    int nxt[U], ncnt[U], nkey[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + U + u;
      nxt[u] = j < n ? __ldg(src + t.b + j) : 0;
      ncnt[u] = CELLS && j < n ? __ldg(cnt + t.b + j) : 1;
      nkey[u] = CELLS && j < n ? __ldg(key + t.b + j) : 0;
    }
    float as[U][NV], vv[U][NV][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t s = cur[u];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        as[u][k] = u < left ? ld_f(a_src + s * H + sl.head[k]) : 0.f;
        load_vec<T, VEC, V4>(v + s * C, sl.col[k], sl.live[k], u < left,
                             vv[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= left) break;  // uniform across the group
      const uint32_t e = CELLS ? static_cast<uint32_t>(ckey[u])
                               : static_cast<uint32_t>(t.b + j0 + u);
      const float c = CELLS ? static_cast<float>(ccnt[u]) : 1.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float sc, p;
        online_step(leaky(ad[k] + as[u][k], slope), c, m[k], l[k], sc, p);
        const float pk =
            (!drop || drop_keep(e, seed, sl.hc[k], thresh)) ? p : 0.f;
#pragma unroll
        for (int cc = 0; cc < VEC; ++cc)
          acc[k][cc] = acc[k][cc] * sc + pk * vv[u][k][cc];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = nxt[u];
      ccnt[u] = ncnt[u];
      ckey[u] = nkey[u];
    }
  }
  if (t.merge) {  // uniform: a fixed tree over the warp's groups
    for (int off = w.group; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float om = __shfl_xor_sync(kFull, m[k], off);
        const float ol = __shfl_xor_sync(kFull, l[k], off);
        float oa[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          oa[c] = __shfl_xor_sync(kFull, acc[k][c], off);
        merge_vec<VEC>(m[k], l[k], acc[k], om, ol, oa);
      }
  }
  if (t.row < 0 || (t.merge && grp != 0)) return;
  if (t.slot < 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const bool row = l[k] > 0.f;  // a row without edges stores zeros
      const float sc = row ? inv_keep / fmaxf(l[k], 1e-30f) : 0.f;
      T* o = out + r * C + max(sl.col[k], 0);
      if (!V4 || sl.col[k] >= 0)
        store_vec<T, VEC, V4>(o, acc[k], sc, sl.live[k]);
      if (sl.lead[k]) lse[r * H + sl.head[k]] = row ? m[k] + logf(l[k]) : 0.f;
    }
  } else {
    // partial row: acc [C] | m [H] | l [H] (merged by gat_fwd_combine)
    float* part = partials + static_cast<size_t>(t.slot) * (C + 2 * H);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        if (c < sl.live[k]) part[sl.col[k] + c] = acc[k][c];
      if (sl.lead[k]) {
        part[C + sl.head[k]] = m[k];
        part[C + H + sl.head[k]] = l[k];
      }
    }
  }
}

// Calls f(VEC, NV, V4) as compile-time constants at the lane map's (vec,
// nv) and the load path v4; false where no instantiation matches. vec is a
// 16-byte vector of T (4 floats, 8 bf16) or 1.
template <int A>
using IntC = std::integral_constant<int, A>;
template <bool A>
using BoolC = std::integral_constant<bool, A>;

template <typename T, typename F>
bool k10_dispatch(int vec, int nv, bool v4, F&& f) {
  constexpr int VW = kVecElems<T>;
  if (vec == VW) {
    const auto pick = [&](auto NVc) {
      if (v4) {
        f(IntC<VW>{}, NVc, BoolC<true>{});
      } else {
        f(IntC<VW>{}, NVc, BoolC<false>{});
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

// Warps of the forward's gat_fwd_combine block: 32 where a lane holds at
// most two slots (the hub of the bench GAT graph has 1,574 pieces, 49 a
// warp of 32 to merge one after another), else the dot mode's count.
// Measured with K9 at (8, 8) on the bench GAT graph (fwd_variants.py,
// H100): 0.098 device ms against 0.104 at 16 warps, and 0.104 with a
// two-pass merge of another order (the row's max, then rescaled sums in
// parallel); at (1, 16) 0.036 against 0.037 and 0.034.
template <int NC>
struct FwdCombineWarps {
  static constexpr int value = NC <= 2 ? 32 : CombineWarps<NC>::value;
};

// The forward of one call: gat_fwd_groups over the work list (items,
// n_long long pieces then n_short whole rows; n_empty empty rows zeroed by
// the grid's tail), then gat_fwd_combine over the n_split split rows.
// `cnt` and `key` are the cells' (CELLS) or null.
template <bool CELLS, typename T>
int fwd_groups_run(const T* a_dst, const T* a_src, const T* v,
                   const int* src, const int* cnt, const int* key,
                   const int* items, int n_long, int n_short,
                   const int* empty, int n_empty, const int* split_rows,
                   const int* split_ptr, int n_split, int H, int dvh,
                   int vec, int lh, int group, int nv, float slope,
                   const int* seed, int thresh, float inv_keep, T* out,
                   float* lse, float* partials, cudaStream_t s) {
  const int dvh_p = pow2_at_least(dvh);
  const int nc = slots_per_lane(H, dvh_p);  // the combine's slots a lane
  K10Work w;
  int blocks = 0;
  if (nc == 0 || !k10_work(items, n_long, n_short, empty, n_empty, H, dvh,
                           vec, lh, group, nv, H * dvh + H, &w, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const bool v4 = vec == kVecElems<T> && dvh % vec == 0 && aligned16(v) &&
                    aligned16(out);
    if (!k10_dispatch<T>(vec, nv, v4, [&](auto VEC, auto NV, auto V4) {
          gat_fwd_groups<T, decltype(VEC)::value, decltype(NV)::value,
                         decltype(V4)::value, CELLS>
              <<<blocks, kWarps * 32, 0, s>>>(
                  a_dst, a_src, v, src, cnt, key, w, H, dvh, slope, seed,
                  thresh, inv_keep, out, lse, partials);
        }))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_split > 0) {
    PGL_NC_SWITCH(nc, {
      constexpr int W = FwdCombineWarps<NC>::value;
      gat_fwd_combine<T, NC, W><<<n_split, W * 32, 0, s>>>(
          partials, split_rows, split_ptr, H, dvh, dvh_p, inv_keep, out,
          lse);
    })
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
