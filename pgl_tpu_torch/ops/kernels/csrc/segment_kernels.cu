// Sorted-segment SpMM for Hopper (sm_90a):
//   out[r, :] = sum over e in [indptr[r], indptr[r+1]) of x[indices[e], :]
//
// Replaces the TPU kernels pgl_tpu/ops/pallas/segment_kernels.py `_kernel`
// (the one-hot MXU segment sum over pre-gathered messages, driven by
// `_spmm_pallas` / `_blocked_spmm`) and `_fused_kernel` (the same contract
// with the source-row gather inside the kernel). This kernel gathers inside,
// so it serves both: `spmm` runs it over the CSC layout (forward) and the CSR
// layout (backward), and `sorted_segment_sum` runs it with the identity
// gather (indices = arange(E)), which is the pre-gathered contract.
//
// K1w, the same kernels on weighted messages, replaces `_kernel` run on
// `_weighted_msgs` (the TPU path's `spmm_weighted`, the fused
// `send_ue_recv`): out[d] = sum_e x[src_e] (*|+) w_e, with w [E] or per head
// [E, H]. Each lane combines its gathered columns with its edge's weight in
// registers, so no [E, D] message tensor exists. Its gradient is one pass of
// the same kernels over the CSR layout: dx is the weighted (mul) or plain
// (add) transposed sum, and the lane group that gathers g[dst_e] for dx
// also reduces dw_e per head (<g[dst_e], x[s]>, or the sum of g[dst_e]) by
// a fixed shuffle tree and writes it once at the edge's original id. The
// reference materialises two [E, D] tensors for dw outside its kernel.
//
// What bounds it: bytes, and the latency of the loads that lead to them. Per
// call it must read x once ([N, D] f32), the indices ([E] i32) and the row
// pointer, and write out ([N, D] f32); the E*D additions are far below the
// card's f32 rate. Each source row is read straight from x for each edge:
// there is no [E, D] message buffer in device memory (the TPU path
// materialises one). K1w adds the weights and edge ids ([E, H] f32, [E] i32:
// 4-byte reads in the caller's edge order, each to its own sector) and dw.
// The design (`spmm_rows`, `spmm_packs`, both for K1 and K1w):
//   * one walk of a work item at every width up to 512 columns: a lane keeps
//     all its columns of the row in registers (NV vectors of VEC = 4 floats,
//     or of one float where D % 4 != 0 or a pointer is not 16-byte aligned),
//     so each gathered row is requested once, all columns together, and the
//     indices are read once; L lanes cover a row, the warp's 32 / L lane
//     groups share the item, and L and NV are chosen from D at launch;
//   * the work list (`pack_rows`, built on the host at layout time) packs
//     runs of consecutive short rows (at most PACK_ROW = 8 edges each) into
//     one item of at most kPack edges and kPack rows: the warp loads their
//     indices and row pointers in one coalesced load each, each lane group
//     takes an even share of the item's edges and walks it in order with
//     its loads in flight across row ends, storing each row's sum when the
//     row ends; a row that crosses into the next share is finished there,
//     its partial passed from group to group by shuffles in a fixed order;
//   * longer rows are items of their own, and a row of more than MIN_PIECE
//     = 64 edges is cut into about 128 pieces of 64 to ET = 512 edges
//     (`cut_spmm_rows`; the host also sorts each row's sources, so a hub's
//     pieces read narrow bands of x that stay in L2): the lane groups take
//     interleaved edges and are summed by a fixed shuffle tree; a row of
//     several pieces writes per-piece partials that a second launch
//     (`spmm_combine`) sums in piece order;
//   * one warp an item, mostly in at most 64 registers (four blocks of 8
//     warps an SM), so the other warps hide each item's chain of loads
//     (descriptor, indices and row pointers loaded together, then the
//     rows). A persistent grid whose warps loaded the next items ahead
//     needed more registers, so fewer warps, and lost on rows of ~16 edges;
//   * two kernels, `spmm_rows` for the pieces and whole rows and
//     `spmm_packs` for the packs, the packs on a side stream so the two
//     overlap: in one kernel the packs' code slowed the other items;
//   * an empty row stores 0. No atomics, and the order of every sum depends
//     only on the layout, D and whether the tables are 16-byte aligned:
//     every run gives the same bits.
// K1w's template arguments WOP and DWOP (`Op`) add the weights and the
// weight gradient to the same walk; K1 is WOP = DWOP = kNone, where every
// line they add compiles away. VEC divides the head width dh, so a vector
// lies in one head (`Heads`): a lane reads one weight per edge and head its
// vectors touch, beside the gathered row. Those reads set K1w's pace: with
// every weight taken as 1 and none read, the forward ran at K1's time (1.4x
// faster at one head, 2.2x at 8; experiments/torch_spmm/k1w_k8_variants.py)
// whatever the edge order. dw's per-head partials are summed over the
// head's slots by `head_tree`, whose first slot writes dw[eid, h] once.
// K1w holds half of K1's gathered rows in flight (its weights, edge ids and
// dw partials take registers too: at K1's count the weighted kernels
// spilled 48-260 B, or at 80 registers ran slower; same script).
// Past 512 columns a row takes several passes, and a head that crosses a
// pass is finished by the later one, which adds to what the earlier wrote.
//
// bf16 (K1: `pgl_spmm_bf16`; K1w: `pgl_spmm_weighted_bf16`, in the library
// segment_kernels_bf16 built from this source): the same kernels
// instantiated on the element type T. The reference sends bf16
// features to its kernel, which accumulates each ET-edge tile in f32 and
// rounds the running sum to bf16 once a tile (K1w also forms each message
// x * w in bf16 before its tile sum, and takes the weights in the
// feature's dtype); here a lane converts each gathered bf16 (and K1w's
// bf16 weight and row of xrow) to f32, forms the message and sums in f32
// registers, and rounds once (to nearest even) when the row, or dw, is
// stored. A
// split row's per-piece partials stay f32 whatever T is, and `spmm_combine`
// sums them in f32 and rounds once. A 16-byte vector holds 8 bf16, so the
// vector path takes D % 8 == 0 (VEC = 8) and `items_config` keeps 16 f32
// columns a lane a pass (two vectors of 8; NV <= 2): a lane holds as many
// f32 sums as the float32 kernel's four vectors of 4. The scalar path (VEC
// = 1) loads one bf16 a column. With half the row bytes, a lane group of
// width D covers half the lanes, so twice the groups share an item, and
// ItemUnroll halves the rows each holds in flight (32 f32 values a lane):
// a warp keeps as many gathered rows in flight as the float32 kernel's at
// the same D, each half the bytes. The order of every sum is the float32
// kernel's, so every run gives the same bits. K1w's dw on bf16 is reduced
// by `head_tree` in f32 and rounded once when stored; past 512 columns a
// head that crosses a pass adds its later part to the bf16 value the
// earlier pass stored (a second rounding, at D > 512 only).
//
// Calling convention: launches on the given stream (the packs on a side
// stream forked from it and joined back, so what the caller queues after
// the call sees them done), does not synchronise, allocates nothing (the
// caller passes `out` [N, D] and `partials` [n_partials, D]), and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kItemWarps = 8;      // warps per block in the item launches
constexpr int kCombineWarps = 16;  // warps per block in the combine launch
constexpr int kPack = 32;          // most edges and rows of a packed item
enum Op { kNone = 0, kMul = 1, kAdd = 2 };

// K1w's weighted operands: w [E, H] and the edge ids that index it, and for
// the weight gradient dw [E, H] and (mul) the row table xrow, all of the
// feature's element type T. K1 passes none of them.
template <typename T>
struct Weighted {
  const int* eid;
  const T* w;
  int H, dh;
  const T* xrow;
  T* dw;
};

// bf16 -> f32 is exact: the bf16 bits are the top half of the f32's
__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
// two f32 rounded to nearest even into one word of two bf16 (a low)
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// v <- VEC elements of T at p, as f32: float4 or one float; 8 bf16 (one
// 16-byte load) or one bf16
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float> && VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (std::is_same_v<T, float>) {
    static_assert(VEC == 1, "float loads 4 or 1");
    v[0] = __ldg(p);
  } else if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = lo_bf16(w[i]);
      v[2 * i + 1] = hi_bf16(w[i]);
    }
  } else {
    static_assert(VEC == 1, "bf16 loads 8 or 1");
    v[0] = lo_bf16(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

// VEC f32 values stored at p as T (bf16 rounded to nearest even): float
// stores 4 (one float4), 8 (two: a bf16 kernel's f32 partials) or 1
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float> && VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      reinterpret_cast<float4*>(p)[i / 4] =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (std::is_same_v<T, float>) {
    static_assert(VEC == 1, "float stores 8, 4 or 1");
    p[0] = v[0];
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    static_assert(VEC == 1, "bf16 stores 8 or 1");
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// one f32 as T
template <typename T>
__device__ __forceinline__ T to_elem(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// one T as f32 (exact)
template <typename T>
__device__ __forceinline__ float elem_f32(T v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// Rows in flight per lane: K1 eight vectors of loads (32 registers at VEC =
// 4), at least two rows, and at VEC = 8 (bf16) 32 f32 values, at least two
// rows; K1w half that, at least one, and one where dw is written at more
// than one vector a lane (at two, 64 registers spilled 100 B) or at 8 bf16
// a lane (at two, the rows kernel of dx with mul's dw spilled 28-44 B in
// 64 registers).
template <int VEC, int NV, int WOP, int DWOP>
struct ItemUnroll {
  static constexpr int k1 = VEC == 8 ? (NV >= 2 ? 2 : 4)
                            : NV >= 4 ? 2
                                      : 8 / NV;
  static constexpr int value =
      WOP == kNone && DWOP == kNone       ? k1
      : DWOP != kNone && (NV > 1 || VEC == 8) ? 1
                                          : (k1 > 1 ? k1 / 2 : 1);
};

// Blocks an SM: four (64 registers) up to 8 columns a lane (at 8, D = 256,
// K1's rows kernel spills 12 B and still ran faster than at three blocks
// without), two (128) for 16 columns (D > 256) and for the scalar path's 8
// or 16, which spilled up to 164 B at 64
template <int VEC, int NV>
struct ItemBlocks {
  static constexpr int value = VEC * NV >= 16 || (VEC == 1 && NV >= 8) ? 2
                                                                        : 4;
};

// Loads lane (g, l)'s NV vectors of source row s (zeros where `live` is
// false or past D), as f32: vector k covers columns c0 + (k * L + l) * VEC.
template <typename T, int VEC, int L, int NV>
__device__ __forceinline__ void gather_row(const T* __restrict__ x,
                                           long long s, int D, int c0, int l,
                                           bool live, float (&v)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = c0 + (k * L + l) * VEC;
    if (live && col < D) {
      load_vec<T, VEC>(x + s * D + col, v[k]);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[k][c] = 0.f;
    }
  }
}

template <typename T, int VEC, int L, int NV>
__device__ __forceinline__ void store_row(T* __restrict__ dst, int D,
                                          int c0, int l,
                                          float (&acc)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = c0 + (k * L + l) * VEC;
    if (col < D) store_vec<T, VEC>(dst + col, acc[k]);
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[k][c] = 0.f;
  }
}

template <int NV, int VEC>
__device__ __forceinline__ void zero(float (&a)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int c = 0; c < VEC; ++c) a[k][c] = 0.f;
}

// K1w: the heads of lane l's NV vectors in the column pass from c0 (slot s
// = k * L + l of the lane group, columns c0 + s * VEC; head = column / dh,
// clamped to H - 1 past D), which vectors read the weight of the vector
// before them, and for dw the masks of `head_tree` (bit j of same[k]: slot
// s + 2^j of this pass lies in slot s's head), of the slots that write
// (first: a head's first slot in the pass) and of those that add to what an
// earlier pass wrote (cont: the head began before c0, past 512 columns
// only). ON false (K1) computes nothing.
template <int VEC, int L, int NV, bool ON>
struct Heads {
  int head[NV];
  unsigned same[NV];
  unsigned reuse = 0, first = 0, cont = 0;

  __device__ __forceinline__ Heads(int c0, int l, int D, int H, int dh) {
    if constexpr (ON) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int s = k * L + l;
        const int col = c0 + s * VEC;
        const bool live = col < D;
        const int h = live ? col / dh : H - 1;
        const int h0 = h * dh;
        const int hend = min(D, h0 + dh);
        head[k] = h;
        same[k] = 0;
#pragma unroll
        for (int j = 0; (1 << j) < L * NV; ++j)
          if (live && s + (1 << j) < L * NV && col + (1 << j) * VEC < hend)
            same[k] |= 1u << j;
        if (k > 0 && h == head[k > 0 ? k - 1 : 0]) reuse |= 1u << k;
        if (live && (s == 0 || col == h0)) first |= 1u << k;
        if (live && s == 0 && col != h0) cont |= 1u << k;
      }
    }
  }
};

// K1w: wv[k] <- edge e's weight for vector k's head (0 where `live` is
// false), read once per head the lane's vectors touch.
template <typename T, int VEC, int L, int NV>
__device__ __forceinline__ void load_weights(
    const Weighted<T>& wt, int e, const Heads<VEC, L, NV, true>& hd,
    bool live, float (&wv)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!live) {
      wv[k] = 0.f;
    } else if (k > 0 && (hd.reuse >> k & 1u)) {
      wv[k] = wv[k > 0 ? k - 1 : 0];
    } else {
      float w1[1];
      load_vec<T, 1>(wt.w + static_cast<size_t>(e) * wt.H + hd.head[k], w1);
      wv[k] = w1[0];
    }
  }
}

// acc += the gathered vector v combined with its weight by WOP
template <int WOP, int NV, int VEC>
__device__ __forceinline__ void accumulate(float (&acc)[NV][VEC],
                                           const float (&v)[NV][VEC],
                                           const float (&wv)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      if constexpr (WOP == kMul) {
        acc[k][c] += v[k][c] * wv[k];
      } else if constexpr (WOP == kAdd) {
        acc[k][c] += v[k][c] + wv[k];
      } else {
        acc[k][c] += v[k][c];
      }
    }
}

// K1w's dw partial of one vector: <g, xrow> (mul) or the sum of g (add,
// which leaves xr unread)
template <int DWOP, int VEC>
__device__ __forceinline__ float dw_part(const float (&v)[VEC],
                                         const float (&xr)[VEC]) {
  float p = 0.f;
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    if constexpr (DWOP == kMul) {
      p += v[c] * xr[c];
    } else {
      p += v[c];
    }
  }
  return p;
}

// p[u][k] <- at each head's first slot of the pass, the sum of p over the
// head's slots in this pass (elsewhere partial sums): a segmented tree over
// the lane group's slots s = k * L + l in a fixed order, level j adding
// slot s + 2^j where it lies in s's head (`Heads::same`); slot s + 2^j is
// lane l + 2^j of vector k, lane l + 2^j - L of vector k + 1, or, from 2^j
// = L on, this lane's vector k + 2^j / L. Every lane calls it. (Skipping
// the levels past a head's dh / VEC slots with a uniform break slowed dx
// with dw at one head by 15%: experiments/torch_spmm/k1w_k8_variants.py.)
template <int U, int L, int NV>
__device__ __forceinline__ void head_tree(float (&p)[U][NV],
                                          const unsigned (&same)[NV], int l) {
#pragma unroll
  for (int j = 0; (1 << j) < L * NV; ++j) {
    const int o = 1 << j;
    float t[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (o < L) {
          const float dn = __shfl_down_sync(kFull, p[u][k], o, L);
          const float up = __shfl_up_sync(
              kFull, p[u][k + 1 < NV ? k + 1 : k], L - o, L);
          t[u][k] = l + o < L ? dn : up;
        } else {
          const int k2 = k + o / L;
          t[u][k] = p[u][k2 < NV ? k2 : NV - 1];
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (same[k] >> j & 1u) p[u][k] += t[u][k];
  }
}

// K1w: the lanes whose slot is its head's first write edge e's dw of the
// head (adding to an earlier pass's part where the head began there).
template <typename T, int VEC, int L, int NV>
__device__ __forceinline__ void store_dw(const Weighted<T>& wt, int e,
                                         const Heads<VEC, L, NV, true>& hd,
                                         const float (&p)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (hd.first >> k & 1u) {
      T* o = wt.dw + static_cast<size_t>(e) * wt.H + hd.head[k];
      *o = to_elem<T>((hd.cont >> k & 1u) ? elem_f32(*o) + p[k] : p[k]);
    }
  }
}

// The item kernels run over the two parts of the work list of `pack_rows`,
// one warp an item, with a minimum of blocks an SM set (with the block size
// alone ptxas held some instantiations to 32 to 64 registers and spilled the
// gathered rows, which serialised their loads). WOP combines each gathered
// row with its edge's weight (K1w: kMul, kAdd; kNone for K1 and for the
// unweighted dx beside a DWOP); DWOP adds the weight gradient of the
// transposed pass (K1w over CSR, where the gathered rows are the cotangent
// g[dst_e] and the item's row is the source s): kMul dw[eid, h] = <g[dst_e],
// xrow[s]> over head h's columns, kAdd their sum of g[dst_e]. The sum for
// `out` is skipped when it is null (the weight gradient alone).

// Items (x, y, z, w) of one row: edges [y, z) of row x, a piece (w >= 0:
// its partial slot) or the whole row (w == -1). The lane groups take
// interleaved edges and are summed by a fixed shuffle tree. A piece's sum
// goes to its f32 partial row, a whole row's to out as T.
template <typename T, int VEC, int L, int NV, int WOP, int DWOP>
__global__ void __launch_bounds__(kItemWarps * 32, ItemBlocks<VEC, NV>::value)
spmm_rows(const T* __restrict__ x, const int* __restrict__ indices,
          const int4* __restrict__ items, int n_items, int D,
          T* __restrict__ out, float* __restrict__ partials,
          const Weighted<T> wt) {
  constexpr bool kW = WOP != kNone || DWOP != kNone;
  constexpr int G = 32 / L;
  constexpr int U = ItemUnroll<VEC, NV, WOP, DWOP>::value;
  constexpr int CW = L * NV * VEC;  // columns a pass
  const int lane = threadIdx.x & 31;
  const int g = lane / L;
  const int l = lane % L;
  const int it = blockIdx.x * kItemWarps + (threadIdx.x >> 5);
  if (it >= n_items) return;  // uniform across the warp
  const int4 pc = __ldg(items + it);
  // the first 32 indices (and edge ids), a lane each (64-bit offsets: y +
  // 32 + lane may pass INT_MAX near E = 2^31)
  const bool has = lane < pc.z - pc.y;
  const int mine = has ? __ldg(indices + pc.y + lane) : 0;
  int mine_e = 0;
  if constexpr (kW) mine_e = has ? __ldg(wt.eid + pc.y + lane) : 0;
  // a launch without dw always stores (known at compile time: K1 and the
  // forward keep their sum free of the branch)
  const bool store = DWOP == kNone || out != nullptr;
  float* const part =
      pc.w >= 0 ? partials + static_cast<size_t>(pc.w) * D : nullptr;
  T* const row = out + static_cast<size_t>(pc.x) * D;
  for (int c0 = 0; c0 < D; c0 += CW) {
    const Heads<VEC, L, NV, kW> hd(c0, l, D, wt.H, wt.dh);
    float acc[NV][VEC];
    zero(acc);
    float xr[NV][VEC];  // the row's own x (mul's dw)
    if constexpr (DWOP == kMul)
      gather_row<T, VEC, L, NV>(wt.xrow, pc.x, D, c0, l, true, xr);
    int cur = mine, cur_e = mine_e;
    for (long long base = pc.y; base < pc.z; base += 32) {
      const int n = static_cast<int>(min(32LL, pc.z - base));
      const long long next_e = base + 32 + lane;
      const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
      int next_id = 0;
      if constexpr (kW) next_id = next_e < pc.z ? __ldg(wt.eid + next_e) : 0;
      for (int j0 = 0; j0 < n; j0 += U * G) {
        float v[U][NV][VEC];
        float wv[U][NV];
        int ev[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * G + g;
          const int s = __shfl_sync(kFull, cur, j & 31);
          gather_row<T, VEC, L, NV>(x, s, D, c0, l, j < n, v[u]);
          if constexpr (kW) ev[u] = __shfl_sync(kFull, cur_e, j & 31);
          if constexpr (WOP != kNone)
            load_weights(wt, ev[u], hd, j < n && store, wv[u]);
        }
        if (store) {  // uniform across the warp
#pragma unroll
          for (int u = 0; u < U; ++u) accumulate<WOP>(acc, v[u], wv[u]);
        }
        if constexpr (DWOP != kNone) {
          float p[U][NV];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int k = 0; k < NV; ++k)
              p[u][k] = dw_part<DWOP>(v[u][k], xr[k]);
          head_tree<U, L, NV>(p, hd.same, l);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (j0 + u * G + g < n) store_dw(wt, ev[u], hd, p[u]);
        }
      }
      cur = next;
      if constexpr (kW) cur_e = next_id;
    }
    if (store) {  // uniform across the warp
#pragma unroll
      for (int off = 16; off >= L; off >>= 1)
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[k][c] += __shfl_xor_sync(kFull, acc[k][c], off);
      if (g == 0) {
        if constexpr (std::is_same_v<T, float>) {
          store_row<float, VEC, L, NV>(part != nullptr ? part : row, D, c0, l,
                                       acc);
        } else if (part != nullptr) {
          store_row<float, VEC, L, NV>(part, D, c0, l, acc);
        } else {
          store_row<T, VEC, L, NV>(row, D, c0, l, acc);
        }
      }
    }
    if constexpr (DWOP != kNone) __syncwarp();  // dw of this pass visible
  }
}

// Packs (x, y, z, -nr): the nr consecutive rows from x, edges [y, z), at
// most kPack of each; their indices (and edge ids) and row pointers are
// loaded together.
template <typename T, int VEC, int L, int NV, int WOP, int DWOP>
__global__ void __launch_bounds__(kItemWarps * 32, ItemBlocks<VEC, NV>::value)
spmm_packs(const T* __restrict__ x, const int* __restrict__ indices,
           const int* __restrict__ indptr, const int4* __restrict__ items,
           int n_items, int D, T* __restrict__ out, const Weighted<T> wt) {
  constexpr bool kW = WOP != kNone || DWOP != kNone;
  constexpr int G = 32 / L;
  // mul's dw gathers the edge's row of xrow beside it: half the rows again
  constexpr int U0 = ItemUnroll<VEC, NV, WOP, DWOP>::value;
  constexpr int U = DWOP == kMul && U0 > 1 ? U0 / 2 : U0;
  constexpr int CW = L * NV * VEC;  // columns a pass
  __shared__ int s_idx[kItemWarps][kPack];
  __shared__ int s_ptr[kItemWarps][kPack + 1];
  __shared__ int s_eid[kW ? kItemWarps : 1][kW ? kPack : 1];
  const int wb = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / L;
  const int l = lane % L;
  const int it = blockIdx.x * kItemWarps + wb;
  if (it >= n_items) return;  // uniform across the warp
  const int4 pc = __ldg(items + it);
  const int mine = lane < pc.z - pc.y ? __ldg(indices + pc.y + lane) : 0;
  const int ptr = lane < -pc.w ? __ldg(indptr + pc.x + lane) : 0;
  // a pack of nr short rows and n edges: lane group g walks the edges
  // of its chunk [a, b) = [g n / G, (g + 1) n / G) in order, its loads
  // in flight across row ends, and stores the rows that end in (a, b]
  // (group 0 also the empty rows at 0). A row that began in an earlier
  // chunk waits for the partial sum of the chunks before it, passed
  // group to group by G - 1 shuffles: each row is summed in one order.
  const int n = pc.z - pc.y;
  const int nr = -pc.w;
  int* sx = s_idx[wb];
  int* sp = s_ptr[wb];
  int* se = s_eid[kW ? wb : 0];
  if (lane < n) sx[lane] = mine;
  if (lane < nr) sp[lane] = ptr - pc.y;
  if (lane == 0) sp[nr] = n;
  if constexpr (kW) {
    if (lane < n) se[lane] = __ldg(wt.eid + pc.y + lane);
  }
  __syncwarp();
  const int a = g * n / G;
  const int b = (g + 1) * n / G;
  int r0 = 0, hi = nr;  // the first row that ends past a
  while (r0 < hi) {
    const int mid = (r0 + hi) >> 1;
    if (sp[mid + 1] > a) {
      hi = mid;
    } else {
      r0 = mid + 1;
    }
  }
  // row r0 began in an earlier chunk (never with one group)
  const bool open_left = G > 1 && r0 < nr && sp[r0] < a;
  const bool store = DWOP == kNone || out != nullptr;
  // dw's shuffles need the whole warp: every group takes as many steps as
  // the longest chunk
  const int kend = DWOP == kNone ? b : a + (n + G - 1) / G;
  for (int c0 = 0; c0 < D; c0 += CW) {
    const Heads<VEC, L, NV, kW> hd(c0, l, D, wt.H, wt.dh);
    float acc[NV][VEC], head[NV][VEC];
    zero(acc);
    zero(head);
    if (store && g == 0)
      for (int r = 0; r < r0; ++r)
        store_row<T, VEC, L, NV>(out + static_cast<size_t>(pc.x + r) * D,
                              D, c0, l, acc);
    int r = r0;
    int rend = r0 < nr ? sp[r0 + 1] : 0;
    int dr = r, drend = rend;  // mul's dw: the row of the edge gathered
    for (int k0 = a; k0 < kend; k0 += U) {
      float v[U][NV][VEC];
      float wv[U][NV];
      float xr[U][NV][VEC];
      int ev[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = k0 + u;
        const bool live = e < b;
        gather_row<T, VEC, L, NV>(x, live ? sx[e] : 0, D, c0, l, live,
                                  v[u]);
        if constexpr (kW) ev[u] = live ? se[e] : 0;
        if constexpr (WOP != kNone)
          load_weights(wt, ev[u], hd, live && store, wv[u]);
        if constexpr (DWOP == kMul) {
          if (live) {
            while (e >= drend) {
              ++dr;
              drend = sp[dr + 1];
            }
          }
          gather_row<T, VEC, L, NV>(wt.xrow, pc.x + dr, D, c0, l, live,
                                    xr[u]);
        }
      }
      if (store) {  // uniform across the warp
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = k0 + u;
          if (e < b) {
            while (e >= rend) {  // row r ended before edge e
              if (open_left && r == r0) {
#pragma unroll
                for (int k = 0; k < NV; ++k)
#pragma unroll
                  for (int c = 0; c < VEC; ++c) head[k][c] = acc[k][c];
                zero(acc);
              } else {
                store_row<T, VEC, L, NV>(
                    out + static_cast<size_t>(pc.x + r) * D, D, c0, l,
                    acc);
              }
              ++r;
              rend = sp[r + 1];
            }
            accumulate<WOP>(acc, v[u], wv[u]);
          }
        }
      }
      if constexpr (DWOP != kNone) {
        float p[U][NV];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < NV; ++k)
            p[u][k] = dw_part<DWOP>(v[u][k], xr[u][k]);
        head_tree<U, L, NV>(p, hd.same, l);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k0 + u < b) store_dw(wt, ev[u], hd, p[u]);
      }
    }
    if (store) {  // uniform across the warp
      // rows that end at b (the empty ones there too)
      while (r < nr && rend <= b) {
        if (open_left && r == r0) {
#pragma unroll
          for (int k = 0; k < NV; ++k)
#pragma unroll
            for (int c = 0; c < VEC; ++c) head[k][c] = acc[k][c];
          zero(acc);
        } else {
          store_row<T, VEC, L, NV>(out + static_cast<size_t>(pc.x + r) * D,
                                D, c0, l, acc);
        }
        ++r;
        rend = r < nr ? sp[r + 1] : 0;
      }
      if constexpr (G > 1) {
        // acc: the partial of the row still open at b, passed right; a
        // chunk inside one row adds what it received before passing on
        const bool through = open_left && r == r0;
        for (int k = 1; k < G; ++k) {
#pragma unroll
          for (int q = 0; q < NV; ++q)
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              const float cin = __shfl_up_sync(kFull, acc[q][c], L);
              if (g == k && open_left) {
                if (through) {
                  acc[q][c] = cin + acc[q][c];
                } else {
                  head[q][c] = cin + head[q][c];
                }
              }
            }
        }
        if (open_left && !through)
          store_row<T, VEC, L, NV>(out + static_cast<size_t>(pc.x + r0) * D,
                                D, c0, l, head);
      }
    }
    if constexpr (DWOP != kNone) __syncwarp();  // dw of this pass visible
  }
}

// One block per split row: warp w sums partial slots p0 + w, p0 + w + W, ...
// in order, then warp 0 adds the W warp sums in order, in f32, and stores
// the row as T.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
spmm_combine(const float* __restrict__ partials,
             const int* __restrict__ split_rows,
             const int* __restrict__ split_ptr, int D, T* __restrict__ out) {
  __shared__ float sums[kCombineWarps][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = split_ptr[blockIdx.x];
  const int p1 = split_ptr[blockIdx.x + 1];
  T* o = out + static_cast<size_t>(split_rows[blockIdx.x]) * D;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int col = c0 + lane;
    float acc = 0.f;
    if (col < D) {
#pragma unroll 8
      for (int p = p0 + w; p < p1; p += kCombineWarps)
        acc += partials[static_cast<size_t>(p) * D + col];
    }
    sums[w][lane] = acc;
    __syncthreads();
    if (w == 0 && col < D) {
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < kCombineWarps; ++k) total += sums[k][lane];
      o[col] = to_elem<T>(total);
    }
    __syncthreads();
  }
}

// The side stream of each device for the packs and the two events that
// fork it from and join it back to the caller's stream, made at first use
// and reused (their record-wait pairs run under `lock`, one call at a time).
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

std::mutex side_lock;

cudaError_t side_of(int device, Side** side) {
  static Side sides[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidValue;
  Side& sd = sides[device];
  cudaError_t err = cudaSuccess;
  if (sd.stream == nullptr)
    err = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
  if (err == cudaSuccess && sd.fork == nullptr)
    err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
  if (err == cudaSuccess && sd.join == nullptr)
    err = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
  *side = &sd;
  return err;
}

// What one call walks: the work list (n_rows items of one row, then n_packs
// packs), the tables and the outputs (the partials f32 whatever T is).
template <typename T>
struct Walk {
  const T* x;
  const int* indices;
  const int* indptr;
  const int4* items;
  int n_rows, n_packs, D;
  T* out;
  float* partials;
};

// The two item launches, one warp an item: the rows' items on `s`, the
// packs (at items + n_rows) on the device's side stream, forked from and
// joined back to `s`, so the two kernels overlap (a hub's pieces beside the
// short rows) and `s` sees both done.
template <typename T, int VEC, int L, int NV, int WOP, int DWOP>
cudaError_t launch_items(int device, const Walk<T>& a,
                         const Weighted<T>& wt, cudaStream_t s) {
  const dim3 threads(kItemWarps * 32);
  const auto blocks = [](int n) { return (n + kItemWarps - 1) / kItemWarps; };
  if (a.n_rows == 0 || a.n_packs == 0) {
    if (a.n_packs > 0)
      spmm_packs<T, VEC, L, NV, WOP, DWOP>
          <<<blocks(a.n_packs), threads, 0, s>>>(a.x, a.indices, a.indptr,
                                                 a.items, a.n_packs, a.D,
                                                 a.out, wt);
    if (a.n_rows > 0)
      spmm_rows<T, VEC, L, NV, WOP, DWOP>
          <<<blocks(a.n_rows), threads, 0, s>>>(a.x, a.indices, a.items,
                                                a.n_rows, a.D, a.out,
                                                a.partials, wt);
    return cudaSuccess;
  }
  std::lock_guard<std::mutex> guard(side_lock);
  Side* side = nullptr;
  cudaError_t err = side_of(device, &side);
  if (err == cudaSuccess) err = cudaEventRecord(side->fork, s);
  if (err == cudaSuccess)
    err = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (err != cudaSuccess) return err;
  spmm_packs<T, VEC, L, NV, WOP, DWOP>
      <<<blocks(a.n_packs), threads, 0, side->stream>>>(
          a.x, a.indices, a.indptr, a.items + a.n_rows, a.n_packs, a.D,
          a.out, wt);
  spmm_rows<T, VEC, L, NV, WOP, DWOP><<<blocks(a.n_rows), threads, 0, s>>>(
      a.x, a.indices, a.items, a.n_rows, a.D, a.out, a.partials, wt);
  err = cudaEventRecord(side->join, side->stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(s, side->join, 0);
  return err;
}

// Lanes a row (L) and vectors a lane (NV) at width D, for vectors of `vec`
// elements (4 floats, 8 bf16, or 1 on the scalar path): L covers D in one
// vector a lane up to 32 vectors, then NV grows to 16 / vec vectors, 16
// columns a lane: one pass up to 512 columns.
int items_config(int D, int vec, int* nv) {
  const int vecs = D / vec;
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes <<= 1;
  const int cap = 16 / vec;
  *nv = 1;
  while (*nv < cap && lanes * *nv < vecs) *nv <<= 1;
  return lanes;
}

// The item launches of one (T, WOP, DWOP) at the configuration (vec, lanes,
// nv) that `items_config` chose.
template <typename T, int WOP, int DWOP>
cudaError_t launch_config(int device, int vec, int lanes, int nv,
                          const Walk<T>& a, const Weighted<T>& wt,
                          cudaStream_t s) {
#define PGL_ITEMS(V, L, N)                             \
  if (vec == V && lanes == L && nv == N)               \
    return launch_items<T, V, L, N, WOP, DWOP>(device, a, wt, s);
  if constexpr (std::is_same_v<T, float>) {
    PGL_ITEMS(4, 1, 1) PGL_ITEMS(4, 2, 1) PGL_ITEMS(4, 4, 1)
    PGL_ITEMS(4, 8, 1) PGL_ITEMS(4, 16, 1) PGL_ITEMS(4, 32, 1)
    PGL_ITEMS(4, 32, 2) PGL_ITEMS(4, 32, 4)
  } else {
    PGL_ITEMS(8, 1, 1) PGL_ITEMS(8, 2, 1) PGL_ITEMS(8, 4, 1)
    PGL_ITEMS(8, 8, 1) PGL_ITEMS(8, 16, 1) PGL_ITEMS(8, 32, 1)
    PGL_ITEMS(8, 32, 2)
  }
  PGL_ITEMS(1, 1, 1) PGL_ITEMS(1, 2, 1) PGL_ITEMS(1, 4, 1) PGL_ITEMS(1, 8, 1)
  PGL_ITEMS(1, 16, 1) PGL_ITEMS(1, 32, 1) PGL_ITEMS(1, 32, 2)
  PGL_ITEMS(1, 32, 4) PGL_ITEMS(1, 32, 8) PGL_ITEMS(1, 32, 16)
#undef PGL_ITEMS
  return cudaErrorInvalidValue;
}

// K1 (wop = dwop = kNone) or K1w over the work list, and, where rows split
// and out is written, the combine launch.
template <typename T>
int run_items(int device, int wop, int dwop, const Walk<T>& a,
              const Weighted<T>& wt, const int* split_rows,
              const int* split_ptr, int n_split, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_rows < 0 || a.n_packs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_rows + a.n_packs == 0 || a.D <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) |
                         reinterpret_cast<uintptr_t>(a.out) |
                         reinterpret_cast<uintptr_t>(a.partials) |
                         reinterpret_cast<uintptr_t>(wt.xrow);
  // a 16-byte vector: 4 floats or 8 bf16; a weighted vector lies in one
  // head (K1 passes dh = 0)
  constexpr int kVec = std::is_same_v<T, float> ? 4 : 8;
  const int vec = a.D % kVec == 0 && wt.dh % kVec == 0 && (ptrs & 15) == 0
                      ? kVec
                      : 1;
  int nv = 1;
  const int lanes = items_config(a.D, vec, &nv);
  if (wop == kNone && dwop == kNone) {
    err = launch_config<T, kNone, kNone>(device, vec, lanes, nv, a, wt, s);
  } else if (wop == kMul && dwop == kNone) {
    err = launch_config<T, kMul, kNone>(device, vec, lanes, nv, a, wt, s);
  } else if (wop == kAdd && dwop == kNone) {
    err = launch_config<T, kAdd, kNone>(device, vec, lanes, nv, a, wt, s);
  } else if (wop == kMul && dwop == kMul) {
    err = launch_config<T, kMul, kMul>(device, vec, lanes, nv, a, wt, s);
  } else if (wop == kNone && dwop == kAdd) {
    err = launch_config<T, kNone, kAdd>(device, vec, lanes, nv, a, wt, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split > 0 && a.out != nullptr) {
    spmm_combine<T><<<n_split, kCombineWarps * 32, 0, s>>>(
        a.partials, split_rows, split_ptr, a.D, a.out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1w over the same work list: out [R, D] = sum over the row's edges of
// x[indices[e]] (wop 1: times, wop 2: plus) w[eid[e], col / (D / H)], w
// [E, H] of x's type in the caller's edge order (wop 0: unweighted, taken
// only with dwop 2, add's dx; K1 is pgl_spmm_f32). dwop 1 (with xrow [R, D]:
// wop must be 1) or 2 also writes dw [E, H] at eid. With a dwop, `out` may
// be null: dw alone, no combine launch, and w is not read.
template <typename T>
int run_weighted(int device, int wop, int dwop, const T* x,
                 const int* indices, const int* indptr, const int* eid,
                 const T* w, int H, const int* items, int n_rows,
                 int n_packs, const int* split_rows, const int* split_ptr,
                 int n_split, int D, T* out, float* partials, const T* xrow,
                 T* dw, void* stream) {
  if (H <= 0 || D % H != 0 || (wop == kNone && dwop == kNone))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out == nullptr && dwop != kNone)
    wop = dwop == kMul ? kMul : kNone;  // dw alone: the weights go unread
  const Walk<T> a{x,       indices, indptr,
                  reinterpret_cast<const int4*>(items),
                  n_rows,  n_packs, D,
                  out,     partials};
  const Weighted<T> wt{eid, w, H, D / H, xrow, dw};
  return run_items(device, wop, dwop, a, wt, split_rows, split_ptr, n_split,
                   stream);
}

}  // namespace

// The float32 entry points, or (built with -DPGL_BF16, the library
// segment_kernels_bf16) the bf16 ones: each half instantiates only its
// element type, so the two build in parallel.
#ifndef PGL_BF16

// K1: out [R, D] = the sorted-segment sum of x [N, D] over the layout's
// work list `items` (pack_rows): n_rows items of one row, then n_packs
// packs (indptr gives their row boundaries).
extern "C" int pgl_spmm_f32(int device, const float* x, const int* indices,
                            const int* indptr, const int* items, int n_rows,
                            int n_packs, const int* split_rows,
                            const int* split_ptr, int n_split, int D,
                            float* out, float* partials, void* stream) {
  const Walk<float> a{x,       indices, indptr,
                      reinterpret_cast<const int4*>(items),
                      n_rows,  n_packs, D,
                      out,     partials};
  return run_items(device, kNone, kNone, a, Weighted<float>{}, split_rows,
                   split_ptr, n_split, stream);
}

// K1w (run_weighted) on float tables.
extern "C" int pgl_spmm_weighted_f32(
    int device, int wop, int dwop, const float* x, const int* indices,
    const int* indptr, const int* eid, const float* w, int H,
    const int* items, int n_rows, int n_packs, const int* split_rows,
    const int* split_ptr, int n_split, int D, float* out, float* partials,
    const float* xrow, float* dw, void* stream) {
  return run_weighted(device, wop, dwop, x, indices, indptr, eid, w, H,
                      items, n_rows, n_packs, split_rows, split_ptr, n_split,
                      D, out, partials, xrow, dw, stream);
}

#else

// K1 on bf16 tables: x [N, D] and out [R, D] bf16 (passed as raw 16-bit
// words), partials [n_partials, D] f32; the sums f32, each row rounded once
// to nearest even.
extern "C" int pgl_spmm_bf16(int device, const void* x, const int* indices,
                             const int* indptr, const int* items, int n_rows,
                             int n_packs, const int* split_rows,
                             const int* split_ptr, int n_split, int D,
                             void* out, float* partials, void* stream) {
  const Walk<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(x),
                              indices,
                              indptr,
                              reinterpret_cast<const int4*>(items),
                              n_rows,
                              n_packs,
                              D,
                              static_cast<__nv_bfloat16*>(out),
                              partials};
  return run_items(device, kNone, kNone, a, Weighted<__nv_bfloat16>{},
                   split_rows, split_ptr, n_split, stream);
}

// K1w on bf16 tables: x, w, xrow, out and dw bf16 (raw 16-bit words),
// partials f32; messages and sums f32, each stored value rounded once to
// nearest even.
extern "C" int pgl_spmm_weighted_bf16(
    int device, int wop, int dwop, const void* x, const int* indices,
    const int* indptr, const int* eid, const void* w, int H,
    const int* items, int n_rows, int n_packs, const int* split_rows,
    const int* split_ptr, int n_split, int D, void* out, float* partials,
    const void* xrow, void* dw, void* stream) {
  using B = __nv_bfloat16;
  return run_weighted(device, wop, dwop, static_cast<const B*>(x), indices,
                      indptr, eid, static_cast<const B*>(w), H, items,
                      n_rows, n_packs, split_rows, split_ptr, n_split, D,
                      static_cast<B*>(out), partials,
                      static_cast<const B*>(xrow), static_cast<B*>(dw),
                      stream);
}

#endif  // PGL_BF16
