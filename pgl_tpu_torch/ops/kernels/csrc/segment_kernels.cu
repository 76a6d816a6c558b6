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
// K1w, the same kernel on weighted messages, replaces `_kernel` run on
// `_weighted_msgs` (the TPU path's `spmm_weighted`, the fused
// `send_ue_recv`): out[d] = sum_e x[src_e] (*|+) w_e, with w [E] or per head
// [E, H]. Each lane combines its gathered columns with its edge's weight in
// registers, so no [E, D] message tensor exists. Its gradient is one pass of
// the same kernel over the CSR layout: dx is the weighted (mul) or plain
// (add) transposed sum, and the warp that gathers g[dst_e] for dx also
// reduces dw_e per head (<g[dst_e], x[s]>, or the sum of g[dst_e]) with
// shuffles and writes it once at the edge's original id. The reference
// materialises two [E, D] tensors for dw outside its kernel.
//
// What bounds it: bytes, and the latency of the loads that lead to them. Per
// call it must read x once ([N, D] f32), the indices ([E] i32) and the row
// pointer, and write out ([N, D] f32); the E*D additions are far below the
// card's f32 rate. Each source row is read straight from x for each edge:
// there is no [E, D] message buffer in device memory (the TPU path
// materialises one). K1's design (`spmm_rows`, `spmm_packs`):
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
//     only on D: every run gives the same bits.
// K1w keeps its own structure (`spmm_pieces`: one warp per piece of at
// most ET edges, 128 columns a pass).
//
// Calling convention: launches on the given stream (K1's packs on a side
// stream forked from it and joined back, so what the caller queues after
// the call sees them done), does not synchronise, allocates nothing (the
// caller passes `out` [N, D] and `partials` [num_partials, D]), and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPieceWarps = 8;     // warps per block in the piece launch
constexpr int kItemWarps = 8;      // warps per block in K1's item launch
constexpr int kCombineWarps = 16;  // warps per block in the combine launch
constexpr int kPack = 32;          // most edges and rows of a packed item
// gathered rows in flight per lane for K1w: its weights, edge ids and
// weight-gradient scan hold more registers, and at 8 its backward took 101
// (2 blocks an SM) and 1.75x to 1.8x the time it takes at 4, with 64
// (experiments/torch_spmm/k1w_dw_variants.py)
constexpr int kUnrollWeighted = 4;
enum Op { kNone = 0, kMul = 1, kAdd = 2 };

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// K1's rows in flight per lane: eight vectors of loads (32 registers at
// VEC = 4), at least two rows
template <int NV>
struct ItemUnroll {
  static constexpr int value = NV >= 4 ? 2 : 8 / NV;
};

// K1's blocks an SM: four (64 registers) up to 8 columns a lane (at 8, D =
// 256, the rows' kernel spills 12 B and still ran faster than at three
// blocks without), two (128) for 16 columns (D > 256) and for the scalar
// path's 8 or 16, which spilled up to 164 B at 64
template <int VEC, int NV>
struct ItemBlocks {
  static constexpr int value = VEC * NV >= 16 || (VEC == 1 && NV >= 8) ? 2
                                                                        : 4;
};

// Loads lane (g, l)'s NV vectors of source row s (zeros where `live` is
// false or past D): vector k covers columns c0 + (k * L + l) * VEC.
template <int VEC, int L, int NV>
__device__ __forceinline__ void gather_row(const float* __restrict__ x,
                                           long long s, int D, int c0, int l,
                                           bool live, float (&v)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = c0 + (k * L + l) * VEC;
    if (live && col < D) {
      load_vec<VEC>(x + s * D + col, v[k]);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[k][c] = 0.f;
    }
  }
}

template <int VEC, int L, int NV>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int D,
                                          int c0, int l,
                                          float (&acc)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = c0 + (k * L + l) * VEC;
    if (col < D) store_vec<VEC>(dst + col, acc[k]);
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

// K1's kernels run over the two parts of the work list of `pack_rows`, one
// warp an item, with a minimum of blocks an SM set (with the block size
// alone ptxas held some instantiations to 32 to 64 registers and spilled the
// gathered rows, which serialised their loads).

// Items (x, y, z, w) of one row: edges [y, z) of row x, a piece (w >= 0:
// its partial slot) or the whole row (w == -1). The lane groups take
// interleaved edges and are summed by a fixed shuffle tree.
template <int VEC, int L, int NV>
__global__ void __launch_bounds__(kItemWarps * 32, ItemBlocks<VEC, NV>::value)
spmm_rows(const float* __restrict__ x, const int* __restrict__ indices,
          const int4* __restrict__ items, int n_items, int D,
          float* __restrict__ out, float* __restrict__ partials) {
  constexpr int G = 32 / L;
  constexpr int U = ItemUnroll<NV>::value;
  constexpr int CW = L * NV * VEC;  // columns a pass
  const int lane = threadIdx.x & 31;
  const int g = lane / L;
  const int l = lane % L;
  const int it = blockIdx.x * kItemWarps + (threadIdx.x >> 5);
  if (it >= n_items) return;  // uniform across the warp
  const int4 pc = __ldg(items + it);
  // the first 32 indices, a lane each (64-bit offsets: y + 32 + lane may
  // pass INT_MAX near E = 2^31)
  const int mine = lane < pc.z - pc.y ? __ldg(indices + pc.y + lane) : 0;
  float* dst = pc.w >= 0 ? partials + static_cast<size_t>(pc.w) * D
                         : out + static_cast<size_t>(pc.x) * D;
  for (int c0 = 0; c0 < D; c0 += CW) {
    float acc[NV][VEC];
    zero(acc);
    int cur = mine;
    for (long long base = pc.y; base < pc.z; base += 32) {
      const int n = static_cast<int>(min(32LL, pc.z - base));
      const long long next_e = base + 32 + lane;
      const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
      for (int j0 = 0; j0 < n; j0 += U * G) {
        float v[U][NV][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * G + g;
          const int s = __shfl_sync(kFull, cur, j & 31);
          gather_row<VEC, L, NV>(x, s, D, c0, l, j < n, v[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < NV; ++k)
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[k][c] += v[u][k][c];
      }
      cur = next;
    }
#pragma unroll
    for (int off = 16; off >= L; off >>= 1)
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          acc[k][c] += __shfl_xor_sync(kFull, acc[k][c], off);
    if (g == 0) store_row<VEC, L, NV>(dst, D, c0, l, acc);
  }
}

// Packs (x, y, z, -nr): the nr consecutive rows from x, edges [y, z), at
// most kPack of each; their indices and row pointers are loaded together.
template <int VEC, int L, int NV>
__global__ void __launch_bounds__(kItemWarps * 32, ItemBlocks<VEC, NV>::value)
spmm_packs(const float* __restrict__ x, const int* __restrict__ indices,
           const int* __restrict__ indptr, const int4* __restrict__ items,
           int n_items, int D, float* __restrict__ out) {
  constexpr int G = 32 / L;
  constexpr int U = ItemUnroll<NV>::value;
  constexpr int CW = L * NV * VEC;  // columns a pass
  __shared__ int s_idx[kItemWarps][kPack];
  __shared__ int s_ptr[kItemWarps][kPack + 1];
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
  if (lane < n) sx[lane] = mine;
  if (lane < nr) sp[lane] = ptr - pc.y;
  if (lane == 0) sp[nr] = n;
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
  for (int c0 = 0; c0 < D; c0 += CW) {
    float acc[NV][VEC], head[NV][VEC];
    zero(acc);
    zero(head);
    if (g == 0)
      for (int r = 0; r < r0; ++r)
        store_row<VEC, L, NV>(out + static_cast<size_t>(pc.x + r) * D,
                              D, c0, l, acc);
    int r = r0;
    int rend = r0 < nr ? sp[r0 + 1] : 0;
    for (int k0 = a; k0 < b; k0 += U) {
      float v[U][NV][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = k0 + u;
        gather_row<VEC, L, NV>(x, e < b ? sx[e] : 0, D, c0, l, e < b,
                               v[u]);
      }
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
              store_row<VEC, L, NV>(
                  out + static_cast<size_t>(pc.x + r) * D, D, c0, l,
                  acc);
            }
            ++r;
            rend = sp[r + 1];
          }
#pragma unroll
          for (int k = 0; k < NV; ++k)
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[k][c] += v[u][k][c];
        }
      }
    }
    // rows that end at b (the empty ones there too)
    while (r < nr && rend <= b) {
      if (open_left && r == r0) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int c = 0; c < VEC; ++c) head[k][c] = acc[k][c];
        zero(acc);
      } else {
        store_row<VEC, L, NV>(out + static_cast<size_t>(pc.x + r) * D,
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
        store_row<VEC, L, NV>(out + static_cast<size_t>(pc.x + r0) * D,
                              D, c0, l, head);
    }
  }
}

// K1w: one warp per piece (row, begin, end, slot). LPR lanes cover VEC * LPR
// columns of one edge's row; the warp's 32 / LPR lane groups take
// interleaved edges of the piece and are summed by a fixed shuffle tree.
//
// WOP combines each gathered row with its edge's weight before the sum
// (K1w): kMul multiplies, kAdd adds, kNone leaves it (only beside a DWOP:
// the weight gradient alone, or with the unweighted dx). The weight of
// layout position e is w[eid[e] * H + head], head = col / dh: w stays in
// the caller's edge order. VEC divides dh on weighted launches, so a lane's
// columns lie in one head.
//
// DWOP adds the weight gradient of the transposed pass (K1w over CSR, where
// the gathered rows are the cotangent g[dst_e] and the piece's row is the
// source s): kMul dw[eid, head] = <g[dst_e], xrow[s]> over the head's
// columns, kAdd dw[eid, head] = sum of g[dst_e] over them. A lane's partial
// is summed over the lanes of its head by a segmented shuffle scan; the
// head's first lane in this column pass writes it (a head wider than the
// pass is finished by the later passes, read back after a __syncwarp). The
// sum for `out` is skipped when it is null (weight gradient alone).
template <int VEC, int LPR, int WOP, int DWOP>
__global__ void __launch_bounds__(kPieceWarps * 32)
spmm_pieces(const float* __restrict__ x, const int* __restrict__ indices,
            const int* __restrict__ eid, const float* __restrict__ w, int H,
            int dh, const int4* __restrict__ pieces, int n_pieces, int D,
            float* __restrict__ out, float* __restrict__ partials,
            const float* __restrict__ xrow, float* dw) {
  static_assert(WOP != kNone || DWOP != kNone, "K1 is spmm_rows");
  constexpr int G = 32 / LPR;
  // the summation order of a lane group (edges g, g + G, g + 2G, ...) does
  // not depend on U
  constexpr int U = kUnrollWeighted;
  const int warp = blockIdx.x * kPieceWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int g = lane / LPR;
  const int l = lane % LPR;
  const int4 pc = pieces[warp];  // x: row, y: begin, z: end, w: slot or -1
  // a launch without dw always stores (known here at compile time: the
  // forward and dx keep their sum free of the branch)
  const bool store = DWOP == kNone || out != nullptr;
  float* dst = pc.w < 0 ? out + static_cast<size_t>(pc.x) * D
                        : partials + static_cast<size_t>(pc.w) * D;

  for (int c0 = 0; c0 < D; c0 += LPR * VEC) {
    const int col = c0 + l * VEC;
    const bool active = col < D;  // D % VEC == 0, so the whole vector fits
    // head of lane k of this group (-1 past D)
    auto head_of = [&](int k) {
      const int c = c0 + k * VEC;
      return c < D ? c / dh : -1;
    };
    const int hd = head_of(l);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

    // the weight-gradient scan: bit k set when lane l + 2^k shares this
    // lane's head; the head's first lane in this pass writes, adding to
    // what an earlier pass wrote when the head began there
    unsigned same = 0;
    bool first = false, cont = false;
    float xr[VEC];
    if constexpr (DWOP != kNone) {
#pragma unroll
      for (int k = 0; (1 << k) < LPR; ++k) {
        const int o = l + (1 << k);
        if (o < LPR && head_of(o) == hd) same |= 1u << k;
      }
      first = active && (l == 0 || head_of(l - 1) != hd);
      cont = col % dh != 0;
      if (DWOP == kMul && active) {
        load_vec<VEC>(xrow + static_cast<size_t>(pc.x) * D + col, xr);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xr[k] = 0.f;
      }
    }

    // each lane holds one index (and edge id) of the current 32-edge
    // batch; the next batch's load while this batch's rows are gathered
    // (64-bit edge offsets: begin + 32 + lane may pass INT_MAX near E = 2^31)
    const bool have = lane < pc.z - pc.y;
    int mine = have ? __ldg(indices + pc.y + lane) : 0;
    int mine_e = have ? __ldg(eid + pc.y + lane) : 0;
    for (long long base = pc.y; base < pc.z; base += 32) {
      const int n = static_cast<int>(min(32LL, pc.z - base));
      const long long next_e = base + 32 + lane;
      const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
      const int next_id = next_e < pc.z ? __ldg(eid + next_e) : 0;
      for (int j0 = 0; j0 < n; j0 += U * G) {
        float v[U][VEC];
        float wv[U];
        int ev[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * G + g;
          const int s = __shfl_sync(kFull, mine, j & 31);
          ev[u] = __shfl_sync(kFull, mine_e, j & 31);
          wv[u] = 0.f;
          if (active && j < n) {
            load_vec<VEC>(x + static_cast<size_t>(s) * D + col, v[u]);
            if constexpr (WOP != kNone)
              wv[u] = __ldg(w + static_cast<size_t>(ev[u]) * H + hd);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
          }
        }
        if (store) {  // uniform across the warp
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              if constexpr (WOP == kMul) {
                acc[k] += v[u][k] * wv[u];
              } else if constexpr (WOP == kAdd) {
                acc[k] += v[u][k] + wv[u];
              } else {
                acc[k] += v[u][k];
              }
            }
          }
        }
        if constexpr (DWOP != kNone) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float p = 0.f;
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              p += DWOP == kMul ? v[u][k] * xr[k] : v[u][k];
#pragma unroll
            for (int k = 0; (1 << k) < LPR; ++k) {
              const float t = __shfl_down_sync(kFull, p, 1 << k, LPR);
              if (same >> k & 1u) p += t;
            }
            if (first && j0 + u * G + g < n) {
              float* o = dw + static_cast<size_t>(ev[u]) * H + hd;
              *o = cont ? *o + p : p;
            }
          }
        }
      }
      mine = next;
      mine_e = next_id;
    }
    if (store) {  // uniform across the warp
#pragma unroll
      for (int off = 16; off >= LPR; off >>= 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] += __shfl_xor_sync(kFull, acc[k], off);
      }
      if (g == 0 && active) store_vec<VEC>(dst + col, acc);
    }
    if constexpr (DWOP != kNone) __syncwarp();  // dw of this pass visible
  }
}

// One block per split row: warp w sums partial slots p0 + w, p0 + w + W, ...
// in order, then warp 0 adds the W warp sums in order.
__global__ void __launch_bounds__(kCombineWarps * 32)
spmm_combine(const float* __restrict__ partials,
             const int* __restrict__ split_rows,
             const int* __restrict__ split_ptr, int D,
             float* __restrict__ out) {
  __shared__ float sums[kCombineWarps][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = split_ptr[blockIdx.x];
  const int p1 = split_ptr[blockIdx.x + 1];
  float* o = out + static_cast<size_t>(split_rows[blockIdx.x]) * D;
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
      o[col] = total;
    }
    __syncthreads();
  }
}

struct Args {
  const float* x;
  const int* indices;
  const int* eid;
  const float* w;
  int H, dh;
  const int4* pieces;
  int n_pieces, D;
  float* out;
  float* partials;
  const float* xrow;
  float* dw;
};

template <int VEC, int WOP, int DWOP>
void launch_pieces(int lpr, int blocks, cudaStream_t stream, const Args& a) {
  const int threads = kPieceWarps * 32;
#define PGL_SPMM_CASE(L)                                                    \
  case L:                                                                   \
    spmm_pieces<VEC, L, WOP, DWOP><<<blocks, threads, 0, stream>>>(         \
        a.x, a.indices, a.eid, a.w, a.H, a.dh, a.pieces, a.n_pieces, a.D,   \
        a.out, a.partials, a.xrow, a.dw);                                   \
    break;
  switch (lpr) {
    PGL_SPMM_CASE(1)
    PGL_SPMM_CASE(2)
    PGL_SPMM_CASE(4)
    PGL_SPMM_CASE(8)
    PGL_SPMM_CASE(16)
    default:
      PGL_SPMM_CASE(32)
  }
#undef PGL_SPMM_CASE
}

template <int WOP, int DWOP>
void launch_vec(bool vec4, int lpr, int blocks, cudaStream_t s,
                const Args& a) {
  if (vec4) {
    launch_pieces<4, WOP, DWOP>(lpr, blocks, s, a);
  } else {
    launch_pieces<1, WOP, DWOP>(lpr, blocks, s, a);
  }
}

// K1w's piece launch and, where rows split, the combine launch.
int run(int device, int wop, int dwop, const Args& a, const int* split_rows,
        const int* split_ptr, int n_split, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_pieces <= 0 || a.D <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) |
                         reinterpret_cast<uintptr_t>(a.out) |
                         reinterpret_cast<uintptr_t>(a.partials) |
                         reinterpret_cast<uintptr_t>(a.xrow);
  const bool vec4 = a.D % 4 == 0 && a.dh % 4 == 0 && (ptrs & 15) == 0;
  const int vec = vec4 ? 4 : 1;
  const int lanes = (a.D + vec - 1) / vec;
  int lpr = 1;
  while (lpr < lanes && lpr < 32) lpr <<= 1;
  const int blocks = (a.n_pieces + kPieceWarps - 1) / kPieceWarps;
  if (wop == kMul && dwop == kNone) {
    launch_vec<kMul, kNone>(vec4, lpr, blocks, s, a);
  } else if (wop == kAdd && dwop == kNone) {
    launch_vec<kAdd, kNone>(vec4, lpr, blocks, s, a);
  } else if (wop == kMul && dwop == kMul) {
    launch_vec<kMul, kMul>(vec4, lpr, blocks, s, a);
  } else if (wop == kNone && dwop == kMul) {
    launch_vec<kNone, kMul>(vec4, lpr, blocks, s, a);
  } else if (wop == kNone && dwop == kAdd) {
    launch_vec<kNone, kAdd>(vec4, lpr, blocks, s, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_split > 0 && a.out != nullptr) {
    spmm_combine<<<n_split, kCombineWarps * 32, 0, s>>>(
        a.partials, split_rows, split_ptr, a.D, a.out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The side stream of each device for K1's packs and the two events that
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

// K1's two item launches, one warp an item: the rows' items on `s`, the
// packs (at items + n_rows) on the device's side stream, forked from and
// joined back to `s`, so the two kernels overlap (a hub's pieces beside the
// short rows) and `s` sees both done.
template <int VEC, int L, int NV>
cudaError_t launch_items(int device, const float* x, const int* indices,
                         const int* indptr, const int4* items, int n_rows,
                         int n_packs, int D, float* out, float* partials,
                         cudaStream_t s) {
  const dim3 threads(kItemWarps * 32);
  const auto blocks = [](int n) { return (n + kItemWarps - 1) / kItemWarps; };
  if (n_rows == 0 || n_packs == 0) {
    if (n_packs > 0)
      spmm_packs<VEC, L, NV><<<blocks(n_packs), threads, 0, s>>>(
          x, indices, indptr, items, n_packs, D, out);
    if (n_rows > 0)
      spmm_rows<VEC, L, NV><<<blocks(n_rows), threads, 0, s>>>(
          x, indices, items, n_rows, D, out, partials);
    return cudaSuccess;
  }
  std::lock_guard<std::mutex> guard(side_lock);
  Side* side = nullptr;
  cudaError_t err = side_of(device, &side);
  if (err == cudaSuccess) err = cudaEventRecord(side->fork, s);
  if (err == cudaSuccess)
    err = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (err != cudaSuccess) return err;
  spmm_packs<VEC, L, NV><<<blocks(n_packs), threads, 0, side->stream>>>(
      x, indices, indptr, items + n_rows, n_packs, D, out);
  spmm_rows<VEC, L, NV><<<blocks(n_rows), threads, 0, s>>>(
      x, indices, items, n_rows, D, out, partials);
  err = cudaEventRecord(side->join, side->stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(s, side->join, 0);
  return err;
}

// Lanes a row (L) and vectors a lane (NV) at width D: L covers D in one
// vector a lane up to 32 vectors, then NV grows to 4 vectors of 4 floats
// (16 of one float on the scalar path): one pass up to 512 columns.
int items_config(int D, bool vec4, int* nv) {
  const int vecs = vec4 ? D / 4 : D;
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes <<= 1;
  const int cap = vec4 ? 4 : 16;
  *nv = 1;
  while (*nv < cap && lanes * *nv < vecs) *nv <<= 1;
  return lanes;
}

// K1 and, where rows split, the combine launch.
int run_items(int device, const float* x, const int* indices,
              const int* indptr, const int4* items, int n_rows, int n_packs,
              const int* split_rows, const int* split_ptr, int n_split, int D,
              float* out, float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 0 || n_packs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows + n_packs == 0 || D <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(partials);
  const bool vec4 = D % 4 == 0 && (ptrs & 15) == 0;
  int nv = 1;
  const int lanes = items_config(D, vec4, &nv);
#define PGL_ITEMS(V, L, N)                                                  \
  if (vec4 == (V == 4) && lanes == L && nv == N) {                          \
    err = launch_items<V, L, N>(device, x, indices, indptr, items, n_rows,  \
                                n_packs, D, out, partials, s);              \
  } else
  PGL_ITEMS(4, 1, 1) PGL_ITEMS(4, 2, 1) PGL_ITEMS(4, 4, 1) PGL_ITEMS(4, 8, 1)
  PGL_ITEMS(4, 16, 1) PGL_ITEMS(4, 32, 1) PGL_ITEMS(4, 32, 2)
  PGL_ITEMS(4, 32, 4)
  PGL_ITEMS(1, 1, 1) PGL_ITEMS(1, 2, 1) PGL_ITEMS(1, 4, 1) PGL_ITEMS(1, 8, 1)
  PGL_ITEMS(1, 16, 1) PGL_ITEMS(1, 32, 1) PGL_ITEMS(1, 32, 2)
  PGL_ITEMS(1, 32, 4) PGL_ITEMS(1, 32, 8) PGL_ITEMS(1, 32, 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PGL_ITEMS
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split > 0) {
    spmm_combine<<<n_split, kCombineWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, D, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: out [R, D] = the sorted-segment sum of x [N, D] over the layout's
// work list `items` (pack_rows): n_rows items of one row, then n_packs
// packs (indptr gives their row boundaries).
extern "C" int pgl_spmm_f32(int device, const float* x, const int* indices,
                            const int* indptr, const int* items, int n_rows,
                            int n_packs, const int* split_rows,
                            const int* split_ptr, int n_split, int D,
                            float* out, float* partials, void* stream) {
  return run_items(device, x, indices, indptr,
                   reinterpret_cast<const int4*>(items), n_rows, n_packs,
                   split_rows, split_ptr, n_split, D, out, partials, stream);
}

// K1w: out [R, D] = sum over the row's edges of x[indices[e]] (wop 1: times,
// wop 2: plus) w[eid[e], col / (D / H)], w [E, H] f32 in the caller's edge
// order (wop 0: unweighted, taken only with a dwop: K1 is pgl_spmm_f32).
// dwop 1 (with xrow [R, D]) or 2 also writes dw [E, H] at eid; `out` may
// then be null (no combine launch either), and with wop 0 w is not read.
extern "C" int pgl_spmm_weighted_f32(int device, int wop, int dwop,
                                     const float* x, const int* indices,
                                     const int* eid, const float* w, int H,
                                     const int* pieces, int n_pieces,
                                     const int* split_rows,
                                     const int* split_ptr, int n_split, int D,
                                     float* out, float* partials,
                                     const float* xrow, float* dw,
                                     void* stream) {
  if (H <= 0 || D % H != 0 || (wop == kNone && dwop == kNone))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,       indices, eid,  w,
               H,       D / H,   reinterpret_cast<const int4*>(pieces),
               n_pieces, D,      out,  partials,
               xrow,    dw};
  return run(device, wop, dwop, a, split_rows, split_ptr, n_split, stream);
}
