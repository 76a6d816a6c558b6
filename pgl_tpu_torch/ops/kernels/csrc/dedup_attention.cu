// Count-matrix ("dedup") graph attention for Hopper (sm_90a), in two score
// modes. C is the count matrix of the CSC dedup layout: C[r, u] is the
// number of edges into destination row r whose source is unique row u
// (node uv[u]). Per row r and head h, over the nonzero cells (r, u):
//   S       = leaky(a_dst[r, h] + a_src[uv[u], h])          (additive, GAT)
//   S       = leaky(q[r, h-slice] . k[uv[u], h-slice])  (dot, TransformerConv)
//   l       = sum_u C * exp(S - m)                   (m: max of S over them)
//   out[r]  = sum_u keep * C * exp(S - m) * v[uv[u]] / (1 - rate) / l
//   lse[r]  = m + log l                              (0 and 0 for no cells)
// and its flash backward, with delta = sum g * out per (row, head):
//   p       = C * exp(min(S - lse, 80))
//   ds      = p * (keep * (g . v) / (1 - rate) - delta) * leaky'(S)
//   additive: d a_dst[r] = sum_u ds;
//             node s: d a_src = sum ds,  dv = sum keep * p * g[r] / (1 - rate)
//   dot:      dq[r] = sum_u ds * k[uv[u]] per head (a vector, dsh wide);
//             node s: dk = sum ds * q[r],  dv = sum keep * p * g[r] /
//             (1 - rate)
// where a node's sums run over the cells whose unique row is node s.
//
// Replaces the TPU kernels of pgl_tpu/ops/pallas/dedup_attention.py in
// both modes: `_attn_fwd_kernel` (:102, K7) and `_attn_bwd_kernel` (:285,
// K8). There d a_src and dv (dk and dv) land in the pair's own slot rows
// [P * 128, .] (row p * 128 + c belongs to unique row wb_p + c of pair p),
// which `build_uniq_reduce`'s layout folds onto nodes; here both modes
// walk each node's cells in node order with the node's rows resident and
// write node rows, so there are no slot rows and no fold. The dot mode
// (`pgl_dedup_dot_fwd_f32`, `pgl_dedup_dot_bwd_f32`) runs the staged dot
// kernels of the per-edge attention in their cell form (dot_staged.cuh):
// K7 and K8's row pass are the forward and the dq pass over the cells in
// row order, and K8's dk and dv come from the dkv pass over the cells in
// node order. All three form a cell's score with `head_dot`, q first, so
// they see the same bits (attention_common.cuh).
//
// The reference has two forms of each kernel, one reading the cached bf16
// counts (K4's), one rebuilding C from the pair's edges. Here both are one
// kernel: it reads the multiplicities of the nonzero cells from work lists
// built once on the host (`dedup_attention.py`, `build_dedup_attention`),
// whether or not the layout carries counts, so the two give the same bits.
// An absent cell (C = 0: a window running into the next block's rows, or uv
// pad rows aliasing node 0) is in no list, so it never enters the max.
//
// What bounds it on this card: bytes and latency, not arithmetic. The byte
// bound counts the node tables, the cell lists and the outputs once: about
// 48 MB (K7) and 78 MB (K8) at the bench GAT graph's (H, dvh) = (8, 8),
// 0.014 and 0.023 ms at 3.35 TB/s; K8's node walk gathers a_dst, lse,
// delta and g of each cell's row (352 B a cell there, 76 B at (1, 16)),
// which sets a gather bound above it. In dot mode at UniMP's (H, dsh, dvh)
// = (2, 128, 128) each cell gathers 2 KB of rows (k|v; q|g in the node
// walk), so the gathers set a floor above the table bound (dot_staged.cuh's
// note gives that design). The dense TPU tile does
// 256 x 128 cells a pair though 1.6% of them are nonzero there; the
// additive design:
//   * work per nonzero cell, never per dense tile cell. A cell is visited
//     once with its multiplicity, so a multigraph costs per distinct
//     (dst, src) pair (552,791 cells for 1,048,576 edges on the bench GAT
//     graph), and the gather of a cell is of its unique row's node;
//   * K7 is the per-edge K9 in its cell form (`gat_fwd_groups<..., CELLS>`,
//     additive_groups.cuh): lane groups of 16-byte columns over the cells
//     in row order, a warp a piece of ET cells of a row past PACK_ROW
//     cells, a group each other nonempty row, no warp for a row without
//     cells; a cell's count multiplies p, its key `cell_key` keys the
//     dropout. K8's row pass walks the same cells, one warp per piece of
//     at most ET cells of one row (`segment_kernels.cut_rows`), lanes over
//     per-head "slots" as in the dot kernels (attention_common.cuh); a row
//     of several pieces (the bench graph's hub has 65k cells) writes
//     partials that a second launch merges (K7) or sums (K8) in piece
//     order;
//   * K8's d a_src and dv come from a walk of each node's cells (node
//     order: by node, then pair slot, then row, so a node's terms come in
//     the order the reference's slot rows and their fold sum them), one
//     warp per piece of at most ET cells of one node, the node's a_src and
//     v held in registers; a node of several pieces (a hub source) writes
//     partials that a second launch sums in piece order, a node without
//     cells writes zeros. A warp walks 65,536 nodes of 8.4 cells on the
//     bench GAT graph where the slot pass it replaces walked 135,424 slots
//     (24,960 empty) and wrote 39 MB of slot rows for two K1 folds. The
//     cells' gathered rows are small (352 B a cell at (8, 8)), so they are
//     loaded straight into registers, U cells in flight, not staged;
//   * no float atomics: every run gives the same bits.
// Staging each window's 128 source rows in shared memory (the TPU kernel's
// gather saving) is left to a later optimisation: the row order visits
// cells by row, not by window.
//
// Dropout is the reference's cell key `_cell_idx` = dst * 0x9E3779B1 +
// unique row (uint32 wrap-around, the reference's int32), hashed by
// `drop_keep` with the seed and the head: a cell's duplicate edges drop
// together. K8's additive row pass forms it from the row and the unique
// row; K7 and the dot mode read it from the work lists' per-cell key
// arrays. The softmax sum stays undropped.
//
// On bf16 tables (the `_bf16` entry points, the library
// dedup_attention_bf16: this source built with -DPGL_BF16; the reference's
// kernels take bf16 too, their out and dv in v's dtype, d a_dst and d
// a_src in the scores', `:579`, `:713`, `:724`) every kernel above runs on
// T = bf16: a table element is widened to f32 as it is loaded (the
// additive lane groups by 16-byte vectors of 8 bf16; the dot K7's rows by
// plain loads into its f32 ring, `stage_row`; the dot K8's row pass and
// node walk copy bf16 rows into a bf16 ring by cp.async, `stage_ring`, and
// widen them as they read them), the scores, exps
// and sums are f32 as on float, lse, delta and the partials stay f32, and
// out, d a_dst, d a_src (dq, dk) and dv are each rounded once to bf16
// when stored. The dropout keys are the cells', so the masks are float's.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes outputs and partials), and returns
// cudaGetLastError(). `thresh` < 0 turns dropout off.

#include "additive_groups.cuh"
#include "attention_common.cuh"
#include "dot_staged.cuh"

namespace {

constexpr uint32_t kCellMul = 0x9E3779B1u;  // `_cell_idx`'s row multiplier

// K8's row pass, one warp per piece of the row-ordered cells:
// d a_dst[r, h] = sum_u ds. T: the tables' element type (float or bf16,
// widened to f32 as loaded; d a_dst rounded once when stored).
template <typename T, int NC, int U>
__global__ void __launch_bounds__(kWarps * 32)
dedup_attn_bwd_rows(const T* __restrict__ a_dst, const T* __restrict__ a_src,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ cell_src,
                    const int* __restrict__ cell_urow,
                    const int* __restrict__ cell_cnt,
                    const int4* __restrict__ pieces, int n_pieces, int H,
                    int dvh, int dvh_p, float slope,
                    const int* __restrict__ seed_p, int thresh,
                    float inv_keep, T* __restrict__ da_dst,
                    float* __restrict__ partials) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;
  const int lane = threadIdx.x & 31;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const Slots<NC> sl(lane, H, dvh, dvh_p);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  const uint32_t row_key = static_cast<uint32_t>(pc.x) * kCellMul;

  float ad[NC], ls[NC], dl[NC], gr[NC], da[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const size_t rh = static_cast<size_t>(pc.x) * H + sl.head[k];
    ad[k] = ld_f(a_dst + rh);
    ls[k] = __ldg(lse + rh);
    dl[k] = __ldg(delta + rh);
    gr[k] = sl.col[k] >= 0
                ? ld_f(g + static_cast<size_t>(pc.x) * C + sl.col[k])
                : 0.f;
    da[k] = 0.f;
  }
  const bool has = lane < pc.z - pc.y;
  int ms = has ? __ldg(cell_src + pc.y + lane) : 0;
  int mu = has ? __ldg(cell_urow + pc.y + lane) : 0;
  int mc = has ? __ldg(cell_cnt + pc.y + lane) : 0;
  for (int base = pc.y; base < pc.z; base += 32) {
    const int n = min(32, pc.z - base);
    const int nx = base + 32 + lane;
    const bool nhas = nx < pc.z;
    const int ns = nhas ? __ldg(cell_src + nx) : 0;
    const int nu = nhas ? __ldg(cell_urow + nx) : 0;
    const int nc = nhas ? __ldg(cell_cnt + nx) : 0;
    for (int j0 = 0; j0 < n; j0 += U) {
      float as[U][NC], vv[U][NC], cnt[U];
      uint32_t key[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int s = __shfl_sync(kFull, ms, j & 31);
        cnt[u] = static_cast<float>(__shfl_sync(kFull, mc, j & 31));
        key[u] = row_key + static_cast<uint32_t>(__shfl_sync(kFull, mu, j & 31));
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          as[u][k] = j < n ? ld_f(a_src + static_cast<size_t>(s) * H +
                                  sl.head[k])
                           : 0.f;
          vv[u][k] = (j < n && sl.col[k] >= 0)
                         ? ld_f(v + static_cast<size_t>(s) * C + sl.col[k])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= n) break;  // uniform
        float gv[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) gv[k] = gr[k] * vv[u][k];
        head_sum<NC>(gv, dvh_p);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float sr = ad[k] + as[u][k];
          const float p =
              cnt[u] * expf(fminf(leaky(sr, slope) - ls[k], 80.f));
          const float q =
              drop ? (drop_keep(key[u], seed, sl.hc[k], thresh) ? p * inv_keep
                                                                : 0.f)
                   : p;
          da[k] += (q * gv[k] - p * dl[k]) * leaky_grad(sr, slope);
        }
      }
    }
    ms = ns;
    mu = nu;
    mc = nc;
  }
  // a whole row stores d a_dst as T, a piece its f32 partial row: one
  // pointer on float
  if constexpr (std::is_same_v<T, float>) {
    float* dst = pc.w < 0 ? da_dst + static_cast<size_t>(pc.x) * H
                          : partials + static_cast<size_t>(pc.w) * H;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (sl.lead[k]) dst[sl.head[k]] = da[k];
  } else if (pc.w < 0) {
    T* dst = da_dst + static_cast<size_t>(pc.x) * H;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (sl.lead[k]) dst[sl.head[k]] = from_f<T>(da[k]);
  } else {
    float* dst = partials + static_cast<size_t>(pc.w) * H;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (sl.lead[k]) dst[sl.head[k]] = da[k];
  }
}

// Cells in flight a lane group in K8's node walk: fewer than the row pass
// takes ran faster where measured (experiments/torch_spmm/k1w_k8_variants.py,
// H100): one at two slots a lane ((H, dvh) = (8, 8): K8 0.291 ms against
// 0.310 at two and 0.366 at four, which held 80 registers and spilled 12
// B), two where a half warp walks cells ((1, 16): 0.175 against 0.187 at
// four); else as the row pass.
template <int NC, int G>
struct NodeUnroll {
  static constexpr int value = NC == 2 ? 1 : G == 2 ? 2 : unroll_for(NC);
};

// K8's node walk, one warp per piece (node, begin, end, slot) of the cells
// in node order: the cells (dst, count, key) whose unique row is node s's,
// by (slot, dst), with a_src[s] and v[s] held in registers; per cell it
// gathers a_dst, lse, delta and g of the cell's row. Writes d a_src[s, h] =
// sum ds and dv[s, :] = sum q * g[dst, :] (zeros for a node without
// cells), or for a piece of a split node its partial row d a_src | dv.
// Where one head group's H * dvh_p slots fit in half a warp (G = 2: at
// (H, dvh) = (1, 16) the other half would idle), the two halves take
// alternate cells and are summed by one shuffle at the end. T as the row
// pass's.
template <typename T, int NC, int U, int G>
__global__ void __launch_bounds__(kWarps * 32)
dedup_attn_bwd_nodes(const T* __restrict__ a_dst, const T* __restrict__ a_src,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ node_dst,
                     const int* __restrict__ node_cnt,
                     const int* __restrict__ node_key,
                     const int4* __restrict__ pieces, int n_pieces, int H,
                     int dvh, int dvh_p, float slope,
                     const int* __restrict__ seed_p, int thresh,
                     float inv_keep, T* __restrict__ dsrc,
                     T* __restrict__ dv, float* __restrict__ partials) {
  static_assert(G == 1 || NC == 1, "lane groups hold one slot a lane");
  constexpr int GW = 32 / G;  // lanes of a group
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / GW;
  const int C = H * dvh;
  const int4 pc = pieces[warp];
  const Slots<NC> sl(lane % GW, H, dvh, dvh_p);
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;

  float as[NC], vs[NC], da[NC], dva[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    as[k] = ld_f(a_src + static_cast<size_t>(pc.x) * H + sl.head[k]);
    vs[k] = sl.col[k] >= 0
                ? ld_f(v + static_cast<size_t>(pc.x) * C + sl.col[k])
                : 0.f;
    da[k] = 0.f;
    dva[k] = 0.f;
  }
  // each lane holds one cell (row, count, key) of the 32-cell batch
  const bool has = lane < pc.z - pc.y;
  int md = has ? __ldg(node_dst + pc.y + lane) : 0;
  int mc = has ? __ldg(node_cnt + pc.y + lane) : 0;
  int mk = has ? __ldg(node_key + pc.y + lane) : 0;
  for (int base = pc.y; base < pc.z; base += 32) {
    const int n = min(32, pc.z - base);
    const int nx = base + 32 + lane;
    const bool nhas = nx < pc.z;
    const int nd = nhas ? __ldg(node_dst + nx) : 0;
    const int nc = nhas ? __ldg(node_cnt + nx) : 0;
    const int nk = nhas ? __ldg(node_key + nx) : 0;
    for (int j0 = 0; j0 < n; j0 += U * G) {
      float ad[U][NC], ls[U][NC], dl[U][NC], gd[U][NC], cnt[U];
      uint32_t key[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * G + grp;
        const bool live = j < n;
        const int d = __shfl_sync(kFull, md, j & 31);
        const int c = __shfl_sync(kFull, mc, j & 31);
        // a cell past the batch counts 0: its p, q and terms are 0
        cnt[u] = live ? static_cast<float>(c) : 0.f;
        key[u] = static_cast<uint32_t>(__shfl_sync(kFull, mk, j & 31));
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const size_t dh = static_cast<size_t>(d) * H + sl.head[k];
          ad[u][k] = live ? ld_f(a_dst + dh) : 0.f;
          ls[u][k] = live ? __ldg(lse + dh) : 0.f;
          dl[u][k] = live ? __ldg(delta + dh) : 0.f;
          gd[u][k] = (live && sl.col[k] >= 0)
                         ? ld_f(g + static_cast<size_t>(d) * C + sl.col[k])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float gv[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) gv[k] = gd[u][k] * vs[k];
        head_sum<NC>(gv, dvh_p);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float sr = ad[u][k] + as[k];
          const float p =
              cnt[u] * expf(fminf(leaky(sr, slope) - ls[u][k], 80.f));
          const float q =
              drop ? (drop_keep(key[u], seed, sl.hc[k], thresh) ? p * inv_keep
                                                                : 0.f)
                   : p;
          da[k] += (q * gv[k] - p * dl[u][k]) * leaky_grad(sr, slope);
          dva[k] += q * gd[u][k];
        }
      }
    }
    md = nd;
    mc = nc;
    mk = nk;
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int off = GW; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        da[k] += __shfl_xor_sync(kFull, da[k], off);
        dva[k] += __shfl_xor_sync(kFull, dva[k], off);
      }
    if (grp != 0) return;
  }
  // partial row: d a_src [H] | dv [C] (summed by sum_combine); a whole
  // node stores as T, as the row pass
  float* part = partials + static_cast<size_t>(max(pc.w, 0)) * (H + C);
  if constexpr (std::is_same_v<T, float>) {
    float* ds_row = pc.w < 0 ? dsrc + static_cast<size_t>(pc.x) * H : part;
    float* dv_row = pc.w < 0 ? dv + static_cast<size_t>(pc.x) * C : part + H;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sl.lead[k]) ds_row[sl.head[k]] = da[k];
      if (sl.col[k] >= 0) dv_row[sl.col[k]] = dva[k];
    }
  } else if (pc.w < 0) {
    T* ds_row = dsrc + static_cast<size_t>(pc.x) * H;
    T* dv_row = dv + static_cast<size_t>(pc.x) * C;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sl.lead[k]) ds_row[sl.head[k]] = from_f<T>(da[k]);
      if (sl.col[k] >= 0) dv_row[sl.col[k]] = from_f<T>(dva[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sl.lead[k]) part[sl.head[k]] = da[k];
      if (sl.col[k] >= 0) part[H + sl.col[k]] = dva[k];
    }
  }
}

// K8 additive: the row pass and the node walk, then the sums of split rows
// and split nodes.
template <typename T>
int attn_bwd_run(const T* a_dst, const T* a_src, const T* v, const T* g,
                 const float* lse, const float* delta, const int* cell_src,
                 const int* cell_urow, const int* cell_cnt,
                 const int* pieces, int n_pieces, const int* split_rows,
                 const int* split_ptr, int n_split, const int* node_dst,
                 const int* node_cnt, const int* node_key,
                 const int* node_pieces, int n_node_pieces,
                 const int* node_split_rows, const int* node_split_ptr,
                 int n_node_split, int H, int dvh, float slope,
                 const int* seed, int thresh, float inv_keep, T* da_dst,
                 T* dsrc, T* dv, float* partials, float* node_partials,
                 cudaStream_t s) {
  const int dvh_p = pow2_at_least(dvh);
  const int nc = slots_per_lane(H, dvh_p);
  if (nc == 0 || H <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  const auto* npc = reinterpret_cast<const int4*>(node_pieces);
  // lane groups a warp in the node walk: two where a head group fits in 16
  const bool halves = H * dvh_p <= 16;
  PGL_NC_SWITCH(nc, {
    if (n_pieces > 0)
      dedup_attn_bwd_rows<T, NC, unroll_for(NC)><<<blocks_for(n_pieces),
                                                   kWarps * 32, 0, s>>>(
          a_dst, a_src, v, g, lse, delta, cell_src, cell_urow, cell_cnt, pc,
          n_pieces, H, dvh, dvh_p, slope, seed, thresh, inv_keep, da_dst,
          partials);
    if (n_node_pieces > 0) {
      if constexpr (NC == 1) {
        if (halves) {
          dedup_attn_bwd_nodes<T, NC, NodeUnroll<NC, 2>::value, 2>
              <<<blocks_for(n_node_pieces), kWarps * 32, 0, s>>>(
                  a_dst, a_src, v, g, lse, delta, node_dst, node_cnt,
                  node_key, npc, n_node_pieces, H, dvh, dvh_p, slope, seed,
                  thresh, inv_keep, dsrc, dv, node_partials);
        }
      }
      if (!(NC == 1 && halves))
        dedup_attn_bwd_nodes<T, NC, NodeUnroll<NC, 1>::value, 1>
            <<<blocks_for(n_node_pieces), kWarps * 32, 0, s>>>(
                a_dst, a_src, v, g, lse, delta, node_dst, node_cnt, node_key,
                npc, n_node_pieces, H, dvh, dvh_p, slope, seed, thresh,
                inv_keep, dsrc, dv, node_partials);
    }
  })
  if (n_pieces > 0 && n_split > 0)
    sum_combine<T><<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, 0, da_dst, nullptr);
  if (n_node_pieces > 0 && n_node_split > 0)
    sum_combine<T><<<n_node_split, kSumWarps * 32, 0, s>>>(
        node_partials, node_split_rows, node_split_ptr, H, H * dvh, dsrc,
        dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point sets the device and launches its pass's kernels on
// `stream`: the _f32 ones on float tables, the _bf16 ones on bf16 tables
// (passed as raw 16-bit words; lse, delta and partials f32 either way).
#define PGL_ON_DEVICE(device)                               \
  do {                                                      \
    const cudaError_t err_ = cudaSetDevice(device);         \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

// K7: out [N, H * dvh] and lse [N, H] over the cells in row order (node,
// count, key) and their work list (`dedup_attention.build_dedup_attention`:
// `attention_kernels.k10_work_list` over the rows' cells); partials
// [n_partials, C + 2H] of the split rows merged by a second launch.
#define PGL_DEDUP_ATTN_FWD(NAME, T, P)                                       \
  extern "C" int NAME(int device, const P* a_dst, const P* a_src,           \
                      const P* v, const int* cell_src, const int* cell_cnt, \
                      const int* cell_key, const int* items, int n_long,     \
                      int n_short, const int* empty, int n_empty,            \
                      const int* split_rows, const int* split_ptr,           \
                      int n_split, int H, int dvh, int vec, int lh,          \
                      int group, int nv, float slope, const int* seed,       \
                      int thresh, float inv_keep, P* out, float* lse,        \
                      float* partials, void* stream) {                       \
    PGL_ON_DEVICE(device);                                                   \
    return fwd_groups_run<true>(                                             \
        static_cast<const T*>(a_dst), static_cast<const T*>(a_src),          \
        static_cast<const T*>(v), cell_src, cell_cnt, cell_key, items,       \
        n_long, n_short, empty, n_empty, split_rows, split_ptr, n_split, H,  \
        dvh, vec, lh, group, nv, slope, seed, thresh, inv_keep,              \
        static_cast<T*>(out), lse, partials,                                 \
        static_cast<cudaStream_t>(stream));                                  \
  }

// K8: d a_dst [N, H] (row pass over the cells in row order; partials
// [n_partials, H] summed by a second launch), then d a_src [N, H] and dv
// [N, H * dvh] (node walk over the cells in node order: row, count, key;
// node_partials [n_node_partials, H + H * dvh] summed by a second launch).
#define PGL_DEDUP_ATTN_BWD(NAME, T, P)                                       \
  extern "C" int NAME(                                                       \
      int device, const P* a_dst, const P* a_src, const P* v, const P* g,    \
      const float* lse, const float* delta, const int* cell_src,             \
      const int* cell_urow, const int* cell_cnt, const int* pieces,          \
      int n_pieces, const int* split_rows, const int* split_ptr,             \
      int n_split, const int* node_dst, const int* node_cnt,                 \
      const int* node_key, const int* node_pieces, int n_node_pieces,        \
      const int* node_split_rows, const int* node_split_ptr,                 \
      int n_node_split, int H, int dvh, float slope, const int* seed,        \
      int thresh, float inv_keep, P* da_dst, P* dsrc, P* dv,                 \
      float* partials, float* node_partials, void* stream) {                 \
    PGL_ON_DEVICE(device);                                                   \
    return attn_bwd_run(                                                     \
        static_cast<const T*>(a_dst), static_cast<const T*>(a_src),          \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        cell_src, cell_urow, cell_cnt, pieces, n_pieces, split_rows,         \
        split_ptr, n_split, node_dst, node_cnt, node_key, node_pieces,       \
        n_node_pieces, node_split_rows, node_split_ptr, n_node_split, H,     \
        dvh, slope, seed, thresh, inv_keep, static_cast<T*>(da_dst),         \
        static_cast<T*>(dsrc), static_cast<T*>(dv), partials, node_partials, \
        static_cast<cudaStream_t>(stream));                                  \
  }

// Dot-mode K7: out [N, H * dvh] and lse [N, H] from q, k [N, H * dsh] and v
// [N, H * dvh]; the cells in row order (node, count, key); partials
// [n_partials, H * dvh + 2H].
#define PGL_DEDUP_DOT_FWD(NAME, T, P)                                        \
  extern "C" int NAME(int device, const P* q, const P* k, const P* v,       \
                      const int* cell_src, const int* cell_cnt,              \
                      const int* cell_key, const int* pieces, int n_pieces,  \
                      const int* split_rows, const int* split_ptr,           \
                      int n_split, int H, int dsh, int dvh, float slope,     \
                      const int* seed, int thresh, float inv_keep, P* out,   \
                      float* lse, float* partials, void* stream) {           \
    PGL_ON_DEVICE(device);                                                   \
    return dot_fwd_run<true>(                                                \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), cell_src, cell_cnt, cell_key, pieces,      \
        n_pieces, split_rows, split_ptr, n_split, H, dsh, dvh, slope, seed,  \
        thresh, inv_keep, static_cast<T*>(out), lse, partials,               \
        static_cast<cudaStream_t>(stream));                                  \
  }

// Dot-mode K8: dq [N, H * dsh] (row pass over the cells in row order;
// partials [n_partials, H * dsh] summed by a second launch), then dk
// [N, H * dsh] and dv [N, H * dvh] (node walk over the cells in node order:
// destination, count, key; node_partials [n_node_partials, H * (dsh + dvh)]
// summed by a second launch).
#define PGL_DEDUP_DOT_BWD(NAME, T, P)                                        \
  extern "C" int NAME(                                                       \
      int device, const P* q, const P* k, const P* v, const P* g,            \
      const float* lse, const float* delta, const int* cell_src,             \
      const int* cell_cnt, const int* cell_key, const int* pieces,           \
      int n_pieces, const int* split_rows, const int* split_ptr,             \
      int n_split, const int* node_dst, const int* node_cnt,                 \
      const int* node_key, const int* node_pieces, int n_node_pieces,        \
      const int* node_split_rows, const int* node_split_ptr,                 \
      int n_node_split, int H, int dsh, int dvh, float slope,                \
      const int* seed, int thresh, float inv_keep, P* dq, P* dk, P* dv,      \
      float* partials, float* node_partials, void* stream) {                 \
    PGL_ON_DEVICE(device);                                                   \
    const auto s = static_cast<cudaStream_t>(stream);                        \
    const int rc = dot_dq_run<true>(                                         \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        cell_src, cell_cnt, cell_key, pieces, n_pieces, split_rows,          \
        split_ptr, n_split, H, dsh, dvh, slope, seed, thresh, inv_keep,      \
        static_cast<T*>(dq), partials, s);                                   \
    if (rc != 0) return rc;                                                  \
    return dot_dkv_run<true>(                                                \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,      \
        node_dst, nullptr, node_cnt, node_key, node_pieces, n_node_pieces,   \
        node_split_rows, node_split_ptr, n_node_split, H, dsh, dvh, slope,   \
        seed, thresh, inv_keep, static_cast<T*>(dk), static_cast<T*>(dv),    \
        node_partials, s);                                                   \
  }

// The float32 entry points, or (built with -DPGL_BF16, the library
// dedup_attention_bf16) the bf16 ones: each half instantiates only its
// element type, so the two build in parallel.
#ifndef PGL_BF16
PGL_DEDUP_ATTN_FWD(pgl_dedup_attn_fwd_f32, float, float)
PGL_DEDUP_ATTN_BWD(pgl_dedup_attn_bwd_f32, float, float)
PGL_DEDUP_DOT_FWD(pgl_dedup_dot_fwd_f32, float, float)
PGL_DEDUP_DOT_BWD(pgl_dedup_dot_bwd_f32, float, float)
#else
PGL_DEDUP_ATTN_FWD(pgl_dedup_attn_fwd_bf16, __nv_bfloat16, void)
PGL_DEDUP_ATTN_BWD(pgl_dedup_attn_bwd_bf16, __nv_bfloat16, void)
PGL_DEDUP_DOT_FWD(pgl_dedup_dot_fwd_bf16, __nv_bfloat16, void)
PGL_DEDUP_DOT_BWD(pgl_dedup_dot_bwd_bf16, __nv_bfloat16, void)
#endif  // PGL_BF16
