// The dot-mode attention passes with staged gathers, in two forms of one
// code: per edge (K9, K10-dq and K10-dkv of attention_kernels.cu, over the
// CSC and CSR work lists) and per count-matrix cell (K7 and K8 of
// dedup_attention.cu, `CELLS`). `_build.py` hashes this header into both
// libraries' names.
//
// Each of the three walks a piece's items in order and gathers, per item,
// rows of the other end: the forward (K9, K7) and the dq pass (K10-dq,
// K8's row pass) over pieces of a destination row, an item's k row | v
// row; the dkv pass (K10-dkv over CSR pieces, K8's node walk) over pieces
// of a source node, an item's q row | g row | lse | delta. That gather is
// their bound: at UniMP's width (2 heads of 128) 2 KB an item, so the
// least time is the gathered bytes over the card's memory rate (the
// "gather bound" of chip_smoke.py), far above the few exps a head an item.
// (At GATConv's many-head shapes, 43 heads of a few columns, the rows are
// short and the head reductions' shuffles set the pace instead, measured
// by experiments/torch_spmm/dot_dq_breakdown.py.) The design of all three:
//   * the gathered rows are staged through the warp's shared-memory ring
//     (S = `RingSteps`, attention_common.cuh) by cp.async, S - 1 steps of
//     StageEdges<NC> items ahead of the step being computed, so two items'
//     rows are in flight a warp at UniMP's shape while the registers hold
//     only the resident rows and the sums, and the copies are 16 bytes a
//     lane where the rows allow;
//   * the softmax work is a head's, not a slot's: where a head is wider
//     than a warp it holds kph = wp / 32 consecutive slots of each lane,
//     and its score, running max and sum, exps, keep bit and ds are
//     computed at the first of them and reused for the others;
//   * the score is `head_dot(q, k)` on DotSlots' slot map (`dot_col`), q
//     first, in all three, and a piece's items are computed in their order,
//     so the backward's p = exp(s - lse) sees the forward's scores bit for
//     bit and the online softmax runs in the order it did before staging.
//     FULL (every slot a real column, as at UniMP's shape) drops the
//     masks, not the order;
//   * WIDE (wp > 32) is a template argument, so the head sums compile the
//     one branch of their width (`HeadWidth`) and, where heads are no
//     wider than a warp, kph = 1 at compile time: the per-slot code is
//     straight-line and the compiler interleaves the slots' exp chains (a
//     branch a slot serialised them).
// The forward and the dq pass add, for the heads no wider than a warp,
// where each slot is its own head and keeps its own state:
//   * for a kernel that is not FULL, each slot's place of its staged score
//     and value column (`kv_slot`, one register, computed once a piece; a
//     masked slot reads a zero pad), so a read is one shared load, as
//     FULL's are.
//
// CELLS, the count-matrix form (K7 and K8 in dot mode, which replace
// `_attn_fwd_kernel` and `_attn_bwd_kernel` of
// pgl_tpu/ops/pallas/dedup_attention.py:102,285 in dot mode): an item is a
// nonzero cell of the count matrix, whose gathered node is that of its
// unique row (the forward and the dq pass) or its destination (the node
// walk); it carries its multiplicity C, which multiplies p where the
// additive kernels put it (C * exp(s - m) in the forward, C * exp(min(s -
// lse, 80)) in the backward), and its dropout key, the reference's
// `_cell_idx` (read from a per-cell int32 array, where an edge's key is
// its CSC position). Lanes 0 and 1 copy a cell's (C, key) by cp.async into
// a pair of ints after the warp's ring, in the step's commit group, so no
// register holds them in flight. The per-edge instantiations compile as
// they did before the form existed (`CELLS` false removes every branch).
//
// T, the tables' element type: float or bf16, per edge and per cell alike.
// The two backward passes (K10-dq, K10-dkv, K8's row pass and node walk)
// stage into a ring of T itself (R = T): on bf16 the rows are copied as
// bf16 bytes by cp.async (`stage_ring`: 16- or 4-byte copies by the rows'
// alignment, plain loads only for rows on a 2-byte boundary), S - 1 steps
// ahead as on float, and widened exactly as the compute reads them
// (`ring_f`), so the slot map, every product and sum and their order are
// float's; the bf16 ring is RingSteps<bf16> deep. The forward (K9, K7)
// keeps an f32 ring, a bf16 row widened as it is staged (`stage_row`, by
// plain loads rather than cp.async). Every sum is f32; lse and delta are
// f32 tensors (staged as f32 in the dkv ring), the partials f32, and out,
// dq, dk and dv are rounded once to T when stored.

#pragma once

#include "attention_common.cuh"

namespace {

// The ring of the forward and the dq pass, in elements of R: an item's k
// row, a pad of at least one element that stays 0 (cleared once; masked
// slots read it), then its v row, each part a multiple of 16 bytes.
template <typename R>
__host__ __device__ __forceinline__ int kv_k_elems(int DS) {
  return up16<R>(DS + 1);
}

template <typename R>
__host__ __device__ __forceinline__ int kv_edge_elems(int DS, int C) {
  return kv_k_elems<R>(DS) + up16<R>(C);
}

template <typename R, int NC>
__host__ __device__ __forceinline__ int kv_ring_elems(int DS, int C) {
  return RingSteps<R>::value * StageEdges<NC>::value *
         kv_edge_elems<R>(DS, C);
}

// CELLS: the floats after a warp's ring of R (and the dq pass's lse |
// delta) that hold the (count, key) int pairs of the ring's cells; none
// per edge
template <typename R, int NC, bool CELLS>
__host__ __device__ __forceinline__ int cell_pair_floats() {
  return CELLS ? up4(2 * RingSteps<R>::value * StageEdges<NC>::value) : 0;
}

// elements of R in a float: the f32 and int parts of a ring of R are
// counted in elements of R, so a ring of float keeps its float offsets
template <typename R>
constexpr int kPerFloat = static_cast<int>(sizeof(float) / sizeof(R));

// CELLS: lanes 0 and 1 copy cell i's count and key to pair[0] and pair[1]
template <bool CELLS>
__device__ __forceinline__ void stage_cell(int* pair,
                                           const int* __restrict__ cnt,
                                           const int* __restrict__ keys,
                                           int i, int lane) {
  if (CELLS && lane < 2) cp_async4(pair + lane, (lane ? keys : cnt) + i);
}

// blocks an SM: StageBlocks', but one where a lane's 8 slots are 8 heads
// with masked columns (neither FULL nor WIDE), whose per-slot state would
// spill in 128 registers
template <int NC, bool FULL, bool WIDE>
struct KvBlocks {
  static constexpr int value =
      NC == 8 && !FULL && !WIDE ? 1 : StageBlocks<NC>::value;
};

// Where a slot reads its staged score and value column in an item's ring
// part, held for the NC slots of a kernel that is not FULL (computed once
// a piece): the score offset in bits 0-15, the value offset in bits 16-31,
// a masked slot's pointing at the zero pad, so each read is one shared
// load. FULL: j and the v row's offset + j, no word.
template <bool FULL>
__device__ __forceinline__ uint32_t kv_slot(int j, int lwp, int H, int dsh,
                                            int dvh, int DS, int o_v) {
  if (FULL) return 0u;
  const int sc = dot_col<false>(j, lwp, H, dsh);
  const int vc = dot_col<false>(j, lwp, H, dvh);
  return static_cast<uint32_t>(sc >= 0 ? sc : DS) |
         static_cast<uint32_t>(vc >= 0 ? o_v + vc : DS) << 16;
}

template <bool FULL>
__device__ __forceinline__ int kv_s(uint32_t w, int j) {
  return FULL ? j : static_cast<int>(w & 0xFFFFu);
}

template <bool FULL>
__device__ __forceinline__ int kv_v(uint32_t w, int j, int o_v) {
  return FULL ? o_v + j : static_cast<int>(w >> 16);
}

// The forward, one warp per piece (row, begin, end, slot) of a
// destination row: K9 (per edge; replaces `_attn_kernel` in dot mode,
// pgl_tpu/ops/pallas/attention_kernels.py:86) and K7 (CELLS). q's row is
// resident in registers; each item's k and v source rows are staged. Per
// head: the leaky score, the online (max, sum) with its two exps, and the
// keep bit; per slot: acc = acc * rescale + kept p * v.
template <typename T, int NC, bool FULL, bool WIDE, bool CELLS>
__global__ void __launch_bounds__(kWarps * 32, KvBlocks<NC, FULL, WIDE>::value)
dot_fwd_staged(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ indices,
               const int* __restrict__ cnt, const int* __restrict__ keys,
               const int4* __restrict__ pieces, int n_pieces, int H, int dsh,
               int dvh, int wp, bool vec1, bool vec2, float slope,
               const int* __restrict__ seed_p, int thresh, float inv_keep,
               T* __restrict__ out, float* __restrict__ lse,
               float* __restrict__ partials) {
  constexpr int P = StageEdges<NC>::value;
  constexpr int S = kStageSteps;
  extern __shared__ float4 kv_smem[];
  const int wb = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarps + wb;
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int DS = H * dsh;
  const int C = H * dvh;
  const int ES = kv_edge_elems<float>(DS, C);
  const int o_v = kv_k_elems<float>(DS);
  float* ring =
      reinterpret_cast<float*>(kv_smem) +
      static_cast<size_t>(wb) * (kv_ring_elems<float, NC>(DS, C) +
                                 cell_pair_floats<float, NC, CELLS>());
  int* pairs = reinterpret_cast<int*>(ring + kv_ring_elems<float, NC>(DS, C));
  const int4 pc = pieces[warp];
  const int n = pc.z - pc.y;
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  const int lwp = __ffs(wp) - 1;
  const int kph = WIDE ? wp >> 5 : 1;  // slots of one head in a lane
  uint32_t sw[NC];
  // m and l are a head's, kept at the first of its slots in the lane
  float qr[NC], m[NC], l[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c;
    const int sc = dot_col<FULL>(j, lwp, H, dsh);
    sw[c] = kv_slot<FULL>(j, lwp, H, dsh, dvh, DS, o_v);
    qr[c] = sc >= 0 ? ld_f(q + static_cast<size_t>(pc.x) * DS + sc) : 0.f;
    m[c] = kMaskValue;
    l[c] = 0.f;
    acc[c] = 0.f;
  }
  if (lane < S * P) ring[lane * ES + DS] = 0.f;  // the pads

  PieceList src(indices, pc.y, n, lane);
  const int steps = (n + P - 1) / P;
  // iteration t stages step t + S - 1 into ring slot `in` (one commit
  // group a step, empty past the piece), then computes step t from `at`
  int in = 0, at = 0;
  for (int t = 1 - S; t < steps; ++t) {
    const int ts = t + S - 1;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const int j = ts * P + e;
      if (j < n) {  // uniform
        const size_t s = static_cast<size_t>(src.at(j));
        float* st = ring + (in * P + e) * ES;
        stage_row(st, k + s * DS, DS, vec1, lane);
        stage_row(st + o_v, v + s * C, C, vec2, lane);
        stage_cell<CELLS>(pairs + 2 * (in * P + e), cnt, keys, pc.y + j,
                          lane);
      }
    }
    cp_async_commit();
    in = in + 1 == S ? 0 : in + 1;
    if (t < 0) continue;  // uniform
    cp_async_wait<S - 1>();  // this lane's copies of step t have landed
    __syncwarp();            // and every lane's (and the pads)
    const float* st0 = ring + at * P * ES;
    float sd[P][NC];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const float* st = st0 + e * ES;
      float kd[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kd[c] = st[kv_s<FULL>(sw[c], lane + 32 * c)];
      head_dot<NC, WIDE ? kWide : kNarrow>(qr, kd, wp, sd[e]);
    }
#pragma unroll
    for (int e = 0; e < P; ++e) {
      if (t * P + e >= n) break;  // uniform
      const float* st = st0 + e * ES;
      const int* pr = pairs + 2 * (at * P + e);
      const uint32_t pos = CELLS ? static_cast<uint32_t>(pr[1])
                                 : static_cast<uint32_t>(pc.y + t * P + e);
      const float mult = CELLS ? static_cast<float>(pr[0]) : 1.f;
      float sc = 0.f, pk = 0.f;  // the head's rescale and kept p
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c;
        if ((c & (kph - 1)) == 0) {  // uniform
          const float s = leaky(sd[e][c], slope);
          const float mn = fmaxf(m[c], s);
          sc = expf(m[c] - mn);
          const float p = CELLS ? mult * expf(s - mn) : expf(s - mn);
          l[c] = l[c] * sc + p;
          const uint32_t hc =
              static_cast<uint32_t>(dot_head<FULL>(j, lwp, H)) * 0x632BE5ABu;
          pk = (!drop || drop_keep(pos, seed, hc, thresh)) ? p : 0.f;
          m[c] = mn;
        }
        acc[c] = acc[c] * sc + pk * st[kv_v<FULL>(sw[c], j, o_v)];
      }
    }
    at = at + 1 == S ? 0 : at + 1;
    __syncwarp();  // every lane is done with this ring slot before it refills
  }
  cp_async_wait<0>();

  float mh = 0.f, lh = 0.f;  // the head's
  float* part = partials + static_cast<size_t>(pc.w < 0 ? 0 : pc.w) *
                               (C + 2 * H);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c;
    if ((c & (kph - 1)) == 0) {
      mh = m[c];
      lh = l[c];
    }
    const int vc = dot_col<FULL>(j, lwp, H, dvh);
    const int h = j >> lwp;
    const bool lead = h < H && (j & (wp - 1)) == 0;  // writes the head's
    if (pc.w < 0) {
      const bool row = lh > 0.f;  // an empty row stores zeros
      if (vc >= 0)
        out[static_cast<size_t>(pc.x) * C + vc] =
            from_f<T>(row ? acc[c] * (inv_keep / fmaxf(lh, 1e-30f)) : 0.f);
      if (lead)
        lse[static_cast<size_t>(pc.x) * H + h] = row ? mh + logf(lh) : 0.f;
    } else {
      // partial row: acc [C] | m [H] | l [H] (the additive mode's, so
      // gat_fwd_combine merges it)
      if (vc >= 0) part[vc] = acc[c];
      if (lead) {
        part[C + h] = mh;
        part[C + H + h] = lh;
      }
    }
  }
}

// The dq pass, one warp per piece of a destination row: dq[r, h-slice] =
// sum ds * k[src, h-slice] over the row's items; K10-dq (per edge;
// replaces `_attn_bwd_dq_kernel` in dot mode,
// pgl_tpu/ops/pallas/attention_kernels.py:288) and K8's row pass (CELLS).
// q's and g's rows are resident in registers, and the row's lse and delta:
// in registers a slot where each slot is its own head, else (WIDE) once a
// head in the warp's shared memory after its ring; each item's k and v
// source rows are staged, in a ring of T (R = T: bf16 rows copied as they
// are and widened as they are read). Per head: p = exp(s - lse), its kept
// value and ds; per slot: dq += ds * k.
// Elements of R of a warp's ring and its row's lse | delta (f32; the
// cells' pairs follow).
template <typename R, int NC>
__host__ __device__ __forceinline__ int dq_warp_elems(int DS, int C, int H) {
  return kv_ring_elems<R, NC>(DS, C) + 2 * up4(H) * kPerFloat<R>;
}

template <typename T, int NC, bool FULL, bool WIDE, bool CELLS>
__global__ void __launch_bounds__(kWarps * 32, KvBlocks<NC, FULL, WIDE>::value)
dot_dq_staged(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ indices, const int* __restrict__ cnt,
              const int* __restrict__ keys, const int4* __restrict__ pieces,
              int n_pieces, int H, int dsh, int dvh, int wp,
              RingCls<T> cls1, RingCls<T> cls2, float slope,
              const int* __restrict__ seed_p, int thresh, float inv_keep,
              T* __restrict__ dq, float* __restrict__ partials) {
  using R = T;  // the ring's element type
  constexpr int P = StageEdges<NC>::value;
  constexpr int S = RingSteps<R>::value;
  static_assert(S * P <= 32, "a lane clears each ring item's pad");
  // lse and delta a head in the warp's shared memory where a slot's own
  // registers do not fit: heads wider than a warp, and bf16 tables at 16
  // slots a lane (held a slot there, they spilled 32 B at 255 registers)
  constexpr bool SHARED_LD = WIDE || (NC >= 16 && !std::is_same_v<T, float>);
  constexpr int NL = SHARED_LD ? 1 : NC;  // lse and delta held a slot
  extern __shared__ float4 kv_smem[];
  const int wb = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarps + wb;
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int DS = H * dsh;
  const int C = H * dvh;
  const int ES = kv_edge_elems<R>(DS, C);
  const int o_v = kv_k_elems<R>(DS);
  R* ring = reinterpret_cast<R*>(kv_smem) +
           static_cast<size_t>(wb) *
               (dq_warp_elems<R, NC>(DS, C, H) +
                cell_pair_floats<R, NC, CELLS>() * kPerFloat<R>);
  // SHARED_LD: the row's lse, delta [H]
  float* lsh = reinterpret_cast<float*>(ring + S * P * ES);
  float* dlh = lsh + up4(H);
  int* pairs = reinterpret_cast<int*>(ring + dq_warp_elems<R, NC>(DS, C, H));
  const int4 pc = pieces[warp];
  const int n = pc.z - pc.y;
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  const int lwp = __ffs(wp) - 1;
  const int kph = WIDE ? wp >> 5 : 1;  // slots of one head in a lane
  uint32_t sw[NC];
  float qr[NC], gr[NC], acc[NC], ls[NL], dl[NL];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c;
    const int sc = dot_col<FULL>(j, lwp, H, dsh);
    const int vc = dot_col<FULL>(j, lwp, H, dvh);
    sw[c] = kv_slot<FULL>(j, lwp, H, dsh, dvh, DS, o_v);
    qr[c] = sc >= 0 ? ld_f(q + static_cast<size_t>(pc.x) * DS + sc) : 0.f;
    gr[c] = vc >= 0 ? ld_f(g + static_cast<size_t>(pc.x) * C + vc) : 0.f;
    if (!SHARED_LD) {
      const size_t rh =
          static_cast<size_t>(pc.x) * H + dot_head<FULL>(j, lwp, H);
      ls[c % NL] = __ldg(lse + rh);
      dl[c % NL] = __ldg(delta + rh);
    }
    acc[c] = 0.f;
  }
  if (SHARED_LD) {
    for (int h = lane; h < H; h += 32) {
      lsh[h] = __ldg(lse + static_cast<size_t>(pc.x) * H + h);
      dlh[h] = __ldg(delta + static_cast<size_t>(pc.x) * H + h);
    }
  }
  if (lane < S * P) ring[lane * ES + DS] = from_f<R>(0.f);  // the pads

  PieceList src(indices, pc.y, n, lane);
  const int steps = (n + P - 1) / P;
  int in = 0, at = 0;  // the ring walk of dot_fwd_staged
  for (int t = 1 - S; t < steps; ++t) {
    const int ts = t + S - 1;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const int j = ts * P + e;
      if (j < n) {  // uniform
        const size_t s = static_cast<size_t>(src.at(j));
        R* st = ring + (in * P + e) * ES;
        stage_ring(st, k + s * DS, DS, cls1, lane);
        stage_ring(st + o_v, v + s * C, C, cls2, lane);
        stage_cell<CELLS>(pairs + 2 * (in * P + e), cnt, keys, pc.y + j,
                          lane);
      }
    }
    cp_async_commit();
    in = in + 1 == S ? 0 : in + 1;
    if (t < 0) continue;  // uniform
    cp_async_wait<S - 1>();
    __syncwarp();
    const R* st0 = ring + at * P * ES;
    // the step's scores and g . v first, their shuffles interleaved; the
    // k values stay in registers for dq
    float kd[P][NC], sd[P][NC], gv[P][NC];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const R* st = st0 + e * ES;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c;
        kd[e][c] = ring_f(st[kv_s<FULL>(sw[c], j)]);
        gv[e][c] = gr[c] * ring_f(st[kv_v<FULL>(sw[c], j, o_v)]);
      }
      head_dot<NC, WIDE ? kWide : kNarrow>(qr, kd[e], wp, sd[e]);
      head_sum<NC, WIDE ? kWide : kNarrow>(gv[e], wp);
    }
#pragma unroll
    for (int e = 0; e < P; ++e) {
      if (t * P + e >= n) break;  // uniform
      const int* pr = pairs + 2 * (at * P + e);
      const uint32_t pos = CELLS ? static_cast<uint32_t>(pr[1])
                                 : static_cast<uint32_t>(pc.y + t * P + e);
      const float mult = CELLS ? static_cast<float>(pr[0]) : 1.f;
      float ds = 0.f;  // the head's
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c;
        if ((c & (kph - 1)) == 0) {  // uniform
          const int hd = dot_head<FULL>(j, lwp, H);
          const float lse_h = SHARED_LD ? lsh[hd] : ls[c % NL];
          const float delta_h = SHARED_LD ? dlh[hd] : dl[c % NL];
          const float p =
              CELLS ? mult * expf(fminf(leaky(sd[e][c], slope) - lse_h, 80.f))
                    : expf(leaky(sd[e][c], slope) - lse_h);
          const float qe =
              drop ? (drop_keep(pos, seed,
                                static_cast<uint32_t>(hd) * 0x632BE5ABu,
                                thresh)
                          ? p * inv_keep
                          : 0.f)
                   : p;
          ds = (qe * gv[e][c] - p * delta_h) * leaky_grad(sd[e][c], slope);
        }
        acc[c] += ds * kd[e][c];
      }
    }
    at = at + 1 == S ? 0 : at + 1;
    __syncwarp();  // every lane is done with this ring slot before it refills
  }
  cp_async_wait<0>();

  // a whole row stores to dq as T, a piece to its f32 partial row: one
  // pointer on float; on bf16 the branch (uniform across the warp) outside
  // the slots' loop, one pointer each (two in the loop spilled 32 B at
  // NC = 16)
  if constexpr (std::is_same_v<T, float>) {
    float* dst = pc.w < 0 ? dq + static_cast<size_t>(pc.x) * DS
                          : partials + static_cast<size_t>(pc.w) * DS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int sc = dot_col<FULL>(lane + 32 * c, lwp, H, dsh);
      if (sc >= 0) dst[sc] = acc[c];
    }
  } else if (pc.w < 0) {
    T* row = dq + static_cast<size_t>(pc.x) * DS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int sc = dot_col<FULL>(lane + 32 * c, lwp, H, dsh);
      if (sc >= 0) row[sc] = from_f<T>(acc[c]);
    }
  } else {
    float* part = partials + static_cast<size_t>(pc.w) * DS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int sc = dot_col<FULL>(lane + 32 * c, lwp, H, dsh);
      if (sc >= 0) part[sc] = acc[c];
    }
  }
}

// The dkv pass, one warp per piece of a source node s: dk[s, h-slice] =
// sum ds * q[dst, h-slice], dv[s, h-slice] = sum kept p * g[dst, h-slice]
// over the node's items; K10-dkv (per edge, over CSR pieces; replaces
// `_attn_bwd_dkv_kernel` in dot mode,
// pgl_tpu/ops/pallas/attention_kernels.py:403) and K8's node walk (CELLS,
// over the node-ordered cells, so dk and dv land on node rows with no slot
// rows and no fold). k's and v's rows are resident in registers; every
// item stages its destination's q row | g row | lse | delta (lse and delta
// copied once per head). Per edge, its CSC position (read from eidx a
// 32-edge batch ahead and written beside the ring by lane 0) keys the
// dropout. Its slot map and edge batches are written out rather than
// through `dot_col` and two `PieceList`s: that form of it took 1.010x /
// 1.022x this one's time at UniMP's shape on the UniMP stand-in, rates 0 /
// 0.3, where a kernel's two runs differ by under 0.1%
// (experiments/torch_spmm/k1_k10_before_after.py --only k10, H100).

// Elements of R of one staged item: q [DS] | g [C] in R, each part
// rounded up to 16 bytes, then lse [H] | delta [H] in f32, each rounded up
// to 4 floats.
template <typename R>
__host__ __device__ __forceinline__ int dkv_edge_elems(int DS, int C, int H) {
  return up16<R>(DS) + up16<R>(C) + 2 * up4(H) * kPerFloat<R>;
}

template <typename R, int NC, bool CELLS>
__host__ __device__ __forceinline__ int dkv_warp_elems(int DS, int C, int H) {
  // the ring, then one int a ring edge (its CSC position), or two a ring
  // cell (its count and key), rounded to 4
  constexpr int ring = RingSteps<R>::value * StageEdges<NC>::value;
  return ring * dkv_edge_elems<R>(DS, C, H) +
         up4((CELLS ? 2 : 1) * ring) * kPerFloat<R>;
}

// blocks an SM of the dkv pass: StageBlocks', and on a bf16 ring
// KvBlocks', as the dq pass (at 8 slots of heads with masked columns, 128
// registers spilled 24-32 B there)
template <typename T, int NC, bool FULL, bool WIDE>
struct DkvBlocks {
  static constexpr int value = std::is_same_v<T, float>
                                   ? StageBlocks<NC>::value
                                   : KvBlocks<NC, FULL, WIDE>::value;
};

// FULL: every slot is a real score and value column (dsh == dvh == wp and
// H * wp == 32 NC, as at UniMP's shape), so a slot's column is its index
// and no slot is masked. WIDE: wp > 32.
template <typename T, int NC, bool FULL, bool WIDE, bool CELLS>
__global__ void __launch_bounds__(kWarps * 32,
                                  DkvBlocks<T, NC, FULL, WIDE>::value)
dot_dkv_staged(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ indices, const int* __restrict__ eidx,
               const int* __restrict__ cnt, const int* __restrict__ keys,
               const int4* __restrict__ pieces, int n_pieces, int H, int dsh,
               int dvh, int wp, RingCls<T> cls, float slope,
               const int* __restrict__ seed_p, int thresh, float inv_keep,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ partials) {
  using R = T;  // the ring's element type of q and g
  constexpr int P = StageEdges<NC>::value;
  constexpr int S = RingSteps<R>::value;
  extern __shared__ float4 dkv_smem[];
  const int wb = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarps + wb;
  if (warp >= n_pieces) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int DS = H * dsh;
  const int C = H * dvh;
  const int ES = dkv_edge_elems<R>(DS, C, H);
  const int o_g = up16<R>(DS);
  // the item's lse [H] and delta [H]: floats from the item's start
  const int o_l = (o_g + up16<R>(C)) / kPerFloat<R>;
  const int o_d = o_l + up4(H);
  R* ring = reinterpret_cast<R*>(dkv_smem) +
           static_cast<size_t>(wb) * dkv_warp_elems<R, NC, CELLS>(DS, C, H);
  // per edge: a CSC position a ring edge; CELLS: a (count, key) pair
  int* ring_pos = reinterpret_cast<int*>(ring + S * P * ES);
  const int4 pc = pieces[warp];
  const int n = pc.z - pc.y;
  const bool drop = thresh >= 0;
  const uint32_t seed = drop ? static_cast<uint32_t>(__ldg(seed_p)) : 0u;
  // slot c of this lane: slot j = lane + 32 c is column j % wp of head
  // j / wp (DotSlots; wp is a power of two)
  const int lwp = __ffs(wp) - 1;
  const int kph = WIDE ? wp >> 5 : 1;  // slots of one head in a lane

  float kr[NC], vr[NC], dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
    kr[c] = FULL || (h < H && w < dsh)
                ? ld_f(k + static_cast<size_t>(pc.x) * DS +
                       (FULL ? j : h * dsh + w))
                : 0.f;
    vr[c] = FULL || (h < H && w < dvh)
                ? ld_f(v + static_cast<size_t>(pc.x) * C +
                       (FULL ? j : h * dvh + w))
                : 0.f;
    dka[c] = 0.f;
    dva[c] = 0.f;
  }

  // the staging side's 32-item batch of destinations (and, per edge, CSC
  // positions), a lane each, and the batch after it
  const bool by_pos = !CELLS && drop;
  int ib = 0;
  int imine = piece_entry(indices, pc.y, 0, n, lane);
  int inext = piece_entry(indices, pc.y, 32, n, lane);
  int pmine = by_pos ? piece_entry(eidx, pc.y, 0, n, lane) : 0;
  int pnext = by_pos ? piece_entry(eidx, pc.y, 32, n, lane) : 0;
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
          if (by_pos) pnext = piece_entry(eidx, pc.y, ib + 32, n, lane);
        }
        const size_t d =
            static_cast<size_t>(__shfl_sync(kFull, imine, j & 31));
        const int pos = CELLS ? 0 : __shfl_sync(kFull, pmine, j & 31);
        R* st = ring + ((ts % S) * P + e) * ES;
        stage_ring(st, q + d * DS, DS, cls, lane);
        stage_ring(st + o_g, g + d * C, C, cls, lane);
        float* sf = reinterpret_cast<float*>(st);
        for (int h = lane; h < H; h += 32) {
          cp_async4(sf + o_l + h, lse + d * H + h);
          cp_async4(sf + o_d + h, delta + d * H + h);
        }
        if (CELLS)
          stage_cell<CELLS>(ring_pos + 2 * ((ts % S) * P + e), cnt, keys,
                            pc.y + j, lane);
        else if (lane == 0)
          ring_pos[(ts % S) * P + e] = pos;
      }
    }
    cp_async_commit();
    if (t < 0) continue;  // uniform
    cp_async_wait<S - 1>();  // this lane's copies of step t have landed
    __syncwarp();            // and every lane's
    const R* st0 = ring + (t % S) * P * ES;
    // the step's scores and g . v first, their shuffles interleaved; q and
    // g are read again from the ring below rather than held
    float sd[P][NC], gv[P][NC];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const R* st = st0 + e * ES;
      float qd[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
        qd[c] = FULL || (h < H && w < dsh)
                    ? ring_f(st[FULL ? j : h * dsh + w])
                    : 0.f;
        gv[e][c] = FULL || (h < H && w < dvh)
                       ? ring_f(st[o_g + (FULL ? j : h * dvh + w)]) * vr[c]
                       : 0.f;
      }
      head_dot<NC, WIDE ? kWide : kNarrow>(qd, kr, wp, sd[e]);
      head_sum<NC, WIDE ? kWide : kNarrow>(gv[e], wp);
    }
#pragma unroll
    for (int e = 0; e < P; ++e) {
      if (t * P + e >= n) break;  // uniform
      const R* st = st0 + e * ES;
      const float* sf = reinterpret_cast<const float*>(st);
      const int r = (t % S) * P + e;
      const uint32_t pos = static_cast<uint32_t>(
          CELLS ? ring_pos[2 * r + 1] : ring_pos[r]);
      const float mult = CELLS ? static_cast<float>(ring_pos[2 * r]) : 1.f;
      // p, its kept value and ds are a head's: computed at the first of
      // the head's kph slots in this lane and kept for the others
      float p = 0.f, qe = 0.f, ds = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
        if ((c & (kph - 1)) == 0) {  // uniform
          const int hd = FULL ? h : min(h, H - 1);
          p = CELLS ? mult * expf(fminf(leaky(sd[e][c], slope) -
                                            sf[o_l + hd],
                                        80.f))
                    : expf(leaky(sd[e][c], slope) - sf[o_l + hd]);
          qe = drop ? (drop_keep(pos, seed,
                                 static_cast<uint32_t>(hd) * 0x632BE5ABu,
                                 thresh)
                           ? p * inv_keep
                           : 0.f)
                    : p;
          ds = (qe * gv[e][c] - p * sf[o_d + hd]) *
               leaky_grad(sd[e][c], slope);
        }
        if (FULL || (h < H && w < dsh))
          dka[c] += ds * ring_f(st[FULL ? j : h * dsh + w]);
        if (FULL || (h < H && w < dvh))
          dva[c] += qe * ring_f(st[o_g + (FULL ? j : h * dvh + w)]);
      }
    }
    __syncwarp();  // every lane is done with slot t % S before it refills
  }
  cp_async_wait<0>();

  // as the dq pass: one pointer a table on float
  if constexpr (std::is_same_v<T, float>) {
    float* pdk = pc.w < 0 ? dk + static_cast<size_t>(pc.x) * DS
                          : partials + static_cast<size_t>(pc.w) * (DS + C);
    float* pdv = pc.w < 0 ? dv + static_cast<size_t>(pc.x) * C : pdk + DS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
      if (FULL || (h < H && w < dsh)) pdk[FULL ? j : h * dsh + w] = dka[c];
      if (FULL || (h < H && w < dvh)) pdv[FULL ? j : h * dvh + w] = dva[c];
    }
  } else if (pc.w < 0) {
    T* rdk = dk + static_cast<size_t>(pc.x) * DS;
    T* rdv = dv + static_cast<size_t>(pc.x) * C;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
      if (FULL || (h < H && w < dsh))
        rdk[FULL ? j : h * dsh + w] = from_f<T>(dka[c]);
      if (FULL || (h < H && w < dvh))
        rdv[FULL ? j : h * dvh + w] = from_f<T>(dva[c]);
    }
  } else {
    float* pdk = partials + static_cast<size_t>(pc.w) * (DS + C);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c, h = j >> lwp, w = j & (wp - 1);
      if (FULL || (h < H && w < dsh)) pdk[FULL ? j : h * dsh + w] = dka[c];
      if (FULL || (h < H && w < dvh))
        pdk[DS + (FULL ? j : h * dvh + w)] = dva[c];
    }
  }
}

// Sets a staged kernel's dynamic shared memory to `smem` bytes and launches
// it, one warp a piece.
template <typename... KArgs, typename... Args>
cudaError_t launch_staged(void (*kernel)(KArgs...), size_t smem,
                          int n_pieces, cudaStream_t s, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks_for(n_pieces), kWarps * 32, smem, s>>>(args...);
  return cudaGetLastError();
}

// The bytes a copy that every row of a staged tensor `width` wide allows:
// 16 where every row is 16-byte aligned (the width a multiple of 16 bytes,
// the tensor 16-byte aligned), else 4 where every row is 4-byte aligned
// (always on float), else 2 (bf16 rows on a 2-byte boundary).
template <typename T>
int row_class(int width, const T* a) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(a);
  const size_t bytes = sizeof(T) * static_cast<size_t>(width);
  if (bytes % 16 == 0 && at % 16 == 0) return 16;
  if (bytes % 4 == 0 && at % 4 == 0) return 4;
  return static_cast<int>(sizeof(T));
}

// Whether a tensor is staged by 16-byte vectors (the forward; each of a
// kernel's two staged tensors is decided alone)
template <typename T>
bool row_vec(int width, const T* a) {
  return row_class(width, a) == 16;
}

// The copy class of a staged tensor in a backward pass's ring of T
// (`RingCls`); the dkv pass takes the lesser of q's and g's
template <typename T>
RingCls<T> ring_class(int width, const T* a) {
  if constexpr (std::is_same_v<T, float>) {
    return row_vec(width, a);
  } else {
    return row_class(width, a);
  }
}

// Whether every slot is a real score and value column (FULL).
bool dot_full(int H, int dsh, int dvh, int wp, int nc) {
  return dsh == dvh && dsh == wp && H * wp == 32 * nc;
}

}  // namespace

// The instantiation of a staged dot kernel for `full` and `wide`
// (wp > 32, never at NC = 1, which holds at most 32 slots)
#define PGL_DOT_PICK(KERNEL, T, NC, CELLS)                               \
  (full ? (wide ? KERNEL<T, NC, true, (NC > 1), CELLS>                  \
                : KERNEL<T, NC, true, false, CELLS>)                     \
        : (wide ? KERNEL<T, NC, false, (NC > 1), CELLS>                 \
                : KERNEL<T, NC, false, false, CELLS>))

namespace {

// The launches of each pass over one work list, the second launch that
// finishes split rows included; `cnt` and `keys` are the cells' (CELLS),
// null per edge. Each returns cudaGetLastError() or the first error.
template <bool CELLS, typename T>
int dot_fwd_run(const T* q, const T* k, const T* v, const int* indices,
                const int* cnt, const int* keys, const int* pieces,
                int n_pieces, const int* split_rows, const int* split_ptr,
                int n_split, int H, int dsh, int dvh, float slope,
                const int* seed, int thresh, float inv_keep, T* out,
                float* lse, float* partials, cudaStream_t s) {
  int wp = 0;
  const int nc = dot_slots(H, dsh, dvh, &wp);
  const int dvh_p = pow2_at_least(dvh);
  const int ncv = slots_per_lane(H, dvh_p);
  if (nc == 0 || H <= 0 || dsh <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  const bool vec1 = row_vec(H * dsh, k), vec2 = row_vec(H * dvh, v);
  const bool full = dot_full(H, dsh, dvh, wp, nc), wide = wp > 32;
  cudaError_t err = cudaSuccess;
  PGL_NC_SWITCH(nc, {
    const size_t smem = sizeof(float) * kWarps *
                        (kv_ring_elems<float, NC>(H * dsh, H * dvh) +
                         cell_pair_floats<float, NC, CELLS>());
    err = launch_staged(
        PGL_DOT_PICK(dot_fwd_staged, T, NC, CELLS), smem, n_pieces, s, q, k,
        v,
        indices, cnt, keys, pc, n_pieces, H, dsh, dvh, wp, vec1, vec2, slope,
        seed, thresh, inv_keep, out, lse, partials);
    if (err != cudaSuccess) return static_cast<int>(err);
  })
  if (n_split > 0) {
    PGL_NC_SWITCH(ncv, {
      gat_fwd_combine<T, NC>
          <<<n_split, CombineWarps<NC>::value * 32, 0, s>>>(
          partials, split_rows, split_ptr, H, dvh, dvh_p, inv_keep, out,
          lse);
    })
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool CELLS, typename T>
int dot_dq_run(const T* q, const T* k, const T* v, const T* g,
               const float* lse, const float* delta, const int* indices,
               const int* cnt, const int* keys, const int* pieces,
               int n_pieces, const int* split_rows, const int* split_ptr,
               int n_split, int H, int dsh, int dvh, float slope,
               const int* seed, int thresh, float inv_keep, T* dq,
               float* partials, cudaStream_t s) {
  int wp = 0;
  const int nc = dot_slots(H, dsh, dvh, &wp);
  if (nc == 0 || H <= 0 || dsh <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  const RingCls<T> cls1 = ring_class(H * dsh, k),
                   cls2 = ring_class(H * dvh, v);
  const bool full = dot_full(H, dsh, dvh, wp, nc), wide = wp > 32;
  cudaError_t err = cudaSuccess;
  PGL_NC_SWITCH(nc, {
    const size_t smem = sizeof(T) * kWarps *
                        (dq_warp_elems<T, NC>(H * dsh, H * dvh, H) +
                         cell_pair_floats<T, NC, CELLS>() * kPerFloat<T>);
    err = launch_staged(
        PGL_DOT_PICK(dot_dq_staged, T, NC, CELLS), smem, n_pieces, s, q, k,
        v,
        g, lse, delta, indices, cnt, keys, pc, n_pieces, H, dsh, dvh, wp,
        cls1, cls2, slope, seed, thresh, inv_keep, dq, partials);
    if (err != cudaSuccess) return static_cast<int>(err);
  })
  if (n_split > 0)
    sum_combine<T><<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H * dsh, 0, dq, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <bool CELLS, typename T>
int dot_dkv_run(const T* q, const T* k, const T* v, const T* g,
                const float* lse, const float* delta, const int* indices,
                const int* eidx, const int* cnt, const int* keys,
                const int* pieces, int n_pieces, const int* split_rows,
                const int* split_ptr, int n_split, int H, int dsh, int dvh,
                float slope, const int* seed, int thresh, float inv_keep,
                T* dk, T* dv, float* partials, cudaStream_t s) {
  int wp = 0;
  const int nc = dot_slots(H, dsh, dvh, &wp);
  if (nc == 0 || H <= 0 || dsh <= 0 || dvh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  const auto* pc = reinterpret_cast<const int4*>(pieces);
  const RingCls<T> cls_q = ring_class(H * dsh, q),
                   cls_g = ring_class(H * dvh, g);
  const RingCls<T> cls = cls_q < cls_g ? cls_q : cls_g;
  const bool full = dot_full(H, dsh, dvh, wp, nc), wide = wp > 32;
  cudaError_t err = cudaSuccess;
  PGL_NC_SWITCH(nc, {
    const size_t smem = sizeof(T) * kWarps *
                        dkv_warp_elems<T, NC, CELLS>(H * dsh, H * dvh, H);
    err = launch_staged(
        PGL_DOT_PICK(dot_dkv_staged, T, NC, CELLS), smem, n_pieces, s, q, k,
        v,
        g, lse, delta, indices, eidx, cnt, keys, pc, n_pieces, H, dsh, dvh,
        wp, cls, slope, seed, thresh, inv_keep, dk, dv, partials);
    if (err != cudaSuccess) return static_cast<int>(err);
  })
  if (n_split > 0)
    sum_combine<T><<<n_split, kSumWarps * 32, 0, s>>>(
        partials, split_rows, split_ptr, H * dsh, H * dvh, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
