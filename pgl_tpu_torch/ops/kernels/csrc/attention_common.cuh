// Device code shared by the attention sources: attention_kernels.cu (the
// per-edge kernels K9/K10) and dedup_attention.cu (the count-matrix kernels
// K7/K8), through dot_staged.cuh and additive_groups.cuh too. `_build.py`
// hashes every header of this directory into each library's name, so an
// edit here rebuilds both.
//
// * `drop_keep`: the reference's counter hash `_drop_keep`
//   (pgl_tpu/ops/pallas/attention_kernels.py) in uint32 arithmetic, which is
//   the reference's int32 wrap-around with logical shifts;
// * `Slots`: how a warp's lanes hold H heads of dvh columns: head h owns
//   dvh_p (dvh rounded up to a power of two) consecutive slots, slot j =
//   lane + 32 k, so a per-head sum is a shuffle reduction (`head_sum`);
//   `DotSlots`, the same for the dot mode, whose heads hold their dsh score
//   and dvh value columns in one group of max(dsh_p, dvh_p) slots
//   (`dot_slots` sizes it), and `head_dot`, the one per-head score q . k
//   of every dot pass, per-edge (K9/K10) and count-matrix (K7/K8) alike;
// * the second launches that finish rows split over several warps:
//   `gat_fwd_combine` merges online-softmax partials (m, l, acc), a few
//   pieces' loads in flight, `sum_combine` adds plain partials, both in a
//   fixed order (no float atomics, so every run gives the same bits);
// * the staging of gathered rows that the dot-mode kernels (K9, K10-dq,
//   K10-dkv and their cell forms) share: a per-warp shared-memory ring
//   filled by cp.async (`RingSteps`, `StageEdges`, `StageBlocks`,
//   `stage_ring`, `stage_row`), the piece's edge list read a 32-entry
//   batch ahead (`PieceList`), and DotSlots' slot map computed rather than
//   held (`dot_col`, `dot_head`);
// * the element type T of the tables (float, or __nv_bfloat16 under amp):
//   `ld_f` reads one element as f32, `from_f` rounds an f32 once to T (to
//   nearest even). The backward passes' ring holds T (`stage_ring` copies
//   bytes, `ring_f` widens an element exactly as it is read); the
//   forward's ring holds f32, which `stage_row` widens a bf16 row into as
//   it stages it. Every kernel computes in f32 whatever T is; lse, delta
//   and the split rows' partials are f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;              // warps per block of the piece kernels
constexpr float kMaskValue = -1e30f;   // the reference's running-max start

// one element of a table of T as f32 (exact)
__device__ __forceinline__ float ld_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// an f32 value stored as T: itself, or rounded once to nearest even
template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// elements of T in a 16-byte vector: 4 floats, 8 bf16
template <typename T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ bool drop_keep(uint32_t idx, uint32_t seed,
                                          uint32_t hc, int thresh) {
  uint32_t x = idx ^ (seed + hc);
  x *= 0x9E3779B1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return static_cast<int>(x & 0x7FFFFFFFu) < thresh;
}

// slope 0 means no leaky relu at all (the reference's `if leaky_slope`)
__device__ __forceinline__ float leaky(float s, float slope) {
  return (slope != 0.f && !(s >= 0.f)) ? s * slope : s;
}

__device__ __forceinline__ float leaky_grad(float s, float slope) {
  return (slope != 0.f && !(s >= 0.f)) ? slope : 1.f;
}

// The slots of one lane: head (clamped to H - 1 on the padding past the
// last head), column (-1 on padding), the head's hash constant, and whether
// the lane is its head's first (it writes per-head values).
template <int NC>
struct Slots {
  int head[NC];
  int col[NC];
  uint32_t hc[NC];
  bool lead[NC];

  __device__ __forceinline__ Slots(int lane, int H, int dvh, int dvh_p) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int j = lane + 32 * k;
      const int h = j / dvh_p;
      const int w = j - h * dvh_p;
      const bool ok = h < H && w < dvh;
      head[k] = min(h, H - 1);
      col[k] = ok ? h * dvh + w : -1;
      hc[k] = static_cast<uint32_t>(head[k]) * 0x632BE5ABu;
      lead[k] = ok && w == 0;
    }
  }
};

// What a kernel knows of its heads' width wp at compile time: nothing (the
// sums test wp), or that every head is within a warp (wp <= 32) or wider.
// A kernel that knows compiles one branch of the sums: the staged dot
// kernels, where the other branch's registers slowed K10-dkv by 1% at
// UniMP's shape (experiments/torch_spmm/k1_k10_before_after.py, H100).
enum HeadWidth { kAnyWidth, kNarrow, kWide };

// x[k] <- sum of x over the slots of k's head, a group of wp slots (a
// power of two); every lane of the warp must call it (wp is uniform). Every
// slot of a head ends with the same bits. Heads wider than a warp hold kph =
// wp / 32 consecutive slots in each lane: those are summed in the lane
// first, then once across the warp, and the sum is copied back. Where wp <=
// 32, each level of the tree is taken for every slot before the next, so
// the NC slots' shuffles are in flight together (each slot adds in the
// same order); taken so where wp > 32, whose slots branch on kph, it ran
// 1.16-1.29x slower at UniMP's shape (same script).
template <int NC, int W = kAnyWidth>
__device__ __forceinline__ void head_sum(float (&x)[NC], int wp) {
  if (W == kNarrow || (W == kAnyWidth && wp <= 32)) {
    for (int off = wp >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < NC; ++k) x[k] += __shfl_xor_sync(kFull, x[k], off);
    }
    return;
  }
  const int kph = wp >> 5;
#pragma unroll
  for (int s = 1; s < NC; s <<= 1) {
    if (s < kph) {
      float t[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) t[k] = x[k] + x[k ^ s];
#pragma unroll
      for (int k = 0; k < NC; ++k) x[k] = t[k];
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if ((k & (kph - 1)) == 0) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x[k] += __shfl_xor_sync(kFull, x[k], off);
    }
#pragma unroll
  for (int s = 1; s < NC; s <<= 1) {
    if (s < kph) {
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (k & s) x[k] = x[k ^ s];
    }
  }
}

// Dot mode: head h owns wp = max(dsh_p, dvh_p) consecutive slots (slot j =
// lane + 32 k); slot w of head h holds score column h * dsh + w (w < dsh,
// else -1) and value column h * dvh + w (w < dvh, else -1).
template <int NC>
struct DotSlots {
  int head[NC];
  int scol[NC];
  int vcol[NC];
  uint32_t hc[NC];
  bool lead[NC];

  __device__ __forceinline__ DotSlots(int lane, int H, int dsh, int dvh,
                                      int wp) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int j = lane + 32 * k;
      const int h = j / wp;
      const int w = j - h * wp;
      const bool ok = h < H;
      head[k] = min(h, H - 1);
      scol[k] = ok && w < dsh ? h * dsh + w : -1;
      vcol[k] = ok && w < dvh ? h * dvh + w : -1;
      hc[k] = static_cast<uint32_t>(head[k]) * 0x632BE5ABu;
      lead[k] = ok && w == 0;
    }
  }
};

// s[k] <- the score q . k of k's head, the same bits in every pass: K9 and
// K10-dq hold q resident and gather k, K10-dkv gathers q and holds k, and
// all three call this with q first and the same slot map and tree.
template <int NC, int W = kAnyWidth>
__device__ __forceinline__ void head_dot(const float (&q)[NC],
                                         const float (&k)[NC], int wp,
                                         float (&s)[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) s[i] = q[i] * k[i];
  head_sum<NC, W>(s, wp);
}

// Online merge of a softmax state (M, L, A) with a partial (m, l, a).
__device__ __forceinline__ void merge(float& M, float& L, float& A, float m,
                                      float l, float a) {
  const float mn = fmaxf(M, m);
  const float s1 = expf(M - mn);
  const float s2 = expf(m - mn);
  L = L * s1 + l * s2;
  A = A * s1 + a * s2;
  M = mn;
}

// warps of a combine block: 16, fewer where slots per lane would overflow
// the block's 24 KB of shared state
template <int NC>
struct CombineWarps {
  static constexpr int value = NC >= 4 ? 64 / NC : 16;
};

// Pieces whose partials a combine warp loads before it merges them: 4 up
// to four slots a lane, then 16 / NC (at most 48 registers of loads in
// flight). Measured with the additive forward's 32 warps a row on the
// bench GAT graph's split rows (experiments/torch_spmm/fwd_variants.py,
// H100): K9 with its combine 0.098 device ms at (8, 8) against 0.121 at 8
// ahead (140 B spilled at 32 warps' 64 registers), 0.119 at 16 and 0.138
// at 1.
template <int NC>
struct CombineAhead {
  static constexpr int value = NC >= 8 ? 16 / NC : 4;
};

// Merge of the softmax partials of split rows (flash decoding), one block
// per row. A partial row is acc [C] | m [H] | l [H]. Warp w merges pieces
// p0 + w, p0 + w + W, ... in order, then warp 0 merges the W warp states in
// order, and writes out [R, C] (scaled by inv_keep / l) and lse [R, H]; a
// row with l = 0 writes zeros to both. A warp loads the partials of B =
// CombineAhead pieces at once and then merges them one by one, so their
// loads are in flight together; the merges and their order are those of a
// walk of one piece at a time (the same bits). The dot mode takes W =
// CombineWarps (its pinned bits are of that order), the additive forward
// more (additive_groups.cuh).
template <typename T, int NC, int W = CombineWarps<NC>::value>
__global__ void __launch_bounds__(W * 32)
gat_fwd_combine(const float* __restrict__ partials,
                const int* __restrict__ split_rows,
                const int* __restrict__ split_ptr, int H, int dvh, int dvh_p,
                float inv_keep, T* __restrict__ out,
                float* __restrict__ lse) {
  __shared__ float state[W][3][NC * 32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = H * dvh;
  const size_t P = static_cast<size_t>(C + 2 * H);  // partial row width
  const Slots<NC> sl(lane, H, dvh, dvh_p);
  const int p0 = split_ptr[blockIdx.x];
  const int p1 = split_ptr[blockIdx.x + 1];
  const int r = split_rows[blockIdx.x];
  float M[NC], L[NC], A[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    M[k] = kMaskValue;
    L[k] = 0.f;
    A[k] = 0.f;
  }
  constexpr int B = CombineAhead<NC>::value;
  for (int p = p0 + w; p < p1; p += B * W) {
    float pm[B][NC], pl[B][NC], pa[B][NC];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const bool on = p + b * W < p1;
      const float* part = partials + (p + b * W) * P;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        pm[b][k] = on ? part[C + sl.head[k]] : 0.f;
        pl[b][k] = on ? part[C + H + sl.head[k]] : 0.f;
        pa[b][k] = on && sl.col[k] >= 0 ? part[sl.col[k]] : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (p + b * W >= p1) break;  // uniform across the warp
#pragma unroll
      for (int k = 0; k < NC; ++k)
        merge(M[k], L[k], A[k], pm[b][k], pl[b][k], pa[b][k]);
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    state[w][0][k * 32 + lane] = M[k];
    state[w][1][k * 32 + lane] = L[k];
    state[w][2][k * 32 + lane] = A[k];
  }
  __syncthreads();
  if (w != 0) return;
  for (int v = 1; v < W; ++v) {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      merge(M[k], L[k], A[k], state[v][0][k * 32 + lane],
            state[v][1][k * 32 + lane], state[v][2][k * 32 + lane]);
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool row = L[k] > 0.f;
    if (sl.col[k] >= 0)
      out[static_cast<size_t>(r) * C + sl.col[k]] =
          from_f<T>(row ? A[k] * (inv_keep / fmaxf(L[k], 1e-30f)) : 0.f);
    if (sl.lead[k])
      lse[static_cast<size_t>(r) * H + sl.head[k]] =
          row ? M[k] + logf(L[k]) : 0.f;
  }
}

// Sum of the plain partials of split rows, one block per row: partial rows
// [n1 | n2] (f32), 32 columns at a time; warp w sums pieces p0 + w, p0 + w +
// W, ... in order, then warp 0 adds the W warp sums in order, into out1
// [R, n1] and out2 [R, n2] of T (each sum rounded once).
constexpr int kSumWarps = 16;

template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
sum_combine(const float* __restrict__ partials,
            const int* __restrict__ split_rows,
            const int* __restrict__ split_ptr, int n1, int n2,
            T* __restrict__ out1, T* __restrict__ out2) {
  __shared__ float sums[kSumWarps][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t P = static_cast<size_t>(n1 + n2);
  const int p0 = split_ptr[blockIdx.x];
  const int p1 = split_ptr[blockIdx.x + 1];
  const size_t r = split_rows[blockIdx.x];
  for (int c0 = 0; c0 < n1 + n2; c0 += 32) {
    const int c = c0 + lane;
    float t = 0.f;
    if (c < n1 + n2) {
#pragma unroll 8
      for (int p = p0 + w; p < p1; p += kSumWarps) t += partials[p * P + c];
    }
    sums[w][lane] = t;
    __syncthreads();
    if (w == 0 && c < n1 + n2) {
      float total = 0.f;
#pragma unroll
      for (int v = 0; v < kSumWarps; ++v) total += sums[v][lane];
      if (c < n1)
        out1[r * n1 + c] = from_f<T>(total);
      else
        out2[r * n2 + (c - n1)] = from_f<T>(total);
    }
    __syncthreads();
  }
}

// slots per lane for H heads of dvh_p slots: 1, 2, 4, 8 or 16; 0 if wider
int slots_per_lane(int H, int dvh_p) {
  const int need = (H * dvh_p + 31) / 32;
  int nc = 1;
  while (nc < need) nc <<= 1;
  return nc <= 16 ? nc : 0;
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Slots per lane of the dot mode (0 if the heads do not fit) and the group
// width wp of each head.
int dot_slots(int H, int dsh, int dvh, int* wp) {
  *wp = pow2_at_least(dsh > dvh ? dsh : dvh);
  return slots_per_lane(H, *wp);
}

int blocks_for(int warps) { return (warps + kWarps - 1) / kWarps; }

constexpr int unroll_for(int nc) { return nc <= 2 ? 4 : (nc <= 4 ? 2 : 1); }

// -- staged gathers (the dot-mode kernels) -----------------------------------
//
// Each warp keeps a ring of S = RingSteps<R> steps of StageEdges<NC> edges
// in shared memory, an edge's gathered rows one after the other (each part
// padded to 16 bytes), and fills it by cp.async (16-byte copies where every
// row is 16-byte aligned, else 4-byte) S - 1 steps ahead of the step it
// computes, so the loads in flight hold no registers. The P edges of a
// step are computed together, so their head reductions' shuffles
// interleave. R is the ring's element type: f32, or bf16 in the bf16
// backward passes, whose depth is its own constant (kBf16RingSteps). A
// bf16 item is about half an f32 item's bytes, yet depth hardly matters at
// UniMP's shape: K10-dq + K10-dkv at 3, 4 and 6 steps came within 2%, 3
// and 4 trading places between runs, 6 the slowest (experiments/torch_spmm/
// k1_k10_before_after.py --bf16 --depths, H100). 4 is kept: at 3 and 6 the
// bf16 K10-dkv at NC = 8, FULL, not WIDE spilled 4 B in its 128 registers.
constexpr int kStageSteps = 3;
constexpr int kBf16RingSteps = 4;

template <typename R>
struct RingSteps {  // S: steps of a ring of R
  static constexpr int value =
      std::is_same_v<R, float> ? kStageSteps : kBf16RingSteps;
};

template <int NC>
struct StageEdges {  // P: edges a step
  static constexpr int value = NC <= 2 ? 4 : (NC <= 4 ? 2 : 1);
};

// at most 128 registers (two blocks of 8 warps an SM) up to NC = 8
template <int NC>
struct StageBlocks {
  static constexpr int value = NC <= 8 ? 2 : 1;
};

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

// n elements of R rounded up to a multiple of 16 bytes: up4 on float, in
// its form, so the f32 kernels compile the arithmetic they did
template <typename R>
__host__ __device__ __forceinline__ int up16(int n) {
  constexpr int V = kVecElems<R>;
  return (n + V - 1) & ~(V - 1);
}

// a ring element as f32 (exact)
__device__ __forceinline__ float ring_f(float x) { return x; }
__device__ __forceinline__ float ring_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// The copy class of a staged part of a ring of R (`ring_class`): on a
// float ring whether every row of the part is 16-byte aligned (16-byte
// copies, else 4-byte), as the float32 kernels always took it; on a bf16
// ring the bytes a copy, 16, 4 or 2 (`row_class`).
template <typename R>
using RingCls = std::conditional_t<std::is_same_v<R, float>, bool, int>;

// The warp copies n floats from src to dst (both 16-byte aligned when vec)
// by cp.async.
__device__ __forceinline__ void stage_ring(float* dst, const float* src,
                                           int n, bool vec, int lane) {
  if (vec) {
    for (int c = lane; c < n / 4; c += 32) cp_async16(dst + 4 * c, src + 4 * c);
  } else {
    for (int c = lane; c < n; c += 32) cp_async4(dst + c, src + c);
  }
}

// The warp copies n bf16 from src to dst, cls bytes a copy: by cp.async,
// 16-byte copies where every row of the part is 16-byte aligned, 4-byte
// copies of two where it is 4-byte aligned; a row that starts on a 2-byte
// boundary (an odd width) by plain loads and shared stores, which cp.async
// cannot copy, so their latency is taken at the step that stages them.
// The __syncwarp after cp_async_wait makes either visible to the warp.
__device__ __forceinline__ void stage_ring(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int n,
                                           int cls, int lane) {
  if (cls == 16) {
    for (int c = lane; c < n / 8; c += 32) cp_async16(dst + 8 * c, src + 8 * c);
  } else if (cls == 4) {
    for (int c = lane; c < n / 2; c += 32) cp_async4(dst + 2 * c, src + 2 * c);
  } else {
    for (int c = lane; c < n; c += 32) dst[c] = __ldg(src + c);
  }
}

// The forward's staging into its f32 ring: float rows by cp.async,
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n,
                                          bool vec, int lane) {
  stage_ring(dst, src, n, vec, lane);
}

// and bf16 rows widened to f32 (src 16-byte aligned and n a multiple of 8
// when vec): plain loads and shared stores, not cp.async, which copies
// bytes and cannot widen; the step's loads are waited for here rather than
// kStageSteps - 1 steps later, and the __syncwarp after cp_async_wait makes
// them visible to the warp as the copies are.
__device__ __forceinline__ void stage_row(float* dst,
                                          const __nv_bfloat16* src, int n,
                                          bool vec, int lane) {
  if (vec) {
    for (int c = lane; c < n / 8; c += 32) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(src) + c);
      const unsigned w[4] = {t.x, t.y, t.z, t.w};
      float f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 p =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        f[2 * i] = p.x;
        f[2 * i + 1] = p.y;
      }
      float4* d = reinterpret_cast<float4*>(dst + 8 * c);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
    for (int c = lane; c < n; c += 32) dst[c] = ld_f(src + c);
  }
}

// entry `base + lane` of a piece's list `a` from `y` (0 past its n)
__device__ __forceinline__ int piece_entry(const int* __restrict__ a,
                                           int y, int base, int n,
                                           int lane) {
  return base + lane < n ? __ldg(a + y + base + lane) : 0;
}

// A piece's n entries of `a` from `y`, read by a warp that walks them in
// order: each lane holds one entry of the current 32-entry batch and one of
// the batch after it. Every lane calls `at(j)` with the same j, never
// smaller than the last; n = 0 reads nothing and gives 0.
struct PieceList {
  const int* __restrict__ a;
  int y, n, lane, base, mine, next;

  __device__ __forceinline__ PieceList(const int* __restrict__ a_, int y_,
                                       int n_, int lane_)
      : a(a_), y(y_), n(n_), lane(lane_), base(0),
        mine(piece_entry(a_, y_, 0, n_, lane_)),
        next(piece_entry(a_, y_, 32, n_, lane_)) {}

  __device__ __forceinline__ int at(int j) {
    if (j >= base + 32) {  // uniform
      base += 32;
      mine = next;
      next = piece_entry(a, y, base + 32, n, lane);
    }
    return __shfl_sync(kFull, mine, j & 31);
  }
};

// DotSlots' slot map computed rather than held: slot j = lane + 32 c is
// column j % wp of head j / wp (wp = 1 << lwp); its column in a row of H
// heads dh wide, -1 past dh or past the last head. FULL (every slot a real
// column: dsh == dvh == wp and H * wp == 32 NC) gives j itself.
template <bool FULL>
__device__ __forceinline__ int dot_col(int j, int lwp, int H, int dh) {
  if (FULL) return j;
  const int h = j >> lwp, w = j & ((1 << lwp) - 1);
  return h < H && w < dh ? h * dh + w : -1;
}

// the head of slot j, clamped to H - 1 on the padding past the last head
template <bool FULL>
__device__ __forceinline__ int dot_head(int j, int lwp, int H) {
  return FULL ? j >> lwp : min(j >> lwp, H - 1);
}

}  // namespace

// BODY (the variadic arguments) runs with NC, a compile-time slots-per-lane
#define PGL_NC_CASE(N, ...) \
  case N: {                 \
    constexpr int NC = N;   \
    __VA_ARGS__;            \
  } break;
#define PGL_NC_SWITCH(NC_VAR, ...)     \
  switch (NC_VAR) {                    \
    PGL_NC_CASE(1, __VA_ARGS__)        \
    PGL_NC_CASE(2, __VA_ARGS__)        \
    PGL_NC_CASE(4, __VA_ARGS__)        \
    PGL_NC_CASE(8, __VA_ARGS__)        \
    default:                           \
      PGL_NC_CASE(16, __VA_ARGS__)     \
  }
