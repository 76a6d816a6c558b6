// Two-phase unique-source ("dedup") SpMM for Hopper (sm_90a). Per
// (block, window) pair p of a layout built by `build_dedup_layout`
// (pgl_tpu_torch/ops/kernels/dedup_kernels.py):
//   C_p[r, c] = #edges of p with dst blk_p*256 + r and unique row wb_p + c
//   out[blk_p*256 + r, :] += sum_c C_p[r, c] * x[uv[wb_p + c], :]
//
// Replaces the TPU kernels of pgl_tpu/ops/pallas/dedup_kernels.py:
//   * K4 `_materialize_kernel` (:554) with `_count_tiles` (the counts as
//     bf16 [P*256, 128]): `pgl_dedup_counts`;
//   * K5 `_dedup_cached_kernel` (:608, the apply with cached counts) and K6
//     `_dedup_kernel` (:405, the apply with C rebuilt from the pair's edges
//     on every call; unweighted, or weighted: the TPU path's
//     `spmm_dedup_weighted`, where C[r, c] is the sum of the cell's edge
//     weights): `pgl_dedup_apply_f32`, one kernel templated on where C
//     comes from. Everything after C is the same code, so K5 and K6 give
//     identical bits wherever the cached counts are exact.
//
// What bounds it on this card. K4 is bound by the bytes of the counts it
// writes (2 B a cell, 64 KB a pair). The apply's useful work is small (on
// the bench headline 1.6-2.2% of the count cells are nonzero), so its
// floor is bytes: the counts (K5) or the edges (K6), the window rows, out.
// Done densely in float32 FFMA (the first port) it cost 2*256*128*D
// operations a pair and took 4x `torch.sparse.mm`. Here the product runs
// on the tensor cores and skips what is zero, and what is left is issue:
// the MMAs (with the ldmatrix loads that feed them), splitting the window,
// the gather, the output store, which the warps of a block run one after
// the other (they meet at a barrier each stage). The design cuts each:
//   * `mma.sync` m16n8k16, bf16 operands, f32 accumulators. A is C in bf16
//     (counts up to 256 are exact). B is the window's rows split once per
//     window, in shared memory, into three bf16 planes hi = bf16(x), mid =
//     bf16(x - hi), lo = bf16(x - hi - mid): x = hi + mid + lo exactly for
//     a normal float32, every product count * plane is exact, so the only
//     rounding is the f32 accumulation, three MMAs a tile (lo, mid, hi),
//     as in an FFMA loop. Weighted sums and counts above 256 keep C in
//     float32; each warp splits its own A fragment the same way in
//     registers (no warp reads another's rows of A), and the six products
//     above 2^-24 of the largest are taken (A_lo*B_hi, A_mid*B_mid,
//     A_hi*B_lo, A_mid*B_hi, A_hi*B_mid, A_hi*B_hi). The three dropped
//     (mid*lo, lo*mid, lo*lo) are each below 2^-24 |a||x|, so a product's
//     error is below 2^-23 |a||x|, against the 1e-4 * max(1, |sum|,
//     ||terms||_2) every check holds it to;
//   * a warp owns 16 rows of the dst block and skips a k-step (16 window
//     rows) whose 16x16 tile of C is all zero, or runs m16n8k8 on the one
//     16x8 half that is not (on the headline 54% / 71% of the 16x16 tiles
//     and 38% / 52% of the 16x8 ones hold a count, CSC / CSR): the test is
//     a warp vote on the A fragment it loaded anyway, so no mask is stored;
//   * one CUDA block of 16 warps covers a group's whole dst block (256
//     rows), so the window is gathered and split once a pair, at the whole
//     width D <= 128, the accumulators in registers (D/2 a thread): C is
//     read (K5) or built (K6) once a pair, not once a column tile. Wider D
//     walks 128-column tiles with C kept in shared memory, and adds each
//     pair's tile into the output (no atomics: the block owns it);
//   * the window rows are a gather through uv (TMA has no row gather), by
//     `cp.async` 16 bytes a thread (4 when D % 4 != 0), 32 columns a stage,
//     issued a stage ahead, from row ids brought into shared memory a pair
//     ahead; K5's C for the next pair comes with its first stage, into the
//     second of two buffers. C sits unpadded, its 16- or 32-byte chunks
//     swizzled by the row. K6 builds C between pairs from the edges in
//     chunks: a cell's edges are contiguous (`build_dedup_layout` keeps
//     them so), and the thread at a run's first edge counts or sums it
//     (weights in edge order, no atomics);
//   * the output tile leaves through shared memory, as each warp's rows
//     in one contiguous span, 16 bytes a lane (the MMA fragments' own
//     stores would fill each 32-byte sector 8 bytes at a time);
//   * groups run in parallel, so a dst block of several groups (the
//     headline's hub block has 1,024 pairs) writes one partial per group,
//     and a second launch sums them in group order, eight slots' loads at
//     a time. No float atomics and a fixed MMA order, so every run gives
//     the same bits;
//   * a window that runs past its block's unique run reads the next
//     block's rows (or the uv tail), whose counts are 0.
//
// On bf16 tables (`pgl_dedup_apply_bf16`, the library dedup_kernels_bf16:
// this source built with -DPGL_BF16; K5, K6 and the weighted K6, which
// replace the same TPU kernels on bf16, whose output takes the table's
// dtype, `:674`, `:759`) a bf16 row is its own hi plane: mid and lo are
// zero. So `dedup_apply_bf16` stages the gathered bf16 rows as they are,
// by cp.async 16 bytes (8 columns) a thread, straight into the plane the
// MMAs read (two stages' planes, the one in flight and the one read), with
// no float staging buffer and no split, and runs one m16n8k16 MMA a tile
// on bf16 C (exact counts up to 256); where C is float (the weighted form,
// or counts above 256) A keeps its split, three products A_lo*B, A_mid*B,
// A_hi*B, each exact. The window takes 20 KB of shared memory where the
// float32 kernel's takes 46 KB (at 32 columns a stage), and a tile one MMA
// where it takes three (three where it takes six, on float C). What bounds
// it is still bytes, now with bf16 rows: half the window gather and half
// the output of the float32 kernel. The sums are f32; each stored value is
// rounded once to bf16 (nearest even): a block of one group stores its
// rows rounded, a split block's groups store f32 partials that the combine
// sums in group order and rounds. So that the accumulators hold a row's
// whole sum, a launch covers at most one 128-column tile: wider D runs one
// launch a tile (K5 reloads, K6 rebuilds C in each), never a running sum
// of rounded tiles in memory.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes `out` [n_pad, D] and `partials`
// [n_partials*256, D], f32 either way), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kNB = 256;        // dst rows per block
constexpr int kW = 128;         // unique rows per window
constexpr int kHalf = 128;      // K4: dst rows per CUDA block
constexpr int kLdc = kW + 1;    // K4: row stride of the int counts (words)
constexpr int kThreads = 256;   // K4: a block a (pair, half)
constexpr int kApplyThreads = 512;  // K5, K6: 16 warps, 16 rows each
constexpr int kCombineWarps = 8;
constexpr int kCountsMax = 256; // largest count bf16 holds exactly here

using bf16 = __nv_bfloat16;

// pairs: int4 (blk, wb, start, end); groups: int4 (blk, p0, p1, slot)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lane l names row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two 8x8 bf16 matrices, transposed; lanes 0-15 name the rows
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a (16x8, row) * b (8x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate; not
// volatile, so the compiler interleaves independent accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K4: one CUDA block per (pair, half): C_p's rows [h*128, h*128 + 128) as
// int32 in shared memory ([128][kLdc]; integer sums agree in any order),
// then as bf16.
__global__ void __launch_bounds__(kThreads)
dedup_counts(const int4* __restrict__ pairs, const int* __restrict__ dst,
             const int* __restrict__ urow, bf16* __restrict__ counts) {
  extern __shared__ int cnt[];
  const int p = blockIdx.x;
  const int h = blockIdx.y;
  const int4 pr = pairs[p];
  for (int i = threadIdx.x; i < kHalf * kLdc; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int row0 = pr.x * kNB + h * kHalf;
  for (int e = pr.z + threadIdx.x; e < pr.w; e += kThreads) {
    const int r = __ldg(dst + e) - row0;
    if (static_cast<unsigned>(r) < static_cast<unsigned>(kHalf))
      atomicAdd(cnt + r * kLdc + (__ldg(urow + e) - pr.y), 1);
  }
  __syncthreads();
  bf16* o = counts + (static_cast<size_t>(p) * kNB + h * kHalf) * kW;
  for (int i = threadIdx.x; i < kHalf * kW; i += kThreads)
    o[i] = __float2bfloat16(static_cast<float>(cnt[(i / kW) * kLdc + i % kW]));
}

// Where C comes from: K5's cached counts, K6's counts, K6's weights.
enum Mode { kCached = 0, kCount = 1, kWeighted = 2 };

// C in shared memory, one dst block [256][128], rows of 16-byte (bf16) or
// 32-byte (float) chunks XOR-swizzled by the row, so that the rows one
// ldmatrix or one fragment load reads fall in distinct banks.
__device__ __forceinline__ int cb_at(int r, int c) {  // bf16 C
  return r * kW + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}
__device__ __forceinline__ int cf_at(int r, int c) {  // float C
  return r * kW + (((c >> 3) ^ (r & 3)) << 3) + (c & 7);
}

// v = hi + mid + lo for two floats, each plane as a bf16 pair
__device__ __forceinline__ void split3x2(float2 v, uint32_t& hi, uint32_t& mid,
                                         uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(v);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __float22bfloat162_rn(r);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __float22bfloat162_rn(make_float2(r.x - mf.x, r.y - mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// a weight as f32
__device__ __forceinline__ float ld_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_w(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

// an f32 value stored as float, or as bf16 rounded once to nearest even
__device__ __forceinline__ void st_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_as(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K6: C_p [256][128]: each cell its edge count, or the float32 sum in
// edge order of its edges' weights w[edge_id[e]]; bf16 (counts up to 256,
// exact) or float (FA). A cell's edges are contiguous in the layout, so no
// atomics: the pair's edges go in chunks of kBuildChunk, every thread
// loads its edges' cells and values at once into `scratch` (8 B an edge),
// then the thread at the first edge of each run of one cell sums the run
// in order from shared memory, carrying a run that crosses into the next
// chunk. Ends with a barrier.
constexpr int kBuildChunk = 4 * kApplyThreads;

template <int MODE, bool FA, typename TW>
__device__ __forceinline__ void build_c(void* c, int4 pr,
                                        const int* __restrict__ dst,
                                        const int* __restrict__ urow,
                                        const int* __restrict__ edge_id,
                                        const TW* __restrict__ w,
                                        void* scratch) {
  constexpr int kBytes = kNB * kW * (FA ? 4 : 2);
  uint4* z = static_cast<uint4*>(c);
  for (int i = threadIdx.x; i < kBytes / 16; i += kApplyThreads)
    z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int row0 = pr.x * kNB;
  constexpr int K = kBuildChunk / kApplyThreads;
  int* key = static_cast<int*>(scratch);           // [kBuildChunk] cell
  float* val = reinterpret_cast<float*>(key + kBuildChunk);
  __shared__ int carry_key[2];
  __shared__ float carry_val[2];
  if (threadIdx.x == 0) carry_key[1] = -1;
  for (int c0 = pr.z, it = 0; c0 < pr.w; c0 += kBuildChunk, ++it) {
    const int n = min(kBuildChunk, pr.w - c0);
    int kk[K];
    float vv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = c0 + threadIdx.x + k * kApplyThreads;
      kk[k] = -1;
      vv[k] = 1.f;
      if (e < pr.w) {  // the pair's edges all lie in its block and window
        const int r = __ldg(dst + e) - row0;
        const int u = __ldg(urow + e) - pr.y;
        if constexpr (MODE == kWeighted) vv[k] = ld_w(w + __ldg(edge_id + e));
        kk[k] = FA ? cf_at(r, u) : cb_at(r, u);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      key[threadIdx.x + k * kApplyThreads] = kk[k];
      val[threadIdx.x + k * kApplyThreads] = vv[k];
    }
    if (threadIdx.x == 0) carry_key[it & 1] = -1;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kApplyThreads;
      const int kc = kk[k];
      if (i >= n || (i > 0 && key[i - 1] == kc)) continue;
      // a run's first edge in this chunk: its cell's sum so far, if the
      // run began in the chunk before
      float sum = i == 0 && carry_key[(it + 1) & 1] == kc
                      ? carry_val[(it + 1) & 1]
                      : 0.f;
      int j = i;
      for (; j < n && key[j] == kc; ++j) sum += val[j];
      if constexpr (FA) {
        static_cast<float*>(c)[kc] = sum;
      } else {
        static_cast<bf16*>(c)[kc] = __float2bfloat16_rn(sum);
      }
      if (j == n) {
        carry_key[it & 1] = kc;
        carry_val[it & 1] = sum;
      }
    }
    __syncthreads();
  }
}

// What a block of the apply keeps in shared memory.
template <int MODE, bool FA, int DT>
struct ApplyShape {
  static constexpr int CW = DT < 32 ? DT : 32;  // columns a stage gathers
  static constexpr int CPT = DT / CW;           // stages a column tile
  static constexpr int PS = CW + 8;             // B plane row stride (bf16)
  // C buffers: K5 loads a pair's C with its first stage, a stage early
  static constexpr int NCB = MODE == kCached ? 2 : 1;
  static constexpr size_t kCBytes = size_t{NCB} * kNB * kW * (FA ? 4 : 2);
  static constexpr size_t kRawBytes = sizeof(float) * kW * CW;  // a stage
  static constexpr size_t kPlaneBytes = sizeof(bf16) * 3 * kW * PS;
  static constexpr size_t kIdBytes = sizeof(int) * 2 * kW;  // row id ring
  static constexpr size_t kPartBytes =
      kCBytes + kRawBytes + kPlaneBytes + kIdBytes;
  // the last flush stages the output tile in the same space
  static constexpr size_t kFlushBytes = sizeof(float) * kNB * (DT + 8);
  static constexpr size_t kSmem =
      kPartBytes > kFlushBytes ? kPartBytes : kFlushBytes;
  // K6's build borrows the planes' space between stages
  static_assert(kPlaneBytes >= 8 * kBuildChunk, "build scratch");
};

// This warp's A fragment of k-step ks (its 16 rows, 16 window rows) as
// bf16 planes: a[0] only from bf16 C, a[0..2] = hi, mid, lo from float C.
// Returns which of the two 16x8 halves (bit 0: window rows 0-7 of the
// step, bit 1: 8-15) hold a nonzero count; with 0 the planes are unset.
template <bool FA>
__device__ __forceinline__ int load_a(uint32_t (&a)[FA ? 3 : 1][4],
                                      const void* c, int warp, int lane,
                                      int ks) {
  if constexpr (!FA) {
    const int r = warp * 16 + (lane & 15);
    ldsm_x4(a[0], static_cast<const bf16*>(c) +
                      cb_at(r, ks * 16 + (lane >> 4) * 8));
    return (__any_sync(0xffffffffu, (a[0][0] | a[0][1]) != 0u) ? 1 : 0) |
           (__any_sync(0xffffffffu, (a[0][2] | a[0][3]) != 0u) ? 2 : 0);
  } else {
    const float* cf = static_cast<const float*>(c);
    const int r = warp * 16 + (lane >> 2);
    const int k = ks * 16 + 2 * (lane & 3);
    // the mma A order: (r, k), (r + 8, k), (r, k + 8), (r + 8, k + 8)
    float2 v[4];
    v[0] = *reinterpret_cast<const float2*>(cf + cf_at(r, k));
    v[1] = *reinterpret_cast<const float2*>(cf + cf_at(r + 8, k));
    v[2] = *reinterpret_cast<const float2*>(cf + cf_at(r, k + 8));
    v[3] = *reinterpret_cast<const float2*>(cf + cf_at(r + 8, k + 8));
    const auto nz = [](float2 u) { return u.x != 0.f || u.y != 0.f; };
    const int m = (__any_sync(0xffffffffu, nz(v[0]) || nz(v[1])) ? 1 : 0) |
                  (__any_sync(0xffffffffu, nz(v[2]) || nz(v[3])) ? 2 : 0);
    if (m == 0) return 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) split3x2(v[i], a[0][i], a[1][i], a[2][i]);
    return m;
  }
}

// Product i of a tile: A plane pa(i) times B plane pb(i) (0 hi, 1 mid,
// 2 lo), smallest first; BP B planes (3 of a split float row, 1 of a bf16
// row, its own hi plane).
template <bool FA, int BP>
__host__ __device__ constexpr int pa(int i) {
  return !FA ? 0 : BP == 1 ? 2 - i : (i == 0 ? 2 : i == 1 || i == 3 ? 1 : 0);
}
template <bool FA, int BP>
__host__ __device__ constexpr int pb(int i) {
  return BP == 1 ? 0
         : FA ? (i == 0 || i == 3 ? 0 : i == 1 || i == 4 ? 1 : i == 2 ? 2 : 0)
              : 2 - i;
}

// This warp's MMAs for one stage: its 16 rows of C times the stage's CW
// columns of B (BP planes, `planes`), into the accumulators of column
// chunk J of the tile. A k-step whose 16x16 tile of C is zero is skipped;
// one with a single nonzero 16x8 half runs m16n8k8 on that half only.
// The products go in a fixed order, smallest first.
template <bool FA, int BP, int DT, int CW, int PS, int J>
__device__ __forceinline__ void mma_stage(float (&acc)[DT / 8][4],
                                          const void* c, const bf16* planes,
                                          int warp, int lane) {
  constexpr int NT = CW / 8;  // n-tiles of the stage, acc[J * NT + n]
  // products a tile: six of split float C by three B planes, three of
  // bf16 C by them; three of split float C by one plane, one of bf16 C
  constexpr int NP = BP == 3 ? (FA ? 6 : 3) : (FA ? 3 : 1);
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks) {
    uint32_t a[FA ? 3 : 1][4];
    const int m = load_a<FA>(a, c, warp, lane, ks);
    if (m == 3) {
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t b[BP][4];  // regs {0,1} n-tile 2nn, {2,3} 2nn + 1
#pragma unroll
        for (int q = 0; q < BP; ++q)
          ldsm_x4_t(b[q], planes + q * kW * PS + (ks * 16 + (lane & 15)) * PS +
                              nn * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          mma_bf16(acc[J * NT + 2 * nn], a[pa<FA, BP>(i)],
                   b[pb<FA, BP>(i)][0], b[pb<FA, BP>(i)][1]);
          mma_bf16(acc[J * NT + 2 * nn + 1], a[pa<FA, BP>(i)],
                   b[pb<FA, BP>(i)][2], b[pb<FA, BP>(i)][3]);
        }
      }
    } else if (m != 0) {
      const int kh = m == 1 ? 0 : 1;  // the nonzero 16x8 half
      // B rows ks*16 + 8kh .. +7 of all NT n-tiles, one register each
      uint32_t b[BP][NT];
#pragma unroll
      for (int q = 0; q < BP; ++q) {
        const bf16* bp = planes + q * kW * PS +
                         (ks * 16 + 8 * kh + (lane & 7)) * PS + (lane >> 3) * 8;
        if constexpr (NT == 4) {
          ldsm_x4_t(b[q], bp);
        } else {
          ldsm_x2_t(b[q], bp);
        }
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const uint32_t* ai = a[pa<FA, BP>(i)];
        const uint32_t a0 = kh ? ai[2] : ai[0], a1 = kh ? ai[3] : ai[1];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_k8(acc[J * NT + n], a0, a1, b[pb<FA, BP>(i)][n]);
      }
    }
  }
}

// K5 and K6: one CUDA block per (group, half), the two halves of a group
// next to each other in launch order (they gather the same window rows).
// Stage s is (pair, column tile of DT, chunk of CW); its window rows (and
// for K5 its pair's C, into a ring of two) arrive by cp.async during the
// stage before.
template <int MODE, bool FA, int DT>
__global__ void __launch_bounds__(kApplyThreads, 1)
dedup_apply(const float* __restrict__ x, const int* __restrict__ uv,
            const int4* __restrict__ pairs, const int4* __restrict__ groups,
            const int* __restrict__ dst, const int* __restrict__ urow,
            const bf16* __restrict__ counts, const int* __restrict__ edge_id,
            const float* __restrict__ w, int D, float* __restrict__ out,
            float* __restrict__ partials) {
  using S = ApplyShape<MODE, FA, DT>;
  constexpr int CW = S::CW, CPT = S::CPT, PS = S::PS, NCB = S::NCB;
  constexpr size_t kCOne = S::kCBytes / NCB;  // bytes of one C buffer
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* cbuf = smem;                                 // [NCB] C
  float* raw = reinterpret_cast<float*>(smem + S::kCBytes);  // [kW][CW]
  bf16* planes = reinterpret_cast<bf16*>(smem + S::kCBytes + S::kRawBytes);
  // uv of pair q's window at (q % 2) * kW
  int* ids = reinterpret_cast<int*>(smem + S::kCBytes + S::kRawBytes +
                                    S::kPlaneBytes);

  const int4 gr = groups[blockIdx.x];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (D + DT - 1) / DT;
  const int per_pair = n_tiles * CPT;
  const int n_stages = (gr.z - gr.y) * per_pair;
  const bool vec = (D & 3) == 0;

  // 16-byte copies a thread a stage (D % 4 == 0), 4-byte ones otherwise
  constexpr int KV = kW * CW / 4 / kApplyThreads;
  constexpr int KS = kW * CW / kApplyThreads;
  // the window rows of stage s into the staging buffer, by cp.async
  // as one group (an empty one past the last stage), their sources read
  // from `ids`; with a pair's first stage, for K5 its C, and the row ids
  // of the next pair, whose first window row is `wb_next`
  auto issue = [&](int s, int wb_next) {
    if (s >= n_stages) {
      cp_async_commit();
      return;
    }
    const int q = s / per_pair;
    const int rem = s - q * per_pair;
    const int p = gr.y + q;
    const int col0 = (rem / CPT) * DT + (rem % CPT) * CW;
    const int* id = ids + (q & 1) * kW;
    if (vec) {
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int i = threadIdx.x + k * kApplyThreads;
        const int col = col0 + 4 * (i % (CW / 4));
        const float* row = x + static_cast<size_t>(id[i / (CW / 4)]) * D;
        cp_async16(raw + 4 * i, col < D ? row + col : row, col < D);
      }
    } else {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int i = threadIdx.x + k * kApplyThreads;
        const int col = col0 + i % CW;
        const float* row = x + static_cast<size_t>(id[i / CW]) * D;
        cp_async4(raw + i, col < D ? row + col : row, col < D);
      }
    }
    if (rem == 0) {
      if (p + 1 < gr.z && threadIdx.x < kW / 4)
        cp_async16(ids + ((q + 1) & 1) * kW + 4 * threadIdx.x,
                   uv + wb_next + 4 * threadIdx.x, true);
      if constexpr (MODE == kCached) {
        bf16* cb = reinterpret_cast<bf16*>(cbuf + (q % NCB) * kCOne);
        const bf16* src =
            counts + static_cast<size_t>(p) * kNB * kW;
        for (int i = threadIdx.x; i < kNB * kW / 8; i += kApplyThreads) {
          const int r8 = i / (kW / 8);
          const int c8 = 8 * (i % (kW / 8));
          cp_async16(cb + cb_at(r8, c8), src + r8 * kW + c8, true);
        }
      }
    }
    cp_async_commit();
  };
  // the first window row of the pair after the one stage s belongs to,
  // when stage s is its pair's first (read a stage early)
  auto wb_after = [&](int s) {
    const int q = s / per_pair;
    return s < n_stages && s == q * per_pair && gr.y + q + 1 < gr.z
               ? __ldg(&pairs[gr.y + q + 1].y)
               : 0;
  };

  float acc[DT / 8][4];
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  // this warp's 16 rows of the block's output (or partial slot)
  float* const base =
      (gr.w < 0 ? out + static_cast<size_t>(gr.x) * kNB * D
                : partials + static_cast<size_t>(gr.w) * kNB * D) +
      static_cast<size_t>(warp * 16) * D;
  // D > DT: this thread's accumulators added into column tile t of its two
  // rows, or stored there when `first`; 8 bytes a store where D is even
  auto flush_tile = [&](int t, bool first) {
    float* o0 = base + static_cast<size_t>(lane >> 2) * D;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n) {
      const int col = t * DT + n * 8 + 2 * (lane & 3);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* o = o0 + static_cast<size_t>(8 * rr) * D + col;
        const float v0 = acc[n][2 * rr], v1 = acc[n][2 * rr + 1];
        if ((D & 1) == 0 && col < D) {
          float2 v = make_float2(v0, v1);
          if (!first) {
            const float2 u = *reinterpret_cast<const float2*>(o);
            v = make_float2(u.x + v0, u.y + v1);
          }
          *reinterpret_cast<float2*>(o) = v;
        } else {
          if (col < D) o[0] = first ? v0 : o[0] + v0;
          if (col + 1 < D) o[1] = first ? v1 : o[1] + v1;
        }
      }
    }
  };
  // D <= DT, after the last stage (all of shared memory free): the warp's
  // 16 x D tile through shared memory, then out as one span, 16 bytes a
  // lane where D % 4 == 0 (the fragments' own stores would fill each
  // 32-byte sector 8 bytes at a time)
  auto flush_rows = [&]() {
    constexpr int LD = DT + 8;  // row stride (floats): 2-way on float2
    float* t = reinterpret_cast<float*>(smem) + warp * 16 * LD;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(t + ((lane >> 2) + 8 * rr) * LD + n * 8 +
                                   2 * (lane & 3)) =
            make_float2(acc[n][2 * rr], acc[n][2 * rr + 1]);
    __syncwarp();
    // the 16 rows are one contiguous span of 16 * D floats
    if (vec) {
      for (int i = 4 * lane; i < 16 * D; i += 128) {
        const int r = i / D;
        *reinterpret_cast<float4*>(base + i) =
            *reinterpret_cast<const float4*>(t + r * LD + (i - r * D));
      }
    } else {
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = i / D;
        base[i] = t[r * LD + (i - r * D)];
      }
    }
  };

  if (threadIdx.x < kW) ids[threadIdx.x] = __ldg(uv + pairs[gr.y].y + threadIdx.x);
  __syncthreads();
  issue(0, wb_after(0));
  for (int s = 0; s < n_stages; ++s) {
    const int wb_next = wb_after(s + 1);
    const int q = s / per_pair;
    const int rem = s - q * per_pair;
    const int j = rem % CPT;
    const void* cs = cbuf + (q % NCB) * kCOne;
    if constexpr (MODE != kCached) {
      if (rem == 0)
        build_c<MODE, FA, float>(cbuf, pairs[gr.y + q], dst, urow, edge_id,
                                 w, planes);
    }
    cp_async_wait_all();  // stage s's rows (and C)
    __syncthreads();
    // split the staged rows into the three bf16 planes, once per window
    const float4* st = reinterpret_cast<const float4*>(raw);
    for (int i = threadIdx.x; i < kW * CW / 4; i += kApplyThreads) {
      const int c = i / (CW / 4);
      const int c4 = 4 * (i % (CW / 4));
      const float4 v = st[i];
      uint2 hi, mid, lo;
      split3x2(make_float2(v.x, v.y), hi.x, mid.x, lo.x);
      split3x2(make_float2(v.z, v.w), hi.y, mid.y, lo.y);
      bf16* o = planes + c * PS + c4;
      *reinterpret_cast<uint2*>(o) = hi;
      *reinterpret_cast<uint2*>(o + kW * PS) = mid;
      *reinterpret_cast<uint2*>(o + 2 * kW * PS) = lo;
    }
    __syncthreads();
    issue(s + 1, wb_next);
    if constexpr (CPT == 4) {
      if (j == 0)
        mma_stage<FA, 3, DT, CW, PS, 0>(acc, cs, planes, warp, lane);
      else if (j == 1)
        mma_stage<FA, 3, DT, CW, PS, 1>(acc, cs, planes, warp, lane);
      else if (j == 2)
        mma_stage<FA, 3, DT, CW, PS, 2>(acc, cs, planes, warp, lane);
      else
        mma_stage<FA, 3, DT, CW, PS, 3>(acc, cs, planes, warp, lane);
    } else if constexpr (CPT == 2) {
      if (j == 0)
        mma_stage<FA, 3, DT, CW, PS, 0>(acc, cs, planes, warp, lane);
      else
        mma_stage<FA, 3, DT, CW, PS, 1>(acc, cs, planes, warp, lane);
    } else {
      mma_stage<FA, 3, DT, CW, PS, 0>(acc, cs, planes, warp, lane);
    }
    if (n_tiles > 1 && j == CPT - 1) {
      flush_tile(rem / CPT, q == 0);
#pragma unroll
      for (int n = 0; n < DT / 8; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
    }
    __syncthreads();
  }
  if (n_tiles == 1) flush_rows();
}

// What a block of the bf16 apply keeps in shared memory: C as the float32
// kernel's; two stages' window rows as they were gathered (bf16, each its
// own B plane: the stage in flight and the one the MMAs read); the row id
// ring; K6's build scratch (the float32 kernel borrows its planes' space
// for it, which two bf16 stages do not always hold).
template <int MODE, bool FA, int DT>
struct ApplyShapeB {
  static constexpr int CW = DT < 32 ? DT : 32;  // columns a stage gathers
  static constexpr int CPT = DT / CW;           // stages a column tile
  static constexpr int PS = CW + 8;             // plane row stride (bf16)
  static constexpr int NCB = MODE == kCached ? 2 : 1;
  static constexpr size_t kCBytes = size_t{NCB} * kNB * kW * (FA ? 4 : 2);
  static constexpr size_t kPlaneBytes = sizeof(bf16) * 2 * kW * PS;
  static constexpr size_t kIdBytes = sizeof(int) * 2 * kW;
  static constexpr size_t kScratchBytes =
      MODE == kCached ? 0 : 8 * kBuildChunk;
  static constexpr size_t kPartBytes =
      kCBytes + kPlaneBytes + kIdBytes + kScratchBytes;
  static constexpr size_t kFlushBytes = sizeof(float) * kNB * (DT + 8);
  static constexpr size_t kSmem =
      kPartBytes > kFlushBytes ? kPartBytes : kFlushBytes;
};

// K5 and K6 on bf16 tables, over the columns [c0, c0 + DT) of x (at most
// one column tile a launch, so the accumulators hold each row's whole sum
// over the group's pairs): the float32 kernel's pairs, groups, C and MMAs,
// but stage s's window rows arrive by cp.async as bf16 straight into plane
// s % 2, which the MMAs read as B with no split. A block of one group
// stores its rows as bf16 (rounded once), a split block's group its f32
// partial rows.
template <int MODE, bool FA, int DT>
__global__ void __launch_bounds__(kApplyThreads, 1)
dedup_apply_bf16(const bf16* __restrict__ x, const int* __restrict__ uv,
                 const int4* __restrict__ pairs,
                 const int4* __restrict__ groups, const int* __restrict__ dst,
                 const int* __restrict__ urow,
                 const bf16* __restrict__ counts,
                 const int* __restrict__ edge_id,
                 const bf16* __restrict__ w, int D, int c0,
                 bf16* __restrict__ out, float* __restrict__ partials) {
  using S = ApplyShapeB<MODE, FA, DT>;
  constexpr int CW = S::CW, CPT = S::CPT, PS = S::PS, NCB = S::NCB;
  constexpr size_t kCOne = S::kCBytes / NCB;  // bytes of one C buffer
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* cbuf = smem;                                    // [NCB] C
  bf16* planes = reinterpret_cast<bf16*>(smem + S::kCBytes);    // [2][kW][PS]
  int* ids = reinterpret_cast<int*>(smem + S::kCBytes + S::kPlaneBytes);
  void* scratch = smem + S::kCBytes + S::kPlaneBytes + S::kIdBytes;

  const int4 gr = groups[blockIdx.x];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int width = min(DT, D - c0);  // this launch's columns
  const int n_stages = (gr.z - gr.y) * CPT;
  const bool vec =
      (D & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // the window rows of stage s into plane s % 2: cp.async 16 bytes (8
  // columns) a copy where rows allow, else plain loads; with a pair's
  // first stage, for K5 its C and the row ids of the next pair (as the
  // float32 kernel's `issue`), all one commit group
  auto issue = [&](int s, int wb_next) {
    if (s >= n_stages) {
      cp_async_commit();
      return;
    }
    const int q = s / CPT;
    const int j = s - q * CPT;
    const int p = gr.y + q;
    const int col0 = j * CW;  // of the launch's columns
    const int* id = ids + (q & 1) * kW;
    bf16* pl = planes + (s & 1) * kW * PS;
    if (vec) {
      for (int i = threadIdx.x; i < kW * CW / 8; i += kApplyThreads) {
        const int c = i / (CW / 8);
        const int cc = 8 * (i % (CW / 8));
        const bf16* row = x + static_cast<size_t>(id[c]) * D + c0;
        const bool ok = col0 + cc < width;
        cp_async16(pl + c * PS + cc, ok ? row + col0 + cc : row, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kW * CW; i += kApplyThreads) {
        const int c = i / CW;
        const int cc = i % CW;
        pl[c * PS + cc] =
            col0 + cc < width
                ? x[static_cast<size_t>(id[c]) * D + c0 + col0 + cc]
                : __float2bfloat16_rn(0.f);
      }
    }
    if (j == 0) {
      if (p + 1 < gr.z && threadIdx.x < kW / 4)
        cp_async16(ids + ((q + 1) & 1) * kW + 4 * threadIdx.x,
                   uv + wb_next + 4 * threadIdx.x, true);
      if constexpr (MODE == kCached) {
        bf16* cb = reinterpret_cast<bf16*>(cbuf + (q % NCB) * kCOne);
        const bf16* src = counts + static_cast<size_t>(p) * kNB * kW;
        for (int i = threadIdx.x; i < kNB * kW / 8; i += kApplyThreads) {
          const int r8 = i / (kW / 8);
          const int c8 = 8 * (i % (kW / 8));
          cp_async16(cb + cb_at(r8, c8), src + r8 * kW + c8, true);
        }
      }
    }
    cp_async_commit();
  };
  auto wb_after = [&](int s) {
    const int q = s / CPT;
    return s < n_stages && s == q * CPT && gr.y + q + 1 < gr.z
               ? __ldg(&pairs[gr.y + q + 1].y)
               : 0;
  };

  float acc[DT / 8][4];
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  if (threadIdx.x < kW)
    ids[threadIdx.x] = __ldg(uv + pairs[gr.y].y + threadIdx.x);
  __syncthreads();
  issue(0, wb_after(0));
  for (int s = 0; s < n_stages; ++s) {
    const int wb_next = wb_after(s + 1);
    const int q = s / CPT;
    const int j = s - q * CPT;
    const void* cs = cbuf + (q % NCB) * kCOne;
    if constexpr (MODE != kCached) {
      if (j == 0)
        build_c<MODE, FA, bf16>(cbuf, pairs[gr.y + q], dst, urow, edge_id,
                                w, scratch);
    }
    cp_async_wait_all();  // stage s's rows (and C)
    __syncthreads();
    issue(s + 1, wb_next);  // into the other plane, read a stage ago
    const bf16* pl = planes + (s & 1) * kW * PS;
    if constexpr (CPT == 4) {
      if (j == 0)
        mma_stage<FA, 1, DT, CW, PS, 0>(acc, cs, pl, warp, lane);
      else if (j == 1)
        mma_stage<FA, 1, DT, CW, PS, 1>(acc, cs, pl, warp, lane);
      else if (j == 2)
        mma_stage<FA, 1, DT, CW, PS, 2>(acc, cs, pl, warp, lane);
      else
        mma_stage<FA, 1, DT, CW, PS, 3>(acc, cs, pl, warp, lane);
    } else if constexpr (CPT == 2) {
      if (j == 0)
        mma_stage<FA, 1, DT, CW, PS, 0>(acc, cs, pl, warp, lane);
      else
        mma_stage<FA, 1, DT, CW, PS, 1>(acc, cs, pl, warp, lane);
    } else {
      mma_stage<FA, 1, DT, CW, PS, 0>(acc, cs, pl, warp, lane);
    }
    __syncthreads();  // C and this plane are free for the next stage
  }

  // the warp's 16 x width tile through shared memory (all of it free),
  // then out: bf16 rows (16 bytes, 8 columns a lane, where the widths
  // allow) or f32 partial rows (16 bytes, 4 columns)
  constexpr int LD = DT + 8;
  float* t = reinterpret_cast<float*>(smem) + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(t + ((lane >> 2) + 8 * rr) * LD + n * 8 +
                                 2 * (lane & 3)) =
          make_float2(acc[n][2 * rr], acc[n][2 * rr + 1]);
  __syncwarp();
  const size_t row0 = static_cast<size_t>(gr.w < 0 ? gr.x : gr.w) * kNB +
                      warp * 16;
  if (gr.w < 0) {
    bf16* o = out + row0 * D + c0;
    if ((width & 7) == 0 && (D & 7) == 0) {
      for (int i = 8 * lane; i < 16 * width; i += 256) {
        const int r = i / width;
        const int c = i - r * width;
        const float4 a = *reinterpret_cast<const float4*>(t + r * LD + c);
        const float4 b = *reinterpret_cast<const float4*>(t + r * LD + c + 4);
        const __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                                     __floats2bfloat162_rn(a.z, a.w),
                                     __floats2bfloat162_rn(b.x, b.y),
                                     __floats2bfloat162_rn(b.z, b.w)};
        unsigned u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          u[k] = *reinterpret_cast<const unsigned*>(&h[k]);
        *reinterpret_cast<uint4*>(o + r * D + c) =
            make_uint4(u[0], u[1], u[2], u[3]);
      }
    } else {
      for (int i = lane; i < 16 * width; i += 32) {
        const int r = i / width;
        const int c = i - r * width;
        o[r * D + c] = __float2bfloat16_rn(t[r * LD + c]);
      }
    }
  } else {
    float* o = partials + row0 * D + c0;
    if ((width & 3) == 0 && (D & 3) == 0) {
      for (int i = 4 * lane; i < 16 * width; i += 128) {
        const int r = i / width;
        const int c = i - r * width;
        *reinterpret_cast<float4*>(o + r * D + c) =
            *reinterpret_cast<const float4*>(t + r * LD + c);
      }
    } else {
      for (int i = lane; i < 16 * width; i += 32) {
        const int r = i / width;
        const int c = i - r * width;
        o[r * D + c] = t[r * LD + c];
      }
    }
  }
}

// One CUDA block per (split dst block, 8 of its rows): warp w sums row
// r0 + w of the block's partial slots in slot order, loading eight slots
// at once (a hub block has over a hundred), and stores it as T (bf16:
// rounded once).
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
dedup_combine(const float* __restrict__ partials,
              const int* __restrict__ split_blocks,
              const int* __restrict__ split_ptr, int D,
              T* __restrict__ out) {
  constexpr int U = 8;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kCombineWarps + w;
  const int s0 = split_ptr[blockIdx.x];
  const int s1 = split_ptr[blockIdx.x + 1];
  const size_t slot = static_cast<size_t>(kNB) * D;  // a slot's stride
  const float* p = partials + (static_cast<size_t>(s0) * kNB + r) * D;
  T* o = out + (static_cast<size_t>(split_blocks[blockIdx.x]) * kNB + r) * D;
  for (int col = lane; col < D; col += 32) {
    float acc = 0.f;
    int s = s0;
    for (; s + U <= s1; s += U) {
      float v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) v[k] = __ldg(p + (s - s0 + k) * slot + col);
#pragma unroll
      for (int k = 0; k < U; ++k) acc += v[k];
    }
    for (; s < s1; ++s) acc += __ldg(p + (s - s0) * slot + col);
    st_as(o + col, acc);
  }
}

constexpr size_t kCountsSmem = sizeof(int) * kHalf * kLdc;

// The shared-memory attribute each kernel needs above 48 KB, set once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

// The apply's arguments on tables of T (float, or bf16 for the bf16
// kernel); partials f32 either way.
template <typename T>
struct ApplyArgs {
  const T* x;
  const int* uv;
  const int4* pairs;
  const int4* groups;
  const int* dst;
  const int* urow;
  const bf16* counts;
  const int* edge_id;
  const T* w;
  int D;
  T* out;
  float* partials;
};

template <int MODE, bool FA, int DT>
cudaError_t launch_apply(int n_groups, cudaStream_t s,
                         const ApplyArgs<float>& a) {
  static bool ready = false;
  const auto kernel = dedup_apply<MODE, FA, DT>;
  constexpr size_t smem = ApplyShape<MODE, FA, DT>::kSmem;
  const cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  kernel<<<n_groups, kApplyThreads, smem, s>>>(
      a.x, a.uv, a.pairs, a.groups, a.dst, a.urow, a.counts, a.edge_id, a.w,
      a.D, a.out, a.partials);
  return cudaSuccess;
}

// The bf16 apply: one launch a column tile of DT columns.
template <int MODE, bool FA, int DT>
cudaError_t launch_apply(int n_groups, cudaStream_t s,
                         const ApplyArgs<bf16>& a) {
  static bool ready = false;
  const auto kernel = dedup_apply_bf16<MODE, FA, DT>;
  constexpr size_t smem = ApplyShapeB<MODE, FA, DT>::kSmem;
  const cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  for (int c0 = 0; c0 < a.D; c0 += DT)
    kernel<<<n_groups, kApplyThreads, smem, s>>>(
        a.x, a.uv, a.pairs, a.groups, a.dst, a.urow, a.counts, a.edge_id,
        a.w, a.D, c0, a.out, a.partials);
  return cudaSuccess;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<MODE>, Int<FA>, Int<DT>) for the apply kernel that takes `mode` at
// `max_count` and width D: C in float past 256, the column tile the
// least of 16, 32, 64, 128 that holds D (128 for wider D).
template <typename F>
cudaError_t with_apply(int mode, int max_count, int D, F&& f) {
  const auto width = [&](auto m, auto fa) {
    if (D <= 16) return f(m, fa, Int<16>{});
    if (D <= 32) return f(m, fa, Int<32>{});
    if (D <= 64) return f(m, fa, Int<64>{});
    return f(m, fa, Int<128>{});
  };
  const bool fa = max_count > kCountsMax;
  if (mode == kCached && !fa) return width(Int<kCached>{}, Int<0>{});
  if (mode == kCount && !fa) return width(Int<kCount>{}, Int<0>{});
  if (mode == kCount) return width(Int<kCount>{}, Int<1>{});
  if (mode == kWeighted) return width(Int<kWeighted>{}, Int<1>{});
  return cudaErrorInvalidValue;
}

// The apply on tables of T, then the combine of the split blocks.
template <typename T>
int run_apply(int device, int mode, const T* x, const int* uv,
              const int* pairs, const int* groups, int n_groups,
              const int* split_blocks, const int* split_ptr, int n_split,
              const int* dst, const int* urow, const void* counts,
              const int* edge_id, const T* w, int max_count, int D, T* out,
              float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_groups <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const ApplyArgs<T> a{x,
                       uv,
                       reinterpret_cast<const int4*>(pairs),
                       reinterpret_cast<const int4*>(groups),
                       dst,
                       urow,
                       static_cast<const bf16*>(counts),
                       edge_id,
                       w,
                       D,
                       out,
                       partials};
  err = with_apply(mode, max_count, D, [&](auto m, auto fa, auto dt) {
    return launch_apply<decltype(m)::value, decltype(fa)::value != 0,
                        decltype(dt)::value>(n_groups, s, a);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split > 0) {
    dedup_combine<T><<<dim3(n_split, kNB / kCombineWarps),
                       kCombineWarps * 32, 0, s>>>(partials, split_blocks,
                                                   split_ptr, D, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 entry points (K4 and the apply), or (built with -DPGL_BF16,
// the library dedup_kernels_bf16) the bf16 apply: each half instantiates
// only its element type, so the two build in parallel. K4 reads no
// feature, so the bf16 path takes its counts from the float32 library.
#ifndef PGL_BF16

// K4: counts [P*256, 128] bf16 from the layout's pairs and edges.
extern "C" int pgl_dedup_counts(int device, const int* pairs, int n_pairs,
                                const int* dst, const int* urow, void* counts,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs <= 0) return static_cast<int>(cudaGetLastError());
  static bool ready = false;
  err = allow_smem(dedup_counts, kCountsSmem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dedup_counts<<<dim3(n_pairs, kNB / kHalf), kThreads, kCountsSmem,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(pairs), dst, urow,
      static_cast<bf16*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// out [n_pad, D] f32 from x [N, D] f32, with C from `mode`: 0 (K5) the
// cached `counts` [P*256, 128] bf16; 1 (K6) the counts rebuilt, kept in
// float32 when `max_count` exceeds 256; 2 (the weighted K6) the sums of w
// [E] f32 (the caller's edge order) over each cell's edges, edge_id [E]
// naming each layout position's edge.
extern "C" int pgl_dedup_apply_f32(int device, int mode, const float* x,
                                   const int* uv, const int* pairs,
                                   const int* groups, int n_groups,
                                   const int* split_blocks,
                                   const int* split_ptr, int n_split,
                                   const int* dst, const int* urow,
                                   const void* counts, const int* edge_id,
                                   const float* w, int max_count, int D,
                                   float* out, float* partials,
                                   void* stream) {
  return run_apply(device, mode, x, uv, pairs, groups, n_groups,
                   split_blocks, split_ptr, n_split, dst, urow, counts,
                   edge_id, w, max_count, D, out, partials, stream);
}

#else

// The apply on bf16 tables: x [N, D], w [E] and out [n_pad, D] bf16 (raw
// 16-bit words), partials [n_partials*256, D] f32; modes and the rest as
// pgl_dedup_apply_f32's. The sums f32, each stored value rounded once to
// nearest even.
extern "C" int pgl_dedup_apply_bf16(int device, int mode, const void* x,
                                    const int* uv, const int* pairs,
                                    const int* groups, int n_groups,
                                    const int* split_blocks,
                                    const int* split_ptr, int n_split,
                                    const int* dst, const int* urow,
                                    const void* counts, const int* edge_id,
                                    const void* w, int max_count, int D,
                                    void* out, float* partials,
                                    void* stream) {
  return run_apply(device, mode, static_cast<const bf16*>(x), uv, pairs,
                   groups, n_groups, split_blocks, split_ptr, n_split, dst,
                   urow, counts, edge_id, static_cast<const bf16*>(w),
                   max_count, D, static_cast<bf16*>(out), partials, stream);
}

#endif  // PGL_BF16

// The dynamic shared memory (bytes) of the apply launch on bf16 tables
// (`on_bf16` nonzero) or float ones, for `mode` at `max_count` and width D,
// as the entry points take them; -1 for an unknown mode.
extern "C" int pgl_dedup_apply_smem(int on_bf16, int mode, int max_count,
                                    int D) {
  size_t bytes = 0;
  const cudaError_t err =
      with_apply(mode, max_count, D, [&](auto m, auto fa, auto dt) {
        constexpr int M = decltype(m)::value, DT = decltype(dt)::value;
        constexpr bool FA = decltype(fa)::value != 0;
        bytes = on_bf16 ? ApplyShapeB<M, FA, DT>::kSmem
                        : ApplyShape<M, FA, DT>::kSmem;
        return cudaSuccess;
      });
  return err == cudaSuccess ? static_cast<int>(bytes) : -1;
}
