// Two-phase unique-source ("dedup") SpMM for Hopper (sm_90a). Per
// (block, window) pair p of a layout built by `build_dedup_layout`
// (pgl_tpu_torch/ops/kernels/dedup_kernels.py):
//   C_p[r, c] = #edges of p with dst blk_p*256 + r and unique row wb_p + c
//   out[blk_p*256 + r, :] += sum_c C_p[r, c] * x[uv[wb_p + c], :]
//
// Replaces the TPU kernels of pgl_tpu/ops/pallas/dedup_kernels.py:
//   * K4 `_materialize_kernel` with `_count_tiles` (the counts as bf16
//     [P*256, 128]): `pgl_dedup_counts`;
//   * K5 `_dedup_cached_kernel` (the apply with cached counts) and K6
//     `_dedup_kernel` (the apply with C rebuilt from the pair's edges on
//     every call; unweighted, or weighted: `weighted=True`, the TPU path's
//     `spmm_dedup_weighted`, where C[r, c] is the sum of the cell's edge
//     weights): `pgl_dedup_apply_f32`, one kernel templated on where C comes
//     from. Everything after C is the same code, so K5 and K6 give
//     identical bits wherever the cached counts are exact.
//
// What bounds it on this card. K4 is bound by the bytes of the counts it
// writes (2 B a cell, 64 KB a pair). The apply is dense: 2*256*128*D
// operations a pair, all in float32 FFMA (the counts are small integers,
// the features float32; TF32 or bf16 would change the numbers), against a
// byte bound of x, the counts and out read or written once. On graphs whose
// counts are as sparse as the bench headline's (1.6% of the cells nonzero)
// the dense operations, not the bytes, set its time; skipping zero cells is
// later work.
//
// Design:
//   * no per-edge one-hot products: the count pass walks the pair's edges
//     (exact [start, end) span, any length) and adds 1 to a shared-memory
//     int32 cell with an atomic; integer sums agree in any order. The
//     weighted pass sums float32 weights, whose sum depends on the order, so
//     it takes no atomics: a cell's edges are contiguous in the layout
//     (`build_dedup_layout` checks it), and the thread at a cell's first
//     edge sums the run in edge order. The TPU kernel splits w into three
//     bf16 terms for its MXU; here C stays float32;
//   * a CUDA block owns one group of at most PAIRS_PER_GROUP consecutive
//     pairs of one dst block, one half (128 rows) of that block and one
//     column tile of D (16, 32 or 64 wide). It sums its pairs in order in
//     registers (8x4, 4x4 or 2x4 outputs a thread). The TPU grid ran in
//     order and kept the output block resident across a block's pairs;
//     here groups run in parallel, so a dst block of several groups (the
//     headline's hub block has 1,024 pairs) writes one partial per group,
//     and a second launch sums them in group order. No float atomics, so
//     every run gives the same bits;
//   * the window rows are gathered straight from x through uv inside the
//     kernel (the TPU path gathers `uniq = x[uv]` into device memory first);
//     a window that runs past its block's unique run reads the next block's
//     rows (or the uv tail), whose counts are 0;
//   * C sits in shared memory as float with a row stride of 129 words, so
//     the 2 to 8 rows a warp reads at once fall in distinct banks.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes `out` [n_pad, D] and `partials`
// [n_partials*256, D]), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNB = 256;       // dst rows per block
constexpr int kW = 128;        // unique rows per window
constexpr int kHalf = 128;     // dst rows per CUDA block
constexpr int kLdc = kW + 1;   // row stride of C in shared memory (words)
constexpr int kThreads = 256;
constexpr int kCombineWarps = 8;

// pairs: int4 (blk, wb, start, end); groups: int4 (blk, p0, p1, slot)

// C_p's rows [h*128, h*128 + 128) as int32 in `cnt` [128][kLdc]. Ends
// with a barrier.
__device__ __forceinline__ void count_half(int* cnt, int4 pr, int h,
                                           const int* __restrict__ dst,
                                           const int* __restrict__ urow) {
  for (int i = threadIdx.x; i < kHalf * kLdc; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int row0 = pr.x * kNB + h * kHalf;
  for (int e = pr.z + threadIdx.x; e < pr.w; e += kThreads) {
    const int r = __ldg(dst + e) - row0;
    if (static_cast<unsigned>(r) < static_cast<unsigned>(kHalf))
      atomicAdd(cnt + r * kLdc + (__ldg(urow + e) - pr.y), 1);
  }
  __syncthreads();
}

// C_p's rows [h*128, h*128 + 128) as float in `c` [128][kLdc]: each cell
// the float32 sum, in edge order, of its edges' weights w[edge_id[e]]. Ends
// with a barrier.
__device__ __forceinline__ void weigh_half(float* c, int4 pr, int h,
                                           const int* __restrict__ dst,
                                           const int* __restrict__ urow,
                                           const int* __restrict__ edge_id,
                                           const float* __restrict__ w) {
  for (int i = threadIdx.x; i < kHalf * kLdc; i += kThreads) c[i] = 0.f;
  __syncthreads();
  const int row0 = pr.x * kNB + h * kHalf;
  for (int e = pr.z + threadIdx.x; e < pr.w; e += kThreads) {
    const int d = __ldg(dst + e);
    const int u = __ldg(urow + e);
    const int r = d - row0;
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(kHalf)) continue;
    if (e > pr.z && __ldg(dst + e - 1) == d && __ldg(urow + e - 1) == u)
      continue;  // not the cell's first edge
    float sum = 0.f;
    int f = e;
    do {
      sum += __ldg(w + __ldg(edge_id + f));
      ++f;
    } while (f < pr.w && __ldg(dst + f) == d && __ldg(urow + f) == u);
    c[r * kLdc + (u - pr.y)] = sum;
  }
  __syncthreads();
}

// K4: one CUDA block per (pair, half).
__global__ void __launch_bounds__(kThreads)
dedup_counts(const int4* __restrict__ pairs, const int* __restrict__ dst,
             const int* __restrict__ urow, __nv_bfloat16* __restrict__ counts) {
  extern __shared__ int cnt[];
  const int p = blockIdx.x;
  const int h = blockIdx.y;
  count_half(cnt, pairs[p], h, dst, urow);
  __nv_bfloat16* o =
      counts + (static_cast<size_t>(p) * kNB + h * kHalf) * kW;
  for (int i = threadIdx.x; i < kHalf * kW; i += kThreads)
    o[i] = __float2bfloat16(static_cast<float>(cnt[(i / kW) * kLdc + i % kW]));
}

// Where C comes from: K5's cached counts, K6's counts, K6's weights.
enum Mode { kCached = 0, kCount = 1, kWeighted = 2 };

// K5 and K6: one CUDA block per (group, half, column tile of DT). TX
// threads span the tile's columns (4 each), TY thread rows span the half's
// 128 rows (RPT each).
template <int MODE, int DT>
__global__ void __launch_bounds__(kThreads)
dedup_apply(const float* __restrict__ x, const int* __restrict__ uv,
            const int4* __restrict__ pairs, const int4* __restrict__ groups,
            const int* __restrict__ dst, const int* __restrict__ urow,
            const __nv_bfloat162* __restrict__ counts,
            const int* __restrict__ edge_id, const float* __restrict__ w,
            int D, float* __restrict__ out, float* __restrict__ partials) {
  constexpr int TX = DT / 4;
  constexpr int TY = kThreads / TX;
  constexpr int RPT = kHalf / TY;
  extern __shared__ float smem[];
  float* cs = smem;                  // [kHalf][kLdc] C as float
  float* ws = smem + kHalf * kLdc;   // [kW][DT] window tile
  __shared__ int rows[kW];

  const int4 gr = groups[blockIdx.x];
  const int h = blockIdx.y;
  const int d0 = blockIdx.z * DT;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[RPT][4];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int p = gr.y; p < gr.z; ++p) {
    const int4 pr = pairs[p];
    if constexpr (MODE == kCached) {
      const __nv_bfloat162* c2 =
          counts + (static_cast<size_t>(p) * kNB + h * kHalf) * (kW / 2);
      for (int i = threadIdx.x; i < kHalf * kW / 2; i += kThreads) {
        const float2 v = __bfloat1622float2(c2[i]);
        const int r = i / (kW / 2);
        const int c = 2 * (i % (kW / 2));
        cs[r * kLdc + c] = v.x;
        cs[r * kLdc + c + 1] = v.y;
      }
    } else if constexpr (MODE == kWeighted) {
      weigh_half(cs, pr, h, dst, urow, edge_id, w);
    } else {
      int* cnt = reinterpret_cast<int*>(cs);
      count_half(cnt, pr, h, dst, urow);
      for (int i = threadIdx.x; i < kHalf * kLdc; i += kThreads)
        cs[i] = static_cast<float>(cnt[i]);
    }
    if (threadIdx.x < kW) rows[threadIdx.x] = __ldg(uv + pr.y + threadIdx.x);
    __syncthreads();
    for (int i = threadIdx.x; i < kW * DT; i += kThreads) {
      const int c = i / DT;
      const int col = d0 + i % DT;
      ws[i] = col < D ? __ldg(x + static_cast<size_t>(rows[c]) * D + col)
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kW; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(ws + c * DT + tx * 4);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float a = cs[(ty * RPT + k) * kLdc + c];
        acc[k][0] = fmaf(a, b.x, acc[k][0]);
        acc[k][1] = fmaf(a, b.y, acc[k][1]);
        acc[k][2] = fmaf(a, b.z, acc[k][2]);
        acc[k][3] = fmaf(a, b.w, acc[k][3]);
      }
    }
    __syncthreads();
  }

  float* base = gr.w < 0 ? out + static_cast<size_t>(gr.x) * kNB * D
                         : partials + static_cast<size_t>(gr.w) * kNB * D;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float* o = base + static_cast<size_t>(h * kHalf + ty * RPT + k) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = d0 + tx * 4 + j;
      if (col < D) o[col] = acc[k][j];
    }
  }
}

// One CUDA block per (split dst block, 8 of its rows): warp w sums row
// r0 + w of the block's partial slots in slot order.
__global__ void __launch_bounds__(kCombineWarps * 32)
dedup_combine(const float* __restrict__ partials,
              const int* __restrict__ split_blocks,
              const int* __restrict__ split_ptr, int D,
              float* __restrict__ out) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kCombineWarps + w;
  const int s0 = split_ptr[blockIdx.x];
  const int s1 = split_ptr[blockIdx.x + 1];
  float* o = out + (static_cast<size_t>(split_blocks[blockIdx.x]) * kNB + r) * D;
  for (int col = lane; col < D; col += 32) {
    float acc = 0.f;
    for (int s = s0; s < s1; ++s)
      acc += partials[(static_cast<size_t>(s) * kNB + r) * D + col];
    o[col] = acc;
  }
}

constexpr size_t kCountsSmem = sizeof(int) * kHalf * kLdc;

template <int DT>
constexpr size_t apply_smem() {
  return sizeof(float) * (kHalf * kLdc + kW * DT);
}

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

struct ApplyArgs {
  const float* x;
  const int* uv;
  const int4* pairs;
  const int4* groups;
  const int* dst;
  const int* urow;
  const __nv_bfloat162* counts;
  const int* edge_id;
  const float* w;
  int D;
  float* out;
  float* partials;
};

template <int MODE, int DT>
cudaError_t launch_apply(int n_groups, cudaStream_t s, const ApplyArgs& a) {
  static bool ready = false;
  const auto kernel = dedup_apply<MODE, DT>;
  const cudaError_t err = allow_smem(kernel, apply_smem<DT>(), ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_groups, kNB / kHalf, (a.D + DT - 1) / DT);
  kernel<<<grid, kThreads, apply_smem<DT>(), s>>>(
      a.x, a.uv, a.pairs, a.groups, a.dst, a.urow, a.counts, a.edge_id, a.w,
      a.D, a.out, a.partials);
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch_apply_d(int n_groups, cudaStream_t s, const ApplyArgs& a) {
  if (a.D <= 16) return launch_apply<MODE, 16>(n_groups, s, a);
  if (a.D <= 32) return launch_apply<MODE, 32>(n_groups, s, a);
  return launch_apply<MODE, 64>(n_groups, s, a);
}

}  // namespace

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
      static_cast<__nv_bfloat16*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// out [n_pad, D] f32 from x [N, D] f32, with C from `mode`: 0 (K5) the
// cached `counts` [P*256, 128] bf16; 1 (K6) the counts rebuilt; 2 (the
// weighted K6) the sums of w [E] f32 (the caller's edge order) over each
// cell's edges, edge_id [E] naming each layout position's edge.
extern "C" int pgl_dedup_apply_f32(int device, int mode, const float* x,
                                   const int* uv, const int* pairs,
                                   const int* groups, int n_groups,
                                   const int* split_blocks,
                                   const int* split_ptr, int n_split,
                                   const int* dst, const int* urow,
                                   const void* counts, const int* edge_id,
                                   const float* w, int D, float* out,
                                   float* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_groups <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const ApplyArgs a{x,
                    uv,
                    reinterpret_cast<const int4*>(pairs),
                    reinterpret_cast<const int4*>(groups),
                    dst,
                    urow,
                    static_cast<const __nv_bfloat162*>(counts),
                    edge_id,
                    w,
                    D,
                    out,
                    partials};
  if (mode == kCached) {
    err = launch_apply_d<kCached>(n_groups, s, a);
  } else if (mode == kCount) {
    err = launch_apply_d<kCount>(n_groups, s, a);
  } else if (mode == kWeighted) {
    err = launch_apply_d<kWeighted>(n_groups, s, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split > 0) {
    dedup_combine<<<dim3(n_split, kNB / kCombineWarps), kCombineWarps * 32,
                    0, s>>>(partials, split_blocks, split_ptr, D, out);
  }
  return static_cast<int>(cudaGetLastError());
}
