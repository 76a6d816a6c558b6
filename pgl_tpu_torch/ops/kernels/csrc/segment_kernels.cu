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
// What bounds it: bytes. Per call it must read x once ([N, D] f32), the
// indices ([E] i32) and the row pointer, and write out ([N, D] f32); the
// E*D additions are far below the card's f32 rate. The design moves no
// more than that plus what the gather re-reads:
//   * each source row is read straight from x for each edge; there is no
//     [E, D] message buffer in device memory (the TPU path materialises one);
//   * rows are cut on the host into pieces of at most ET edges (the work
//     list built by `build_spmm_layout`), one warp per piece, so a hub row
//     (38% of all edges on the power-law bench graph) is spread over many
//     SMs instead of walking on one warp; the host also sorts each row's
//     sources, so a hub's pieces read narrow bands of x that stay in L2;
//   * lanes run across D with 16-byte loads where D % 4 == 0 and 4-byte
//     loads otherwise; narrow rows put several edges on one warp (groups of
//     LPR lanes), and the edge loop keeps kUnroll loads in flight per lane;
//   * a row of one piece stores its sum directly, an empty row stores 0, and
//     a row of several pieces writes per-piece partials that a second launch
//     sums in piece order. No atomics: every run gives the same bits.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes `out` [N, D] and `partials`
// [num_partials, D]), and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPieceWarps = 8;     // warps per block in the piece launch
constexpr int kCombineWarps = 16;  // warps per block in the combine launch
constexpr int kUnroll = 8;         // gathered rows in flight per lane (K1)
// the same for K1w: its weights, edge ids and weight-gradient scan hold
// more registers, and at 8 its backward took 101 (2 blocks an SM) and 1.75x
// to 1.8x the time it takes at 4, with 64
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

// One warp per piece (row, begin, end, slot). LPR lanes cover VEC * LPR
// columns of one edge's row; the warp's 32 / LPR lane groups take
// interleaved edges of the piece and are summed by a fixed shuffle tree.
//
// WOP combines each gathered row with its edge's weight before the sum
// (K1w): kMul multiplies, kAdd adds, kNone leaves it (K1). The weight of
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
  constexpr int G = 32 / LPR;
  constexpr bool kEid = WOP != kNone || DWOP != kNone;
  // the summation order of a lane group (edges g, g + G, g + 2G, ...) does
  // not depend on U
  constexpr int U = kEid ? kUnrollWeighted : kUnroll;
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
    int mine_e = kEid && have ? __ldg(eid + pc.y + lane) : 0;
    for (long long base = pc.y; base < pc.z; base += 32) {
      const int n = static_cast<int>(min(32LL, pc.z - base));
      const long long next_e = base + 32 + lane;
      const int next = next_e < pc.z ? __ldg(indices + next_e) : 0;
      const int next_id = kEid && next_e < pc.z ? __ldg(eid + next_e) : 0;
      for (int j0 = 0; j0 < n; j0 += U * G) {
        float v[U][VEC];
        float wv[U];
        int ev[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * G + g;
          const int s = __shfl_sync(kFull, mine, j & 31);
          ev[u] = kEid ? __shfl_sync(kFull, mine_e, j & 31) : 0;
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
      if constexpr (kEid) mine_e = next_id;
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

// The piece launch and, where rows split, the combine launch.
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
  if (wop == kNone && dwop == kNone) {
    launch_vec<kNone, kNone>(vec4, lpr, blocks, s, a);
  } else if (wop == kMul && dwop == kNone) {
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

}  // namespace

// K1: out [R, D] = the sorted-segment sum of x [N, D] over the layout.
extern "C" int pgl_spmm_f32(int device, const float* x, const int* indices,
                            const int* pieces, int n_pieces,
                            const int* split_rows, const int* split_ptr,
                            int n_split, int D, float* out, float* partials,
                            void* stream) {
  const Args a{x,       indices,  nullptr, nullptr,
               1,       D,        reinterpret_cast<const int4*>(pieces),
               n_pieces, D,       out,     partials,
               nullptr, nullptr};
  return run(device, kNone, kNone, a, split_rows, split_ptr, n_split, stream);
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
