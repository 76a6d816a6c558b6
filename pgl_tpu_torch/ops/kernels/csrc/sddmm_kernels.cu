// Dedup SDDMM (K11) for Hopper (sm_90a). For every slot s of a layout built
// by `build_sddmm_layout` (pgl_tpu_torch/ops/kernels/sddmm_kernels.py):
//   out[s, :] = src[slot_src[s], :] (+ - * /) dst[slot_dst[s], :]
// and out[s, :] = 0 at a pad (slot_dst[s] >= n, the layout's sentinel).
//
// Replaces the TPU kernel pgl_tpu/ops/pallas/sddmm_kernels.py
// `_sddmm_kernel` (driven by `_sddmm_call`, public `sddmm_dedup`), with the
// same output: [S, D] float32 in the layout's slot order, pads 0. That
// kernel gathers on the MXU: a block's distinct sources and its 128
// destination rows are copied to VMEM once, split into three bf16 pieces
// each, and expanded to slots by one-hot products (an error of about 2^-26
// of |x|). A GPU gathers rows directly, so none of that is carried over:
// each value here is one IEEE float32 operation on the two gathered values,
// the same bits as the plain version (the sources are built without
// --use_fast_math, so `/` rounds correctly). A real edge keeps the inf or
// nan a division by 0 gives; only pads are 0.
//
// What bounds it on this card: bytes. It must read each unique source row
// and destination row once, the two int32 slot tables, and write [S, D];
// the S*D operations are far below the float32 rate. The gather bound, two
// rows read an edge and the output written, is the nearer yardstick for a
// kernel that gathers every slot's rows from device memory (or L2), as this
// one does:
//   * a warp walks a run of consecutive slots; LPR lanes cover one slot's
//     row (16-byte loads where D % 4 == 0 and the pointers are 16-byte
//     aligned, 4-byte loads otherwise, column passes past 32 * VEC), so a
//     narrow row puts 32 / LPR slots on the warp at once;
//   * slot order is destination-block-major, so a run's destination rows
//     come from one 128-row block, and a pair's sources from one window of
//     unique rows: both stay in L1/L2 while the run is walked;
//   * no shared memory and no atomics: every output element is written
//     once, by one lane, and two runs give the same bits.
// Staging a pair's window of unique sources and its block's destination
// rows in shared memory, so each is read from device memory once, is the
// later redesign.
//
// Calling convention: launches on the given stream, does not synchronise,
// allocates nothing (the caller passes `out` [S, D]), and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kSlotsPerWarp = 32;  // consecutive slots one warp walks
enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3 };

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (OP == kAdd) return a + b;
  if constexpr (OP == kSub) return a - b;
  if constexpr (OP == kMul) return a * b;
  return a / b;
}

template <int OP, int VEC, int LPR>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_slots(const float* __restrict__ src, const float* __restrict__ dst,
            const int* __restrict__ slot_src,
            const int* __restrict__ slot_dst, int n, long long S, int D,
            float* __restrict__ out) {
  constexpr int G = 32 / LPR;  // slots the warp covers at once
  const int lane = threadIdx.x & 31;
  const int g = lane / LPR;
  const int l = lane % LPR;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kSlotsPerWarp;
  const long long last = min(first + kSlotsPerWarp, S);
  for (long long s = first + g; s < last; s += G) {
    const int u = __ldg(slot_src + s);
    const int v = __ldg(slot_dst + s);
    float* o = out + s * D;
    if (v >= n) {  // a pad
      for (int c = l * VEC; c < D; c += LPR * VEC) {
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(o + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          o[c] = 0.f;
        }
      }
      continue;
    }
    const float* a = src + static_cast<size_t>(u) * D;
    const float* b = dst + static_cast<size_t>(v) * D;
    for (int c = l * VEC; c < D; c += LPR * VEC) {
      if constexpr (VEC == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(a + c));
        const float4 y = __ldg(reinterpret_cast<const float4*>(b + c));
        *reinterpret_cast<float4*>(o + c) =
            make_float4(combine<OP>(x.x, y.x), combine<OP>(x.y, y.y),
                        combine<OP>(x.z, y.z), combine<OP>(x.w, y.w));
      } else {
        o[c] = combine<OP>(__ldg(a + c), __ldg(b + c));
      }
    }
  }
}

template <int OP, int VEC>
void launch_lpr(int lpr, unsigned blocks, cudaStream_t s, const float* src,
                const float* dst, const int* slot_src, const int* slot_dst,
                int n, long long S, int D, float* out) {
#define PGL_SDDMM_CASE(L)                                               \
  case L:                                                               \
    sddmm_slots<OP, VEC, L><<<blocks, kWarps * 32, 0, s>>>(             \
        src, dst, slot_src, slot_dst, n, S, D, out);                    \
    break;
  switch (lpr) {
    PGL_SDDMM_CASE(1)
    PGL_SDDMM_CASE(2)
    PGL_SDDMM_CASE(4)
    PGL_SDDMM_CASE(8)
    PGL_SDDMM_CASE(16)
    default:
      PGL_SDDMM_CASE(32)
  }
#undef PGL_SDDMM_CASE
}

template <int OP>
void launch_vec(bool vec4, int lpr, unsigned blocks, cudaStream_t s,
                const float* src, const float* dst, const int* slot_src,
                const int* slot_dst, int n, long long S, int D, float* out) {
  if (vec4) {
    launch_lpr<OP, 4>(lpr, blocks, s, src, dst, slot_src, slot_dst, n, S, D,
                      out);
  } else {
    launch_lpr<OP, 1>(lpr, blocks, s, src, dst, slot_src, slot_dst, n, S, D,
                      out);
  }
}

}  // namespace

// K11: out [S, D] = src [n, D] (op) dst [n, D] gathered through the slot
// tables (op 0 add, 1 sub, 2 mul, 3 div), 0 where slot_dst >= n.
extern "C" int pgl_sddmm_f32(int device, int op, const float* src,
                             const float* dst, const int* slot_src,
                             const int* slot_dst, long long S, int n, int D,
                             float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < kAdd || op > kDiv) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec4 = D % 4 == 0 && (ptrs & 15) == 0;
  const int lanes = vec4 ? D / 4 : D;
  int lpr = 1;
  while (lpr < lanes && lpr < 32) lpr <<= 1;
  const long long per_block = static_cast<long long>(kWarps) * kSlotsPerWarp;
  const long long blocks = (S + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto b = static_cast<unsigned>(blocks);
  switch (op) {
    case kAdd:
      launch_vec<kAdd>(vec4, lpr, b, s, src, dst, slot_src, slot_dst, n, S, D,
                       out);
      break;
    case kSub:
      launch_vec<kSub>(vec4, lpr, b, s, src, dst, slot_src, slot_dst, n, S, D,
                       out);
      break;
    case kMul:
      launch_vec<kMul>(vec4, lpr, b, s, src, dst, slot_src, slot_dst, n, S, D,
                       out);
      break;
    default:
      launch_vec<kDiv>(vec4, lpr, b, s, src, dst, slot_src, slot_dst, n, S, D,
                       out);
  }
  return static_cast<int>(cudaGetLastError());
}
