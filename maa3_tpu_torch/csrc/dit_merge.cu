// K8: the bf16 serving DiT block's gated cross-attention merge and the
// layout change before its wo GEMM. From the flash forward's (K3a)
// head-major (B, H, L, hd) bf16 self-attention output o and cross-attention
// output o_y, and the (H,) cross-attention gate (fp32 or bf16), it writes
// the token-major (B, L, H * hd) bf16 input of wo:
//     g = bf16(tanh(gate[h])),  m = bf16(o_y * g),  out = bf16(o + m)
// each step computed in fp32 and rounded to bf16, as the plain chain
// (ops/attention.py _attend: the gate's tanh and cast, the broadcast
// product, the sum, `transpose(1, 2).reshape`) rounds.
//
// Replaces no TPU kernel: XLA fuses the merge and the transpose into the
// GEMM around them; in PyTorch's eager mode they are five launches (two
// one-row passes for the gate, a broadcast product, a sum and a strided
// copy), three of them over the whole activation.
//
// What bounds it on the H100: 6 bytes an element (o and o_y read, out
// written, bf16) for two products and a sum: the bytes. Design: one thread
// per 8 features of one head (16-byte loads of o and o_y, a 16-byte store),
// threads in the order of the output row, so a warp writes 512 contiguous
// bytes and reads runs of a head's row (hd * 2 bytes); each thread works
// out its head's gate itself (a tanh of one cached value), so the gate
// needs no launch of its own. A head dim that is not a multiple of 8 (or a
// tensor off 16-byte boundaries) takes one element a thread.
// Numerics: tanh is the library's tanhf in fp32, as PyTorch's CUDA tanh;
// the product of two bf16 is exact in fp32 and the sum rounds once in fp32,
// then each rounds to bf16: the plain chain's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace maa3_dit {
namespace {

constexpr int kThreads = 256;

struct MergeArgs {
  const __nv_bfloat16* o;    // (B, H, L, hd)
  const __nv_bfloat16* oy;   // (B, H, L, hd)
  const void* gate;          // (H,) fp32 or bf16
  __nv_bfloat16* out;        // (B, L, H * hd)
  int L, H, hd, gate_bf16;
};

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float merge1(float o, float oy, float g) {
  const float m = __bfloat162float(__float2bfloat16_rn(__fmul_rn(oy, g)));
  return __fadd_rn(o, m);  // rounded to bf16 by the caller
}

__device__ __forceinline__ uint32_t merge2(uint32_t o, uint32_t oy, float g) {
  const __nv_bfloat16 lo = __float2bfloat16_rn(merge1(bf16_lo(o), bf16_lo(oy), g));
  const __nv_bfloat16 hi = __float2bfloat16_rn(merge1(bf16_hi(o), bf16_hi(oy), g));
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// kVec features a thread: 8 (16-byte accesses) or 1
template <int kVec>
__global__ void __launch_bounds__(kThreads) gated_merge_heads_kernel(MergeArgs a,
                                                                     long long tasks) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= tasks) return;
  const int per_row = a.H * a.hd / kVec;
  const long long n = t / per_row;                      // token row b * L + l
  const int col = static_cast<int>(t - n * per_row) * kVec;
  const int head = col / a.hd, d0 = col - head * a.hd;  // a vector stays in one head
  const int l = static_cast<int>(n % a.L);
  const long long b = n / a.L;
  const float gate = a.gate_bf16
      ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(a.gate) + head))
      : __ldg(static_cast<const float*>(a.gate) + head);
  const float g = __bfloat162float(__float2bfloat16_rn(tanhf(gate)));
  const size_t src = ((static_cast<size_t>(b) * a.H + head) * a.L + l) * a.hd + d0;
  const size_t dst = static_cast<size_t>(n) * a.H * a.hd + col;
  if constexpr (kVec == 8) {
    const uint4 o = *reinterpret_cast<const uint4*>(a.o + src);
    const uint4 y = *reinterpret_cast<const uint4*>(a.oy + src);
    *reinterpret_cast<uint4*>(a.out + dst) =
        make_uint4(merge2(o.x, y.x, g), merge2(o.y, y.y, g), merge2(o.z, y.z, g),
                   merge2(o.w, y.w, g));
  } else {
    a.out[dst] = __float2bfloat16_rn(
        merge1(__bfloat162float(a.o[src]), __bfloat162float(a.oy[src]), g));
  }
}

template <int kVec>
int launch(const MergeArgs& a, long long rows, cudaStream_t s) {
  const long long tasks = rows * (a.H * a.hd / kVec);
  const long long blocks = (tasks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  gated_merge_heads_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, tasks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace maa3_dit

// o, o_y: (B, H, L, hd) bf16; gate: (H,) fp32 (gate_bf16 0) or bf16 (1); out:
// (B, L, H * hd) bf16; all contiguous. Returns the cudaError_t of the launch.
extern "C" int maa3_gated_merge_heads(const void* o, const void* o_y, const void* gate,
                                      void* out, int B, int L, int H, int hd, int gate_bf16,
                                      void* stream) {
  using namespace maa3_dit;
  if (B < 0 || L <= 0 || H <= 0 || hd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  MergeArgs a{static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(o_y),
              gate, static_cast<__nv_bfloat16*>(out), L, H, hd, gate_bf16};
  const long long rows = static_cast<long long>(B) * L;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = hd % 8 == 0 && aligned16(o) && aligned16(o_y) && aligned16(out);
  return vec ? launch<8>(a, rows, s) : launch<1>(a, rows, s);
}
