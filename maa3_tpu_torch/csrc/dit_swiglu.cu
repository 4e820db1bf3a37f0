// K7: the bf16 serving DiT block's SwiGLU gate, between its w13 and w2
// GEMMs. From the fused w13 product (rows, 2F) bf16, x1 its first F columns
// and x3 its last F, it writes the contiguous (rows, F) bf16 input of w2:
//     s = bf16(sigmoid(x1)),  a = bf16(x1 * s),  p = bf16(a * x3)
// each step computed in fp32 and rounded to bf16, as the plain chain
// (ops/ffn.py: `silu(x1) * x3` on `chunk`'s two halves) rounds.
//
// Replaces no TPU kernel: XLA fuses the gate into the GEMMs around it; in
// PyTorch's eager mode it is three passes (sigmoid, x1 * s, * x3) over two
// strided halves, on the non-vectorised elementwise kernel.
//
// What bounds it on the H100: 6 bytes an element (x1 and x3 read, p written,
// bf16) against an exp, a division and two products: the bytes. Design: one
// thread per 8 columns (a 16-byte load of x1, one of x3 F columns on, a
// 16-byte store), threads in the order of the output row, so a warp reads
// two runs of 512 contiguous bytes and writes one; no shared memory. A
// width that is not a multiple of 8 (or a tensor off 16-byte boundaries)
// takes one column a thread.
// Numerics: sigmoid is 1 / (1 + expf(-x)) in fp32 with IEEE division, as
// PyTorch's CUDA sigmoid computes it; the products of two bf16 are exact in
// fp32, so each rounds once, to bf16. The result is the plain chain's bits
// wherever expf is the library's (tests/test_torch_cuda.py measures it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace maa3_dit {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float swiglu1(float x1, float x3) {
  const float s = round_bf16(1.0f / (1.0f + expf(-x1)));
  const float a = round_bf16(__fmul_rn(x1, s));
  return __fmul_rn(a, x3);  // rounded to bf16 by the caller
}

__device__ __forceinline__ uint32_t swiglu2(uint32_t x1, uint32_t x3) {
  const __nv_bfloat16 lo = __float2bfloat16_rn(swiglu1(bf16_lo(x1), bf16_lo(x3)));
  const __nv_bfloat16 hi = __float2bfloat16_rn(swiglu1(bf16_hi(x1), bf16_hi(x3)));
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// kVec columns a thread: 8 (16-byte accesses) or 1
template <int kVec>
__global__ void __launch_bounds__(kThreads) swiglu_kernel(const __nv_bfloat16* __restrict__ x13,
                                                          __nv_bfloat16* __restrict__ out,
                                                          int F, long long tasks) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= tasks) return;
  const int per_row = F / kVec;
  const long long n = t / per_row;
  const int col = static_cast<int>(t - n * per_row) * kVec;
  const size_t src = static_cast<size_t>(n) * 2 * F + col;
  const size_t dst = static_cast<size_t>(n) * F + col;
  if constexpr (kVec == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(x13 + src);
    const uint4 b = *reinterpret_cast<const uint4*>(x13 + src + F);
    *reinterpret_cast<uint4*>(out + dst) =
        make_uint4(swiglu2(a.x, b.x), swiglu2(a.y, b.y), swiglu2(a.z, b.z), swiglu2(a.w, b.w));
  } else {
    out[dst] = __float2bfloat16_rn(
        swiglu1(__bfloat162float(x13[src]), __bfloat162float(x13[src + F])));
  }
}

template <int kVec>
int launch(const __nv_bfloat16* x13, __nv_bfloat16* out, long long rows, int F,
           cudaStream_t s) {
  const long long tasks = rows * (F / kVec);
  const long long blocks = (tasks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  swiglu_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(x13, out, F, tasks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace maa3_dit

// x13: (rows, 2F) bf16; out: (rows, F) bf16, both contiguous. Returns the
// cudaError_t of the launch.
extern "C" int maa3_swiglu(const void* x13, void* out, long long rows, int F, void* stream) {
  using namespace maa3_dit;
  if (rows < 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  auto x = static_cast<const __nv_bfloat16*>(x13);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 8 == 0 && aligned16(x13) && aligned16(out);
  return vec ? launch<8>(x, o, rows, F, s) : launch<1>(x, o, rows, F, s);
}
