// K6: RoPE on the bf16 serving DiT's fused q/k/v projection, written straight
// into the head-major layout the flash forward (K3a) reads. From the wqkv
// product (B * L, (H + 2 Hkv) * hd) bf16 and the (L, hd / 2) fp32 cos / sin
// tables it writes q and k rotated and v as it is, each a contiguous bf16
// (B, heads, L, hd) tensor:
//     (x[2i], x[2i+1]) -> (x[2i] c_i - x[2i+1] s_i,  x[2i] s_i + x[2i+1] c_i)
// in fp32, rounded once to bf16.
//
// Replaces no TPU kernel: XLA fuses the rotation on the TPU; in PyTorch's
// eager mode ops/rope.py's rotation is a cast to fp32, six strided
// half-width passes, a stack and a cast back for each of q and k, and the
// flash route then copies q, k and v to (B, H, L, D) (ops/attention.py).
//
// What bounds it on the H100: it reads each element once and writes it once
// (4 bytes an element in bf16) for six fp32 operations a pair: the bytes.
// Design: one thread per 4 pairs (a 16-byte load of 8 bf16, 16-byte loads of
// 4 cos and 4 sin, a 16-byte store), threads in the order of the input row,
// so a warp reads 512 contiguous bytes and writes whole runs of a head's
// row; no shared memory. A head dim that is not a multiple of 8 (or a
// tensor off 16-byte boundaries) takes one pair a thread. The rotation's
// products and sums round on their own (__fmul_rn / __fadd_rn / __fsub_rn),
// as the plain version's separate passes do, so the result is the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace maa3_dit {
namespace {

constexpr int kThreads = 256;

struct RopeArgs {
  const __nv_bfloat16* qkv;  // (B * L, (H + 2 Hkv) * hd)
  const float* cos;          // (L, hd / 2)
  const float* sin;
  __nv_bfloat16* q;          // (B, H, L, hd)
  __nv_bfloat16* k;          // (B, Hkv, L, hd)
  __nv_bfloat16* v;          // (B, Hkv, L, hd)
  int L, H, Hkv, hd;
};

__device__ __forceinline__ uint32_t rotate(uint32_t pair, float c, float s) {
  const float xr = __uint_as_float(pair << 16);
  const float xi = __uint_as_float(pair & 0xffff0000u);
  const float yr = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
  const float yi = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(yr))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(yi))) << 16;
}

// kPairs pairs a thread: 4 (16-byte accesses) or 1 (4-byte)
template <int kPairs>
__global__ void __launch_bounds__(kThreads) rope_qkv_heads_kernel(RopeArgs a,
                                                                  long long tasks) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= tasks) return;
  const int heads = a.H + 2 * a.Hkv;
  const int per_row = heads * a.hd / (2 * kPairs);
  const long long n = t / per_row;                      // token row b * L + l
  const int col = static_cast<int>(t - n * per_row) * 2 * kPairs;
  const int head = col / a.hd, d0 = col - head * a.hd;  // a vector stays in one head
  const int l = static_cast<int>(n % a.L);
  const long long b = n / a.L;
  __nv_bfloat16* out;
  int nh, hh;
  if (head < a.H) {
    out = a.q; nh = a.H; hh = head;
  } else if (head < a.H + a.Hkv) {
    out = a.k; nh = a.Hkv; hh = head - a.H;
  } else {
    out = a.v; nh = a.Hkv; hh = head - a.H - a.Hkv;
  }
  const size_t src = static_cast<size_t>(n) * heads * a.hd + col;
  const size_t dst = ((static_cast<size_t>(b) * nh + hh) * a.L + l) * a.hd + d0;
  const bool rot = head < a.H + a.Hkv;
  const size_t cs = static_cast<size_t>(l) * (a.hd / 2) + d0 / 2;
  if constexpr (kPairs == 4) {
    uint4 u = *reinterpret_cast<const uint4*>(a.qkv + src);
    if (rot) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(a.cos + cs));
      const float4 s = __ldg(reinterpret_cast<const float4*>(a.sin + cs));
      u = make_uint4(rotate(u.x, c.x, s.x), rotate(u.y, c.y, s.y), rotate(u.z, c.z, s.z),
                     rotate(u.w, c.w, s.w));
    }
    *reinterpret_cast<uint4*>(out + dst) = u;
  } else {
    uint32_t u = *reinterpret_cast<const uint32_t*>(a.qkv + src);
    if (rot) u = rotate(u, __ldg(a.cos + cs), __ldg(a.sin + cs));
    *reinterpret_cast<uint32_t*>(out + dst) = u;
  }
}

template <int kPairs>
int launch(const RopeArgs& a, long long rows, cudaStream_t s) {
  const long long tasks = rows * ((a.H + 2 * a.Hkv) * a.hd / (2 * kPairs));
  const long long blocks = (tasks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  rope_qkv_heads_kernel<kPairs><<<grid, kThreads, 0, s>>>(a, tasks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace maa3_dit

// qkv: (B * L, (H + 2 Hkv) * hd) bf16, every pointer on 4 bytes; cos, sin:
// (L, hd / 2) fp32; q: (B, H, L, hd), k and v: (B, Hkv, L, hd) bf16. hd even.
// Returns the cudaError_t of the launch.
extern "C" int maa3_rope_qkv_heads(const void* qkv, const void* cos, const void* sin,
                                   void* q, void* k, void* v, int B, int L, int H,
                                   int Hkv, int hd, void* stream) {
  using namespace maa3_dit;
  if (B < 0 || L <= 0 || H <= 0 || Hkv <= 0 || hd <= 0 || hd % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  RopeArgs a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(cos),
             static_cast<const float*>(sin), static_cast<__nv_bfloat16*>(q),
             static_cast<__nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(v), L, H, Hkv, hd};
  const long long rows = static_cast<long long>(B) * L;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = hd % 8 == 0 && aligned16(qkv) && aligned16(cos) && aligned16(sin) &&
                   aligned16(q) && aligned16(k) && aligned16(v);
  return vec ? launch<4>(a, rows, s) : launch<1>(a, rows, s);
}
