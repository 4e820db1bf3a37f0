// K5: the bf16 serving DiT block's gated residual, RMSNorm and adaLN
// modulate in one pass over a token row of the fp32 residual stream:
//     h' = h + gate[b] * branch                  (fp32; branch bf16, may be absent)
//     x  = ((h' * rsqrt(mean(h'^2) + eps)) * w) * (1 + scale[b]) + shift[b]
// h' is written over h (when there is a branch) and x is the input of the
// block's next GEMM (wqkv or w13): bf16, or fp32 where that GEMM is an int8
// one (ops/quant.py dense_w8a8 quantizes its input from fp32).
//
// Replaces no TPU kernel: on the TPU XLA fuses these passes into the GEMMs
// around them; in PyTorch's eager mode they are about twenty separate
// elementwise and reduction launches a site (ops/basic.py rms_norm and
// modulate, the gated residual of models/dit.py _block_apply), most of them
// broadcast or mixed-dtype passes on the non-vectorised elementwise kernel.
//
// What bounds it on the H100: 12 bytes an element (h read and written in
// fp32, the branch read and x written in bf16; 14 with an fp32 x) against
// about ten fp32 operations, far below the card's ~20 operations a byte:
// the bytes. So the
// kernel reads each operand once and writes each result once:
// - One warp per token row. A lane takes chunks of 8 elements (two 16-byte
//   fp32 loads of h, one 16-byte load of the bf16 branch), chunk c at lane
//   c % 32, and keeps h' in registers between the sum of squares (a warp
//   shuffle reduction) and the modulate, up to kMaxChunks chunks a lane
//   (D <= 2048), instantiated for each count of chunks a lane: one
//   instantiation for all (a lane skipping the chunks past its row) holds
//   64 registers of h' at every width and ran 11 % slower at D 1152 and
//   4 % at 1536 on the H100. Wider rows take a row loop that reads h' back
//   (its own writes, from L2).
// - gate, shift and scale are rows of the plan's (B, 6D) modulation (a row
//   stride, unit column stride) and the norm weight is (D,): every token
//   row of a batch item reads the same ones, through the read-only path.
// - No shared memory and no barrier: blocks of kWarps rows.
// Numerics: every product and sum rounds on its own (__fmul_rn /
// __fadd_rn: nvcc may not contract them into FMAs), in the plain version's
// order (ops/dit_fused.py residual_norm_modulate_plain), so h' is the same
// bits. The mean is the sum of squares times the fp32 1/D, as torch.mean
// computes it on the card (its reduction multiplies by that factor; on the
// CPU it divides, but there the plain version runs instead). Only the sum
// of squares is added in another order, which can move a bf16 x by one ulp
// on rare elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace maa3_dit {
namespace {

constexpr int kWarps = 4;       // token rows per block
constexpr int kMaxChunks = 8;   // chunks of 8 a lane keeps in registers

struct NormArgs {
  float* h;                      // (rows, D) fp32, h' written over it
  const __nv_bfloat16* branch;   // (rows, D) bf16, or null
  const float* gate;             // (B, .) rows of mod_stride, or null
  const float* shift;
  const float* scale;
  const float* weight;           // (D,)
  void* x;                       // (rows, D) bf16 or fp32
  int rows, L, D, mod_stride;
  float eps, inv_d;
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8_ro(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 bf16 to fp32 (exact: a bf16 is the top half of an fp32)
__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

__device__ __forceinline__ void store8_bf16(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                            bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

// h' = h + gate * branch over one chunk, in place in v
__device__ __forceinline__ void add_branch(const NormArgs& a, const float* gate, size_t off,
                                           int col, float (&v)[8]) {
  float g[8], br[8];
  load8_ro(gate + col, g);
  load8_bf16(a.branch + off, br);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], __fmul_rn(g[i], br[i]));
}

__device__ __forceinline__ float sum_sq(float acc, const float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, __fmul_rn(v[i], v[i]));
  return acc;
}

// x = ((v * r) * w) * (1 + scale) + shift of one chunk, in OutT
template <typename OutT>
__device__ __forceinline__ void modulate_store(const NormArgs& a, const float* shift,
                                               const float* scale, size_t off, int col,
                                               float r, const float (&v)[8]) {
  float w[8], sh[8], sc[8], y[8];
  load8_ro(a.weight + col, w);
  load8_ro(shift + col, sh);
  load8_ro(scale + col, sc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float n = __fmul_rn(__fmul_rn(v[i], r), w[i]);
    y[i] = __fadd_rn(__fmul_rn(n, __fadd_rn(1.0f, sc[i])), sh[i]);
  }
  if constexpr (sizeof(OutT) == 2)
    store8_bf16(static_cast<__nv_bfloat16*>(a.x) + off, y);
  else
    store8(static_cast<float*>(a.x) + off, y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kChunks > 0: up to kChunks chunks a lane, h' in registers; kChunks == 0:
// the row loop, h' read back from h
template <int kChunks, bool kBranch, typename OutT>
__global__ void __launch_bounds__(32 * kWarps) residual_norm_modulate_kernel(NormArgs a) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= a.rows) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int chunks = a.D / 8;
  const size_t mrow = static_cast<size_t>(row / a.L) * a.mod_stride;
  const float* gate = kBranch ? a.gate + mrow : nullptr;
  const float* shift = a.shift + mrow;
  const float* scale = a.scale + mrow;
  const size_t base = static_cast<size_t>(row) * a.D;
  float ss = 0.0f;
  if constexpr (kChunks > 0) {
    float v[kChunks][8];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) {
        const size_t off = base + 8 * c;
        load8(a.h + off, v[j]);
        if constexpr (kBranch) {
          add_branch(a, gate, off, 8 * c, v[j]);
          store8(a.h + off, v[j]);
        }
        ss = sum_sq(ss, v[j]);
      }
    }
    const float r = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(ss), a.inv_d), a.eps));
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) modulate_store<OutT>(a, shift, scale, base + 8 * c, 8 * c, r, v[j]);
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      float v[8];
      const size_t off = base + 8 * c;
      load8(a.h + off, v);
      if constexpr (kBranch) {
        add_branch(a, gate, off, 8 * c, v);
        store8(a.h + off, v);
      }
      ss = sum_sq(ss, v);
    }
    const float r = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(ss), a.inv_d), a.eps));
    for (int c = lane; c < chunks; c += 32) {
      float v[8];
      const size_t off = base + 8 * c;
      load8(a.h + off, v);
      modulate_store<OutT>(a, shift, scale, off, 8 * c, r, v);
    }
  }
}

template <int kChunks, typename OutT>
int launch_out(const NormArgs& a, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((a.rows + kWarps - 1) / kWarps);
  if (a.branch != nullptr)
    residual_norm_modulate_kernel<kChunks, true, OutT><<<grid, 32 * kWarps, 0, s>>>(a);
  else
    residual_norm_modulate_kernel<kChunks, false, OutT><<<grid, 32 * kWarps, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kChunks>
int launch(const NormArgs& a, bool out_fp32, cudaStream_t s) {
  return out_fp32 ? launch_out<kChunks, float>(a, s) : launch_out<kChunks, __nv_bfloat16>(a, s);
}

}  // namespace
}  // namespace maa3_dit

// h, x: (rows, D) fp32 / bf16 (fp32 with out_fp32), token row r of batch
// item r / L; branch:
// (rows, D) bf16 or null (then gate is not read and h is not written);
// gate, shift, scale: rows of mod_stride floats, one per batch item; weight:
// (D,) fp32. D a multiple of 8, mod_stride of 4, every pointer on 16 bytes.
// Returns the cudaError_t of the launch.
extern "C" int maa3_residual_norm_modulate(void* h, const void* branch, const void* gate,
                                           const void* shift, const void* scale,
                                           const void* weight, void* x, int rows, int L,
                                           int D, int mod_stride, float eps,
                                           int out_fp32, void* stream) {
  using namespace maa3_dit;
  if (rows < 0 || L <= 0 || D <= 0 || D % 8 != 0 || mod_stride % 4 != 0 ||
      (branch != nullptr && gate == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  NormArgs a{static_cast<float*>(h), static_cast<const __nv_bfloat16*>(branch),
             static_cast<const float*>(gate), static_cast<const float*>(shift),
             static_cast<const float*>(scale), static_cast<const float*>(weight),
             x, rows, L, D, mod_stride, eps,
             1.0f / static_cast<float>(D)};
  auto s = static_cast<cudaStream_t>(stream);
  switch ((D / 8 + 31) / 32) {
    case 1: return launch<1>(a, out_fp32 != 0, s);
    case 2: return launch<2>(a, out_fp32 != 0, s);
    case 3: return launch<3>(a, out_fp32 != 0, s);
    case 4: return launch<4>(a, out_fp32 != 0, s);
    case 5: return launch<5>(a, out_fp32 != 0, s);
    case 6: return launch<6>(a, out_fp32 != 0, s);
    case 7: return launch<7>(a, out_fp32 != 0, s);
    case kMaxChunks: return launch<kMaxChunks>(a, out_fp32 != 0, s);
    default: return launch<0>(a, out_fp32 != 0, s);
  }
}
