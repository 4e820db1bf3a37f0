// Tensor-core building blocks of the bf16 flash-attention kernels, shared by
// the forward (flash_fwd.cu: K3a, K3b) and the backward (flash_bwd_tc.cuh:
// K4a in flash_bwd.cu, K4b and K4c in flash_bwd_split.cu), so that they
// cannot drift apart in their tiling or their rounding points. Those kernels
// replace, in bf16, the TPU kernels _fwd_single_kernel, _fwd_online_kernel,
// _bwd_fused_kernel, _bwd_dkv_kernel and _bwd_dq_kernel of
// maa3_tpu/ops/flash_attention.py. At training lengths all five are bound by
// the tensor cores' rate (4 to 10 Lq Lk D operations against (2 to 4)
// (Lq + Lk) D elements), so the pieces
// keep every operand bf16 in shared memory in the layout wgmma reads, keep
// the scores in registers, and copy the next tile while this one is
// multiplied.
//
// A block of kTcThreads = 256 threads is two warpgroups (4 warps each); in
// the forward and K4c each warpgroup owns 64 query rows, in K4a and K4b 64
// keys.
// Products are Hopper warpgroup products (wgmma m64nNk16, bf16 inputs, fp32
// accumulators spread over the warpgroup's threads). Warp w of a warpgroup
// holds rows 16w .. 16w + 15; lane l holds rows g = l / 4 and g + 8 and, for
// each 8-column tile j, columns 8j + 2 (l % 4) and + 1: accumulator
// d[4j + e] is (row g + 8 (e / 2), column 8j + 2 (l % 4) + e % 2), the layout
// of mma.sync's m16n8 tiles. A row is spread over the 4 lanes of a quad, so a
// row reduction is two xor shuffles, and the accumulator of a 64 x 64 score
// tile is already the register A operand of the next product, whose depth is
// the score tile's columns: p . v in the forward, P^T . do and dS^T . q_s in
// K4a and K4b, dS . k in K4c. Those scores never go through shared memory.
//
// Shared tiles hold 64 rows of bf16 in the no-swizzle ("interleave")
// canonical layout of wgmma: the tile is cut into 8 x 8 core matrices (8
// rows of 16 bytes, stored as 128 contiguous bytes); the core matrices of
// one 8-column slice are stacked down the rows, and the slices follow one
// another, so element (r, c) sits at ((c / 8) 64 + r) 8 + c % 8. Rows of 72
// or 80 bf16 (144 or 160 bytes) fit none of the 32/64/128-byte swizzle
// modes; the interleave layout takes any multiple of 8 columns and has no
// bank conflicts (a core matrix is one 128-byte line). In a descriptor of
// this layout the leading byte offset is the step between core matrices
// along the product's depth (K) and the stride byte offset the step along
// M or N: a K-major operand (rows = M or N, columns = K: q and k in q . k^T,
// k and q_s in k . q_s^T) takes 1024 / 128, an MN-major one (rows = K, read
// with the transpose bit: v in p . v, do and q_s in P^T . do and dS^T . q_s,
// k in dS . k) 128 / 1024, so one layout serves every operand. The head dim
// is padded to DK, a multiple of 16 (the depth of one product): 72 -> 80,
// 32 -> 32; columns d .. DK - 1 are zero.
//
// Tiles arrive by cp.async in a ring of kStages slots; rows past the end are
// zero-filled (src-size 0). The copy width VEC (8, 4, 2 or 1 bf16 values) is
// a template parameter: 16-byte copies need every row to start on a 16-byte
// boundary (d % 8 == 0 and aligned base pointers); VEC = 1 copies 2-byte
// values with plain loads and stores.
#pragma once

#include <cstdint>

#include "flash.cuh"

namespace maa3_flash {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;        // key/value tiles in flight per block
constexpr int kTcThreads = 256;   // two warpgroups
constexpr int kFwdRows = 128;     // query rows per block, 64 per warpgroup

// The padding of the head dim for the products' depth (a multiple of 16).
__host__ __device__ constexpr int mma_k_dim(int dp) { return (dp + 15) / 16 * 16; }

template <int VEC>
struct alignas(2 * VEC) Pack {
  bf16 x[VEC];
};

// The widest copy every row allows: VEC values of 2 bytes need d % VEC == 0
// and base pointers (or'ed together in `bits`) aligned to 2 VEC bytes.
inline int copy_vec(int d, uintptr_t bits) {
  for (int vec = 8; vec > 1; vec /= 2)
    if (d % vec == 0 && bits % (2 * vec) == 0) return vec;
  return 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One VEC-wide copy of global row data into shared memory; zeros if !in.
template <int VEC>
__device__ __forceinline__ void copy_async(bf16* dst, const bf16* src, bool in) {
  if constexpr (VEC > 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(2 * VEC), "r"(in ? 2 * VEC : 0) : "memory");
  } else {
    *dst = in ? *src : __float2bfloat16(0.0f);
  }
}

// One 4-byte value (an int32 mask entry, an fp32 lse or delta); zero if !in.
__device__ __forceinline__ void copy_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Two fp32 values rounded to bf16 and packed (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Offset of element (r, c) of a tile of ROWS rows in the interleave layout.
template <int ROWS>
__device__ __forceinline__ int core_off(int r, int c) {
  return ((c >> 3) * ROWS + r) * 8 + (c & 7);
}

// A shared-memory matrix descriptor of the interleave layout: start address,
// leading (K-direction) and stride (M/N-direction) byte offsets between
// core matrices.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory (stores and
// completed cp.async copies) before later reads by wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a . b, m64n64k16, a and b from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a . b, m64nNk16 (N = 72 or 32), a from registers (the m16n8k16 A
// fragment layout, per warp), b from shared memory, MN-major (transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<72>(float (&d)[36], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= a . b, m64nNk16 (N = 40, 32 or 16), a and b from shared memory, both
// MN-major (read with the transpose bits): K4a's dQ = dS . k, with
// dS stored as dS^T (keys as rows) and k as stored (keys as rows)
template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da, uint64_t db,
                                            int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss_tt<40>(float (&d)[20], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19}, "
      "%20, %21, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<32>(float (&d)[16], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<16>(float (&d)[8], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The accumulator of a 64 x 64 tile as the bf16 A fragments of its four
// 16-column slices (the accumulator layout is the A fragment layout, so the
// scores stay in registers)
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// Rows [r0, r0 + 64) of an (n, d) matrix into a 64-row interleave tile,
// columns < d; rows past n are zero. Consecutive threads take consecutive
// rows of one column slice, so 8 threads fill one 128-byte core matrix;
// their global reads are 16-byte pieces of 8 rows, and the L1-cached copies
// (.ca) serve the neighbouring piece of each 32-byte sector to the next
// slice. Asynchronous for VEC > 1.
template <int VEC>
__device__ __forceinline__ void copy_tile(bf16* s, const bf16* g, int r0, int n, int d) {
  const int chunks = kTile * (d / VEC);
  for (int i = threadIdx.x; i < chunks; i += kTcThreads) {
    const int r = i & (kTile - 1), c = (i >> 6) * VEC;
    const bool in = r0 + r < n;
    copy_async<VEC>(s + core_off<kTile>(r, c),
                    in ? g + static_cast<size_t>(r0 + r) * d + c : g, in);
  }
}

// The scaled q rows [r0, r0 + kFwdRows) of (n, d) (q * mul in fp32, rounded
// to bf16: the JAX `_scale_q`) as two 64-row interleave tiles of TILE
// elements; rows past n are zero.
template <int VEC, int TILE>
__device__ __forceinline__ void load_q_scaled(bf16* s, const bf16* g, int r0, int n, int d,
                                              float mul) {
  const int chunks = kFwdRows * (d / VEC);
  for (int i = threadIdx.x; i < chunks; i += kTcThreads) {
    const int r = i & (kFwdRows - 1), c = (i >> 7) * VEC;
    Pack<VEC> v;
    if (r0 + r < n) {
      v = *reinterpret_cast<const Pack<VEC>*>(g + static_cast<size_t>(r0 + r) * d + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.x[e] = __float2bfloat16(__bfloat162float(v.x[e]) * mul);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.x[e] = __float2bfloat16(0.0f);
    }
    *reinterpret_cast<Pack<VEC>*>(s + (r >> 6) * TILE + core_off<kTile>(r & (kTile - 1), c)) = v;
  }
}

// Zero columns [d, DK) of `tiles` consecutive 64-row interleave tiles of DK
// columns each.
template <int DK>
__device__ __forceinline__ void zero_pad(bf16* s, int tiles, int d) {
  const int w = DK - d;
  for (int i = threadIdx.x; i < tiles * kTile * w; i += kTcThreads) {
    const int t = i / (kTile * w), rest = i - t * kTile * w;
    const int r = rest / w;
    s[t * kTile * DK + core_off<kTile>(r, d + rest - r * w)] = __float2bfloat16(0.0f);
  }
}

// ok[j][c]: key k0 + 8j + 2 (lane % 4) + c exists and is not masked out. With
// a mask, ms holds the tile's 64 mask values (0 past Lk); without, the keys
// are checked against lk.
__device__ __forceinline__ void tile_valid(bool (&ok)[8][2], const int* ms, bool masked,
                                           int k0, int lk, int lane) {
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (masked) {
      const int2 w = *reinterpret_cast<const int2*>(ms + 8 * j + c0);
      ok[j][0] = w.x != 0;
      ok[j][1] = w.y != 0;
    } else {
      ok[j][0] = k0 + 8 * j + c0 < lk;
      ok[j][1] = k0 + 8 * j + c0 + 1 < lk;
    }
  }
}

// 2^x in one MUFU.EX2 (ex2.approx.ftz: relative error about 2^-22; results
// below 2^-126 flush to 0, far under the bf16 rounding of p that follows)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// m = max(m, s) per fragment row over this lane's keys of the tile, the
// valid ones only when CHECK (without it every key of the tile is valid)
template <bool CHECK>
__device__ __forceinline__ void tile_max(float (&m)[2], const float (&s)[8][4],
                                         const bool (&ok)[8][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!CHECK || ok[j][e & 1]) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
}

// s = p = exp2(s - m) (0 for invalid keys when CHECK), added to l
template <bool CHECK>
__device__ __forceinline__ void tile_exp(float (&s)[8][4], const float (&m)[2], float (&l)[2],
                                         const bool (&ok)[8][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(s[j][e] - m[e >> 1]);
      s[j][e] = (!CHECK || ok[j][e & 1]) ? p : 0.0f;
      l[e >> 1] += s[j][e];
    }
}

// max / sum over the 4 lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace maa3_flash
