// Fused [anti-aliased snake -> dilated Conv1d + bias] over (B, C_in, T) ->
// (B, C_out, T): the BigVGAN act->conv site.
//
// Replaces the TPU kernel maa3_tpu/ops/pallas_amp.py::_conv_snake_fused
// (:165, pallas_call at :203; body _kernel :46).
//
// What bounds it on the H100: at the narrow vocoder stages it runs on
// (C <= 48, T up to 160k) the conv is 2 * C_out * C_in * k operations per
// output sample and the activation about 56 fp32 operations per input
// sample, against a few bytes of input and output; unfused, the activation
// output would also make a full round trip through DRAM before the conv
// reads it k times. A block computes the activation for all C_in channels
// over its time tile widened by the conv halo E = (k*d - d)/2 (zero outside
// [0, T), the conv's zero padding; rounded to the storage type, as the
// unfused path stores it), then the conv from shared memory, with the
// weights rounded to the storage type, fp32 sums and the bias added in fp32.
//
// bf16 (conv_snake_tc_kernel) runs the conv on the tensor cores:
// - A persistent block of 8 warps stages the weights once, bf16, as
//   w_j[o][c] for each tap j (C_out padded to NT * 8, C_in to C_pad, a
//   multiple of 16), then walks (batch, 256-sample) tiles.
// - Activation: every thread computes 16 consecutive outputs of one channel
//   in registers (maa3::act_run of snake.cuh, shared with K1: 32 input
//   samples, 22 pairs of snake phases, a 12-tap decimation), so the stage
//   takes no block barrier per channel; the lanes of a warp take
//   consecutive channels, so their bf16 stores into the time-major tile
//   act[t][c] (row pitch C_pad + 8: conflict-free ldmatrix rows) hit
//   distinct banks. Runs that touch the signal's ends take the clamped
//   loads and edge rules of maa3::act_run_generic; the rest load x in
//   16-byte pieces.
// - Conv as an implicit GEMM: out^T (time x C_out) = sum_j act[t + j d - E, :]
//   . w_j^T on mma.sync m16n8k16 (bf16 in, fp32 accumulators initialised to
//   the bias). Each warp owns 32 output samples and all NT n-tiles; the A
//   fragments of tap j come by ldmatrix from the act tile shifted by j d
//   rows (any shift: ldmatrix takes one row address per lane), the B
//   fragments by ldmatrix from the staged weights.
// - Output: the accumulators go through shared memory (aliasing the act
//   tile) so that the stores to (B, C_out, T) are 16-byte pieces along time.
// fp32 (conv_snake_kernel) keeps the scalar route, since the tensor cores
// would take fp32 only as TF32: a block owns one batch element and 256
// output samples, computes the activation channel by channel with the
// shared-memory phases of snake.cuh, then runs the conv as an fp32 FMA loop
// (each thread one output step and 8 output channels).
#include <cstdint>

#include "snake.cuh"

namespace {

constexpr int kTile = 256;     // output samples per block == threads
constexpr int kOc = 8;         // output channels per register chunk

// Shared-memory layout in floats: yact [c_in][W], xs [W + 12], se and so
// [W + 6] each, then the weight chunk [c_in][k][kOc], 16-byte aligned.
__host__ __device__ inline int wch_offset(int c_in, int W) {
  return ((c_in + 3) * W + 24 + 3) / 4 * 4;
}
__host__ __device__ inline size_t smem_floats(int c_in, int k, int dil) {
  const int W = kTile + (k * dil - dil);
  return static_cast<size_t>(wch_offset(c_in, W)) +
         static_cast<size_t>(c_in) * k * kOc;
}

template <typename T>
__global__ void __launch_bounds__(kTile)
conv_snake_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const float* __restrict__ alpha,
                  const float* __restrict__ beta,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  int c_in, int c_out, int n, int k, int dil, bool has_beta,
                  bool logscale, bool fast) {
  extern __shared__ float smem[];
  const int E = (k * dil - dil) / 2;
  const int W = kTile + 2 * E;               // act outputs the conv reads
  float* yact = smem;                        // [c_in][W]
  float* xs = yact + c_in * W;               // [W + 12]
  float* se = xs + W + 12;                   // [W + 6]
  float* so = se + W + 6;                    // [W + 6]
  float* wch = smem + wch_offset(c_in, W);   // [c_in][k][kOc]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int g0 = t0 - E;

  for (int c = 0; c < c_in; ++c) {
    float a, ib;
    maa3::snake_coeffs(alpha, beta, c, has_beta, logscale, &a, &ib);
    const T* xrow = x + (static_cast<size_t>(b) * c_in + c) * n;
    maa3::snake_phases(xrow, n, g0, W, a, ib, fast, xs, se, so);
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      int g = g0 + l;
      float v = (g >= 0 && g < n) ? maa3::down_at(se, so, l) : 0.0f;
      yact[c * W + l] = maa3::round_as(v, x);
    }
  }

  const int t = threadIdx.x;
  for (int o0 = 0; o0 < c_out; o0 += kOc) {
    __syncthreads();  // yact complete / previous chunk's weights consumed
    for (int i = threadIdx.x; i < c_in * k * kOc; i += blockDim.x) {
      int oo = i % kOc, cj = i / kOc;        // cj = c * k + j
      int o = o0 + oo;
      float v = o < c_out ? w[static_cast<size_t>(o) * c_in * k + cj] : 0.0f;
      wch[i] = maa3::round_as(v, x);
    }
    __syncthreads();
    if (t0 + t >= n) continue;
    float acc[kOc];
#pragma unroll
    for (int oo = 0; oo < kOc; ++oo)
      acc[oo] = o0 + oo < c_out ? bias[o0 + oo] : 0.0f;
    for (int c = 0; c < c_in; ++c) {
      const float* yc = yact + c * W + t;
      const float4* wc = reinterpret_cast<const float4*>(wch + c * k * kOc);
      for (int j = 0; j < k; ++j) {
        float v = yc[j * dil];
        float4 w0 = wc[2 * j], w1 = wc[2 * j + 1];
        acc[0] += w0.x * v; acc[1] += w0.y * v;
        acc[2] += w0.z * v; acc[3] += w0.w * v;
        acc[4] += w1.x * v; acc[5] += w1.y * v;
        acc[6] += w1.z * v; acc[7] += w1.w * v;
      }
    }
#pragma unroll
    for (int oo = 0; oo < kOc; ++oo)
      if (o0 + oo < c_out)
        maa3::store_f(y + (static_cast<size_t>(b) * c_out + o0 + oo) * n + t0 + t,
                      acc[oo]);
  }
}

template <typename T>
int launch(const void* x, void* y, const float* alpha, const float* beta,
           const float* w, const float* bias, int batch, int c_in, int c_out,
           int n, int k, int dil, int has_beta, int logscale, int fast,
           cudaStream_t stream) {
  size_t smem = sizeof(float) * smem_floats(c_in, k, dil);
  auto kern = conv_snake_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + kTile - 1) / kTile, batch);
  kern<<<grid, kTile, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), alpha, beta, w, bias, c_in,
      c_out, n, k, dil, has_beta != 0, logscale != 0, fast != 0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcTime = 256;     // output samples per tile: 8 warps x 32
constexpr int kTcThreads = 256;
constexpr int kMaxCh = 64;       // C_in and C_out the bf16 route takes
constexpr int kRun = 16;         // activation outputs per thread and task
constexpr int kOutPitch = kTcTime + 8;  // row pitch of the output tile

struct ConvArgs {
  const bf16* x;       // (B, C_in, T)
  bf16* y;             // (B, C_out, T)
  const float* alpha;  // (C_in,)
  const float* beta;   // (C_in,)
  const float* w;      // (C_out, C_in, k) fp32
  const float* bias;   // (C_out,) fp32
  int batch, c_in, c_out, n, k, dil;
  int has_beta, logscale, fast;
  int vec;             // x and y rows start on 16-byte boundaries
};

// n-tiles of 8 output channels an instantiation covers
__host__ __device__ inline int n_tiles(int c_out) {
  const int nt = (c_out + 7) / 8;
  return nt == 5 ? 6 : (nt == 7 ? 8 : nt);
}

// Shared-memory layout of the bf16 kernel: snake coefficients and bias
// (fp32, kMaxCh each), the weights [k][NO][pitch], then the act tile
// [rows][pitch], whose space the output tile [NO][kOutPitch] reuses.
struct TcLayout {
  int cpad, pitch, no, halo, rows;
  size_t w_off, act_off, bytes;
};

__host__ __device__ inline TcLayout tc_layout(int c_in, int c_out, int k, int dil) {
  TcLayout l;
  l.cpad = (c_in + 15) / 16 * 16;
  l.pitch = l.cpad + 8;  // 8 ldmatrix rows fall on 8 distinct 16-byte bank groups
  l.no = 8 * n_tiles(c_out);
  l.halo = (k * dil - dil) / 2;
  l.rows = kTcTime + 2 * l.halo;
  const size_t act = static_cast<size_t>(l.rows) * l.pitch;
  const size_t out = static_cast<size_t>(l.no) * kOutPitch;
  l.w_off = 3 * kMaxCh * sizeof(float);
  l.act_off = l.w_off + sizeof(bf16) * static_cast<size_t>(k) * l.no * l.pitch;
  l.bytes = l.act_off + sizeof(bf16) * (act > out ? act : out);
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a . b, m16n8k16, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Output l of a run as row r0 + l, column c of the act tile (rows outside
// [0, rows) belong to another tile).
__device__ __forceinline__ void put_act(bf16* act, int pitch, int c, int r0, int rows, int l,
                                        float y) {
  const int r = r0 + l;
  if (r >= 0 && r < rows) act[r * pitch + c] = __float2bfloat16(y);
}

// Where maa3::act_run's outputs go: output l of a run as row r0 + l, column c
// of the act tile.
struct ActColumn {
  bf16* act;
  int pitch, c, r0, rows;
  __device__ __forceinline__ void operator()(int l, float y) const {
    put_act(act, pitch, c, r0, rows, l, y);
  }
};

// The same for maa3::act_run_generic, whose outputs outside [0, n) are the
// conv's zero padding.
struct ActColumnPadded {
  ActColumn col;
  int gs, n;
  __device__ __forceinline__ void operator()(int l, float y) const {
    col(l, (gs + l >= 0 && gs + l < n) ? y : 0.0f);
  }
};

template <int NT>
__global__ void __launch_bounds__(kTcThreads, 2) conv_snake_tc_kernel(ConvArgs a) {
  constexpr int NO = NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcLayout L = tc_layout(a.c_in, a.c_out, a.k, a.dil);
  const int P = L.pitch, n = a.n;
  float* ca = reinterpret_cast<float*>(smem_raw);           // snake a per channel
  float* cib = ca + kMaxCh;                                 // 1 / (b + 1e-9)
  float* bs = cib + kMaxCh;                                 // bias, 0 past C_out
  bf16* ws = reinterpret_cast<bf16*>(smem_raw + L.w_off);   // [k][NO][P] bf16(w[o][c][j])
  bf16* act = reinterpret_cast<bf16*>(smem_raw + L.act_off);  // [rows][P]; output [NO][kOutPitch]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // once per block: coefficients, bias and weights (zero past C_in / C_out)
  for (int c = tid; c < a.c_in; c += kTcThreads)
    maa3::snake_coeffs(a.alpha, a.beta, c, a.has_beta != 0, a.logscale != 0, ca + c, cib + c);
  for (int o = tid; o < NO; o += kTcThreads) bs[o] = o < a.c_out ? a.bias[o] : 0.0f;
  for (int oc = tid; oc < NO * L.cpad; oc += kTcThreads) {
    const int o = oc / L.cpad, c = oc - o * L.cpad;
    const bool in = o < a.c_out && c < a.c_in;
    const float* wj = a.w + (static_cast<size_t>(o) * a.c_in + c) * a.k;
    for (int j = 0; j < a.k; ++j)
      ws[(j * NO + o) * P + c] = __float2bfloat16(in ? wj[j] : 0.0f);
  }
  __syncthreads();

  const int tiles = (n + kTcTime - 1) / kTcTime;
  // ldmatrix row addresses of this lane: A rows 32 warp + (lane % 16) at
  // columns 8 (lane / 16); B (the weights of two n-tiles) rows
  // 8 (lane / 16) + lane % 8 at columns 8 ((lane / 8) % 2)
  const uint32_t a_lane = smem_u32(act) + 2 * ((32 * warp + (lane & 15)) * P + (lane >> 4) * 8);
  const uint32_t b_lane =
      smem_u32(ws) + 2 * (((lane >> 4) * 8 + (lane & 7)) * P + ((lane >> 3) & 1) * 8);
  for (int tile = blockIdx.x; tile < tiles * a.batch; tile += gridDim.x) {
    const int b = tile / tiles, t0 = (tile - b * tiles) * kTcTime, g0 = t0 - L.halo;

    // the activation over rows g0 .. g0 + rows - 1, in runs of kRun aligned
    // to multiples of kRun; the lanes of a warp take consecutive channels
    const int gb = g0 - ((g0 % kRun) + kRun) % kRun;
    const int runs = (g0 + L.rows - gb + kRun - 1) / kRun;
    const bf16* xb = a.x + static_cast<size_t>(b) * a.c_in * n;
    for (int task = tid; task < runs * a.c_in; task += kTcThreads) {
      const int c = task % a.c_in, gs = gb + kRun * (task / a.c_in), r0 = gs - g0;
      const bf16* xrow = xb + static_cast<size_t>(c) * n;
      if (gs >= n || gs + kRun <= 0) {
#pragma unroll
        for (int l = 0; l < kRun; ++l) put_act(act, P, c, r0, L.rows, l, 0.0f);
      } else if (a.vec && a.fast && gs >= 8 && gs + kRun + 8 <= n) {
        ActColumn col{act, P, c, r0, L.rows};
        maa3::act_run<kRun, true>(xrow, gs, ca[c], cib[c], col);
      } else {
        maa3::act_run_generic<kRun>(xrow, n, gs, ca[c], cib[c], a.fast != 0,
                                    ActColumnPadded{{act, P, c, r0, L.rows}, gs, n});
      }
    }
    if (a.c_in < L.cpad) {  // the padded channels are the product's zero depth
      const int wpad = L.cpad - a.c_in;
      for (int i = tid; i < L.rows * wpad; i += kTcThreads)
        act[(i / wpad) * P + a.c_in + i % wpad] = __float2bfloat16(0.0f);
    }
    __syncthreads();

    // out^T[t][o] = bias[o] + sum_j sum_c act[t + j d][c] w_j[o][c]
    float acc[2][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][nt][e] = bs[nt * 8 + 2 * (lane & 3) + (e & 1)];
        acc[1][nt][e] = acc[0][nt][e];
      }
    for (int j = 0; j < a.k; ++j) {
      const uint32_t arow = a_lane + 2 * j * a.dil * P;
      const uint32_t brow = b_lane + 2 * j * NO * P;
      for (int kc = 0; kc < L.cpad / 16; ++kc) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, arow + 32 * kc);
        ldmatrix_x4(a1, arow + 2 * 16 * P + 32 * kc);
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr) {
          uint32_t bq[4];
          ldmatrix_x4(bq, brow + 2 * 16 * pr * P + 32 * kc);
          mma_bf16(acc[0][2 * pr], a0, bq[0], bq[1]);
          mma_bf16(acc[1][2 * pr], a1, bq[0], bq[1]);
          mma_bf16(acc[0][2 * pr + 1], a0, bq[2], bq[3]);
          mma_bf16(acc[1][2 * pr + 1], a1, bq[2], bq[3]);
        }
        if constexpr (NT % 2 == 1) {
          uint32_t bq[2];
          ldmatrix_x2(bq, brow + 2 * 8 * (NT - 1) * P + 32 * kc);
          mma_bf16(acc[0][NT - 1], a0, bq[0], bq[1]);
          mma_bf16(acc[1][NT - 1], a1, bq[0], bq[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the act tile

    // the output tile [o][t] in bf16, then 16-byte stores along time
    bf16* os = act;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 32 * warp + 16 * mi + (lane >> 2) + 8 * (e >> 1);
          const int o = nt * 8 + 2 * (lane & 3) + (e & 1);
          if (o < a.c_out) os[o * kOutPitch + t] = __float2bfloat16(acc[mi][nt][e]);
        }
    __syncthreads();
    const int tt = n - t0 < kTcTime ? n - t0 : kTcTime;
    bf16* yb = a.y + static_cast<size_t>(b) * a.c_out * n + t0;
    for (int i = tid; i < a.c_out * (kTcTime / 8); i += kTcThreads) {
      const int o = i / (kTcTime / 8), t8 = (i % (kTcTime / 8)) * 8;
      if (t8 >= tt) continue;
      bf16* dst = yb + static_cast<size_t>(o) * n + t8;
      const bf16* src = os + o * kOutPitch + t8;
      if (a.vec && t8 + 8 <= tt) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && t8 + e < tt; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();  // the next tile's act writes reuse the output tile
  }
}

template <int NT>
int launch_tc_nt(const ConvArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = &conv_snake_tc_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kTcThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>(a.batch) * ((a.n + kTcTime - 1) / kTcTime);
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (tiles == 0) return 0;
  const unsigned grid = static_cast<unsigned>(tiles < fill ? tiles : fill);
  kern<<<grid, kTcThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const ConvArgs& a, cudaStream_t stream) {
  if (a.c_in < 1 || a.c_in > kMaxCh || a.c_out < 1 || a.c_out > kMaxCh)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc_layout(a.c_in, a.c_out, a.k, a.dil).bytes;
  switch (n_tiles(a.c_out)) {
    case 1: return launch_tc_nt<1>(a, smem, stream);
    case 2: return launch_tc_nt<2>(a, smem, stream);
    case 3: return launch_tc_nt<3>(a, smem, stream);
    case 4: return launch_tc_nt<4>(a, smem, stream);
    case 6: return launch_tc_nt<6>(a, smem, stream);
    default: return launch_tc_nt<8>(a, smem, stream);
  }
}

}  // namespace

// Shared memory the kernel needs for these shapes and dtype (0 = float32,
// 1 = bfloat16), in bytes; -1 where the bf16 route does not take them
// (C_in or C_out past 64).
extern "C" long long maa3_conv_snake_smem(int c_in, int c_out, int k, int dil, int dtype) {
  if (dtype == 1) {
    if (c_in < 1 || c_in > kMaxCh || c_out < 1 || c_out > kMaxCh) return -1;
    return static_cast<long long>(tc_layout(c_in, c_out, k, dil).bytes);
  }
  return static_cast<long long>(sizeof(float) * smem_floats(c_in, k, dil));
}

// w: (c_out, c_in, k) fp32, bias: (c_out,) fp32; dtype: 0 = float32,
// 1 = bfloat16 for x and y. Returns the cudaError_t of the launch.
extern "C" int maa3_conv_snake(const void* x, void* y, const void* alpha,
                               const void* beta, const void* w,
                               const void* bias, int batch, int c_in,
                               int c_out, int n, int k, int dil, int dtype,
                               int has_beta, int logscale, int fast,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(alpha);
  auto bt = static_cast<const float*>(beta);
  auto wp = static_cast<const float*>(w);
  auto bp = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch<float>(x, y, a, bt, wp, bp, batch, c_in, c_out, n, k, dil,
                         has_beta, logscale, fast, s);
  if (dtype == 1) {
    const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0 && n % 8 == 0);
    ConvArgs c{static_cast<const bf16*>(x), static_cast<bf16*>(y), a, bt, wp, bp,
               batch, c_in, c_out, n, k, dil, has_beta, logscale, fast, vec};
    return launch_tc(c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
