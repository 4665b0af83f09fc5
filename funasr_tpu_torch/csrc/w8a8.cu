// W8A8 linear for Hopper (sm_90a), plain C interface loaded with ctypes.
//
//   sx[m]     = max(max_k |x[m, k]|, 1e-6) * fl(1/127)                       (fp32)
//   x_q[m, k] = clamp(rint(x[m, k] / sx[m]), -127, 127)                       (int8)
//   y[m, n]   = fma(float(sum_k x_q[m, k] * w_q[n, k]), sx[m] * scale[n], bias[n])
//
// rounded once to x's dtype (without a bias: float(acc) * (sx[m] * scale[n])).
// Replaces the TPU kernel benchmarks/bench_pallas_w8a8.py::w8a8_matmul, which fuses
// the per-row activation quantization into an int8 x int8 -> int32 product with a
// scale epilogue. The numerics are those of the path it serves,
// funasr_tpu/ops/quant.py::qlinear's "w_q8" branch, as XLA compiles it under jit:
// the division by the constant 127 becomes a product with fl(1/127), x / sx stays an
// IEEE division, rint rounds half to even, and the bias add contracts into one fma.
// The int32 sums are exact in any order, so the kernel is bit-exact to the plain
// PyTorch version (funasr_tpu_torch/ops/w8a8.py::w8a8_linear_ref). No fast-math.
//
// Bound. At the path's shapes (M = 6656-12288 rows, K, N in 512-2048) the product is
// compute bound: K int8 MACs per output against 2 bytes of x read once per N tile.
// The int8 tensor cores (mma.sync m16n8k32 s8) double bf16's rate.
//
// Design. Two kernels on one stream, launched by one entry point:
// 1. quantize_rows: one warp per row computes sx and writes x_q into a scratch buffer
//    padded to (Mp, Kp) = (BM, BK) multiples with zeros, so each division happens once.
//    (The TPU kernel quantizes x inside the GEMM; on this card that repeats the IEEE
//    division -- about 15 instructions -- for every N tile, ~3x the tile's mma time.)
// 2. gemm: 128 x 128 output tiles, 8 warps of 64 x 32, K in 64-byte steps through a
//    4-stage cp.async ring in shared memory. Rows are padded to 80 bytes, so the
//    32-bit fragment loads hit 32 distinct banks. Weights stay (N, K) row-major, which
//    is the ".col" B operand as stored: no transpose at run time. The K tail of the
//    weights and the N edge are zero-filled in shared memory; the fused scale / bias
//    epilogue writes straight from the accumulators, bounds-checked.
//
// x is (M, K) with unit column stride and any row stride; w_q (N, K) int8 contiguous;
// scale (N,) fp32; bias (N,) fp32 or bf16, or NULL; out (M, N) contiguous in x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows per GEMM block (and the x_q row padding)
constexpr int BN = 128;          // columns per GEMM block
constexpr int BK = 64;           // int8 depth per stage (and the x_q column padding)
constexpr int LDS = BK + 16;     // shared row pitch in bytes: conflict-free fragments
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int QROWS = 8;         // rows per quantize block (one warp each)
constexpr float INV127 = 1.0f / 127.0f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ int quant(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

template <typename T>
__global__ void __launch_bounds__(QROWS * 32)
quantize_rows_kernel(const T* __restrict__ x, long long xs, int M, int K, int Mp, int Kp,
                     int8_t* __restrict__ xq, float* __restrict__ sx) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (m >= Mp) return;
  uint32_t* qrow = reinterpret_cast<uint32_t*>(xq + (long long)m * Kp);
  if (m >= M) {  // padding rows of the last GEMM tile
    for (int k = lane * 4; k < Kp; k += 128) qrow[k >> 2] = 0u;
    return;
  }
  const T* row = x + m * xs;
  float amax = 0.0f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f(row[k])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, 1e-6f), INV127);
  if (lane == 0) sx[m] = s;
  for (int k = lane * 4; k < Kp; k += 128) {
    uint32_t packed = 0u;
    for (int j = 0; j < 4; ++j) {
      const int q = k + j < K ? quant(to_f(row[k + j]), s) : 0;
      packed |= (uint32_t)(q & 0xff) << (8 * j);
    }
    qrow[k >> 2] = packed;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: the (BM, BK) x_q tile (always in bounds: the scratch is padded) and the
// (BN, BK) weight tile, 16-byte chunks, two of each per thread. VEC_B: K % 16 == 0 and
// a 16-byte aligned w, so a weight chunk is wholly inside or wholly outside [0, K).
template <bool VEC_B>
__device__ __forceinline__ void load_stage(int8_t* As, int8_t* Bs, const int8_t* xq,
                                           const int8_t* w, int m0, int n0, int k0, int N,
                                           int K, int Kp) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c >> 2, kc = (c & 3) * 16;
    cp_async16(As + r * LDS + kc, xq + (long long)(m0 + r) * Kp + k0 + kc, 16);
    const int n = n0 + r, k = k0 + kc;
    if (VEC_B) {
      const bool ok = n < N && k < K;
      cp_async16(Bs + r * LDS + kc, ok ? w + (long long)n * K + k : w, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (n < N)
        for (int j = 0; j < 16; ++j)
          if (k + j < K) v[j >> 2] |= (uint32_t)(uint8_t)w[(long long)n * K + k + j] << (8 * (j & 3));
      *reinterpret_cast<uint4*>(Bs + r * LDS + kc) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <typename T, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ bias_f, const bf16* __restrict__ bias_h,
            T* __restrict__ out, int M, int N, int K, int Kp) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = Kp / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto As = [&](int s) { return smem + s * (BM + BN) * LDS; };
  auto Bs = [&](int s) { return smem + s * (BM + BN) * LDS + BM * LDS; };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage<VEC_B>(As(s), Bs(s), xq, w, m0, n0, s * BK, N, K, Kp);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage<VEC_B>(As(nk % STAGES), Bs(nk % STAGES), xq, w, m0, n0, nk * BK, N, K, Kp);
    cp_async_commit();

    const int8_t* a_s = As(kt % STAGES);
    const int8_t* b_s = Bs(kt % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = a_s + (wm + mi * 16 + g) * LDS + kk + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = b_s + (wn + ni * 8 + g) * LDS + kk + tig * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at row g, c2, c3 at row g + 8; columns 2 * tig, 2 * tig + 1
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + h * 8;
      if (m >= M) continue;
      const float sm = sx[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + tig * 2 + j;
          if (n >= N) continue;
          const float af = __int2float_rn(acc[mi][ni][h * 2 + j]);
          const float s = __fmul_rn(sm, scale[n]);
          float y;
          if (bias_f) y = __fmaf_rn(af, s, bias_f[n]);
          else if (bias_h) y = __fmaf_rn(af, s, __bfloat162float(bias_h[n]));
          else y = __fmul_rn(af, s);
          out[(long long)m * N + n] = from_f<T>(y);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long xs, const void* w, const float* scale,
                   const void* bias, int bias_dtype, void* xq, float* sx, void* out, int M,
                   int N, int K, int Mp, int Kp, cudaStream_t stream) {
  quantize_rows_kernel<T><<<(Mp + QROWS - 1) / QROWS, QROWS * 32, 0, stream>>>(
      static_cast<const T*>(x), xs, M, K, Mp, Kp, static_cast<int8_t*>(xq), sx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool vec_b = K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = vec_b ? gemm_kernel<T, true> : gemm_kernel<T, false>;
  const int bytes = STAGES * (BM + BN) * LDS;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, Mp / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const int8_t*>(xq), sx, static_cast<const int8_t*>(w), scale,
      bias_dtype == 1 ? static_cast<const float*>(bias) : nullptr,
      bias_dtype == 2 ? static_cast<const bf16*>(bias) : nullptr, static_cast<T*>(out), M, N,
      K, Kp);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. xs: row stride of x in elements.
// bias_dtype: 0 = no bias, 1 = float32, 2 = bfloat16. xq: (Mp, Kp) int8 scratch and sx:
// (Mp,) fp32 scratch, Mp a multiple of 128 >= M and Kp a multiple of 64 >= K.
extern "C" int w8a8_linear_fwd(int dtype, const void* x, long long xs, const void* w,
                               const void* scale, const void* bias, int bias_dtype, void* xq,
                               void* sx, void* out, int M, int N, int K, int Mp, int Kp,
                               void* stream) {
  if (M < 1 || N < 1 || K < 1 || Mp < M || Mp % BM || Kp < K || Kp % BK || Mp / BM > 65535 ||
      bias_dtype < 0 || bias_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* sxf = static_cast<float*>(sx);
  if (dtype == 0)
    return (int)launch<float>(x, xs, w, sc, bias, bias_dtype, xq, sxf, out, M, N, K, Mp, Kp, s);
  if (dtype == 1)
    return (int)launch<bf16>(x, xs, w, sc, bias, bias_dtype, xq, sxf, out, M, N, K, Mp, Kp, s);
  return (int)cudaErrorInvalidValue;
}
