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
// Bound (NVIDIA H100 80GB HBM3 at 700 W: 3.35 TB/s, 1,979 TOP/s int8). At the path's
// shapes the bytes bound it: at (M, K, N) = (12288, 512, 2048) x (bf16), w (int8) and
// out (bf16) are 63.9 MB, 19.1 us, against 25.8 G int8 operations, 13.0 us; most of
// the bytes are the output.
//
// Design. Two kernels on one stream, launched by one entry point:
// 1. quantize_rows: 32-256 threads per row (16-32 values each) read the row once in
//    16-byte vectors and keep it in registers (up to 8,192 values; longer rows are read
//    again), take the row max (shuffles, then shared memory across warps), and write
//    x_q with 16-byte stores into an (M, Kp) int8 scratch, Kp = K rounded up to 16
//    (zeros above K). Each quotient x / sx is taken once, as a product with fl(1 / sx)
//    checked against the rounding boundary (see quant()). (The TPU kernel quantizes x
//    inside the GEMM; on this card that repeats the work for every N tile.)
// 2. gemm: persistent, one block per SM walking 128 x 128 output tiles. One producer
//    warp feeds a ring of 128-byte K slices of x_q and w_q in shared memory by TMA
//    (128-byte swizzle, full / empty mbarriers; TMA zero-fills the M, N and K edges).
//    Two consumer warpgroups take alternate tiles (ping-pong): each runs wgmma
//    m64n128k32 s8 x s8 -> s32 from shared memory for its tile's two 64-row halves
//    (both operands K-major as stored: w_q stays (N, K)), then its epilogue: the scale /
//    bias fma in registers, the tile staged in shared memory and written by TMA stores,
//    which clip at the edges. The epilogue -- int -> float and bf16 conversions run at a
//    quarter of the fp32 rate, and at these small K it costs as much as the products
//    and loads -- thus overlaps the other warpgroup's products and the producer's
//    loads, and the output write, the bound, overlaps both.
//
// x is (M, K) with unit column stride and any row stride; w_q (N, Kp) int8 contiguous
// (the wrapper pads K to a multiple of 16 with zeros); scale (N,) fp32; bias (N,) fp32
// or bf16, or NULL; out (M, N) with row pitch out_pitch (a multiple of 16 bytes) in x's
// dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;          // rows of a GEMM tile (one consumer warpgroup)
constexpr int BN = 128;          // columns of a GEMM tile
constexpr int BK = 128;          // int8 depth per stage: one 128-byte swizzled row
constexpr int QTHREADS = 256;    // threads per quantize block
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use
constexpr float INV127 = 1.0f / 127.0f;

typedef __nv_bfloat16 bf16;

// ---- row quantization -------------------------------------------------------------------

// clamp(rint(v / s), -127, 127) with v / s the IEEE quotient, r = fl(1 / s). Fast path:
// t = fl(v * r) is within 2^-23 |v / s| <= 1.6e-5 of v / s, and fl(v / s) within 2^-24
// |v / s| of it (|v / s| <= 127 here), so wherever t lies further than 2^-12 from a
// half-integer, rint(t) == rint(fl(v / s)) exactly; only there (and for NaN) is the
// IEEE division computed. Same result, bit for bit, for a few instructions.
__device__ __forceinline__ int quant(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  const float q = fabsf(t - floorf(t) - 0.5f) > 0x1p-12f ? rintf(t) : rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// elements [16 u, 16 u + 16) of a row as floats, zero at and past K; `vec`: the row is
// 16-byte aligned, so whole units load as 16-byte vectors
__device__ __forceinline__ void load_unit(const float* row, int u, int K, bool vec,
                                          float (&f)[16]) {
  const int k0 = 16 * u;
  if (vec && k0 + 16 <= K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(row + k0 + 4 * i);
      f[4 * i] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = k0 + e < K ? row[k0 + e] : 0.0f;
  }
}

__device__ __forceinline__ void load_unit(const bf16* row, int u, int K, bool vec,
                                          float (&f)[16]) {
  const int k0 = 16 * u;
  if (vec && k0 + 16 <= K) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + k0 + 8 * i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
        f[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = k0 + e < K ? __bfloat162float(row[k0 + e]) : 0.0f;
  }
}

__device__ __forceinline__ float unit_amax(const float (&f)[16]) {
  float a = 0.0f;
#pragma unroll
  for (int e = 0; e < 16; ++e) a = fmaxf(a, fabsf(f[e]));
  return a;
}

__device__ __forceinline__ void store_unit(int8_t* dst, const float (&f)[16], float s, float r) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[i] |= (uint32_t)(quant(f[4 * i + j], s, r) & 0xff) << (8 * j);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Each row is quantized by tpr = 2^tpr_log2 threads (32 .. 256: one to eight warps),
// each keeping UPL 16-element units of it in registers (rows longer than tpr * UPL
// units are read again); QTHREADS / tpr rows per block.
template <typename T, int UPL>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const T* __restrict__ x, long long xs, int M, int K, int Kp, bool vec,
                     int tpr_log2, int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float part[QTHREADS / 32];
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int m = blockIdx.x * (QTHREADS >> tpr_log2) + (threadIdx.x >> tpr_log2);
  const bool live = m < M;
  const T* row = x + (long long)(live ? m : 0) * xs;
  const int units = Kp / 16;
  float f[UPL][16];
  float amax = 0.0f;
  if (live) {
#pragma unroll
    for (int i = 0; i < UPL; ++i) {
      if (lane + tpr * i < units) {
        load_unit(row, lane + tpr * i, K, vec, f[i]);
        amax = fmaxf(amax, unit_amax(f[i]));
      }
    }
    for (int u = lane + tpr * UPL; u < units; u += tpr) {
      float g[16];
      load_unit(row, u, K, vec, g);
      amax = fmaxf(amax, unit_amax(g));
    }
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tpr > 32) {  // the row spans tpr / 32 warps: combine their maxima
    const int warp = threadIdx.x >> 5, first = warp & ~((tpr >> 5) - 1);
    if ((threadIdx.x & 31) == 0) part[warp] = amax;
    __syncthreads();
    for (int w = 0; w < (tpr >> 5); ++w) amax = fmaxf(amax, part[first + w]);
  }
  if (!live) return;
  const float s = __fmul_rn(fmaxf(amax, 1e-6f), INV127), r = __frcp_rn(s);
  if (lane == 0) sx[m] = s;
  int8_t* qrow = xq + (long long)m * Kp;
#pragma unroll
  for (int i = 0; i < UPL; ++i)
    if (lane + tpr * i < units) store_unit(qrow + 16 * (lane + tpr * i), f[i], s, r);
  for (int u = lane + tpr * UPL; u < units; u += tpr) {
    float g[16];
    load_unit(row, u, K, vec, g);
    store_unit(qrow + 16 * u, g, s, r);
  }
}

// ---- GEMM -------------------------------------------------------------------------------

template <typename OutT> struct GemmCfg {
  static constexpr int STAGE = (BM + BN) * BK;              // x_q and w_q slices, 32 KB
  static constexpr int EPI_COLS = 128 / (int)sizeof(OutT);  // columns per 128-byte box
  static constexpr int EPI_BOX = BM * 128;                  // one box: 128 rows x 128 bytes
  static constexpr int EPI_WG = BM * BN * (int)sizeof(OutT);  // one consumer's staging tile
  static constexpr int COLS = 2 * 2 * BN * 4;  // each consumer's tile scale and bias, fp32
  // the 1024-byte alignment slack, the columns and at most 2 * 6 + 2 barriers
  static constexpr int FIXED = 1024 + 2 * EPI_WG + COLS + (2 * 6 + 2) * 8;
  static constexpr int STAGES_FIT = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 6 ? STAGES_FIT : 6;
  static constexpr int BYTES = STAGES * STAGE + FIXED;
  static_assert(STAGES >= 2, "shared memory holds fewer than two stages");
};

__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// BIAS: 0 none, 1 fp32, 2 bf16 (converted to fp32 exactly)
template <int BIAS>
__device__ __forceinline__ float epilogue(int acc, float sxm, float sc, float bias) {
  const float af = __int2float_rn(acc);
  const float s = __fmul_rn(sxm, sc);
  return BIAS ? __fmaf_rn(af, s, bias) : __fmul_rn(af, s);
}

// Ping-pong: consumer warpgroup c takes the block's tiles c, c + 2, ... (each 128 x 128,
// as two m64n128k32 products sharing the w_q slice), so one warpgroup's epilogue runs
// while the other's products and the producer's loads go on. A warpgroup starts a
// tile's waits on the ring only once the other has passed its waits of the tile before
// (order barriers): a parity wait tells apart only two rounds of a stage. The tile's
// row and column factors are loaded before its products and read from shared memory
// in the epilogue, so their load latency hides behind the products.
template <typename OutT, int BIAS>
__global__ void __launch_bounds__(384, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tout, const float* __restrict__ sx,
            const float* __restrict__ scale, const void* __restrict__ bias, int M, int N,
            int Kp) {
  using C = GemmCfg<OutT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  unsigned char* epi = base + C::STAGES * C::STAGE;  // [2 consumers][BN / EPI_COLS boxes]
  float* cols = reinterpret_cast<float*>(epi + 2 * C::EPI_WG);  // [2 consumers][scale, bias]
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * C::EPI_WG + C::COLS);
  uint64_t* empty = full + C::STAGES;
  uint64_t* order = empty + C::STAGES;  // [c]: warpgroup c passed its waits of a tile
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int ksteps = (Kp + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::mbar_init(&order[0], 1);
    hopper::mbar_init(&order[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: the k slices of the block's tiles, in order ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % C::STAGES;
          hopper::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          unsigned char* a = base + s * C::STAGE;
          hopper::mbar_expect_tx(&full[s], C::STAGE);
          hopper::tma_load_2d(a, &ta, &full[s], ks * BK, m0);
          hopper::tma_load_2d(a + BM * BK, &tb, &full[s], ks * BK, n0);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
    const int row0 = warp * 16 + lane / 4;  // + 64 h + 8 r
    unsigned char* stage_out = epi + c * C::EPI_WG;
    float* col_sc = cols + c * 2 * BN;
    float* col_b = col_sc + BN;
    for (int i = c, turn = 0;; i += 2, ++turn) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= tiles) break;
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      if (i > 0)  // the other warpgroup passed its waits of tile i - 1
        hopper::mbar_wait(&order[1 - c], (turn - 1 + c) & 1);
      float sxm[2][2];  // rows 64 h + row0 + 8 r
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + 64 * h + row0 + 8 * r;
          sxm[h][r] = m < M ? __ldg(sx + m) : 0.0f;
        }
      const int n = n0 + tid;  // this thread's column of the tile, for the staging below
      const float sc_n = n < N ? __ldg(scale + n) : 0.0f;
      float b_n = 0.0f;
      if (BIAS == 1 && n < N) b_n = __ldg(static_cast<const float*>(bias) + n);
      if (BIAS == 2 && n < N) b_n = __bfloat162float(static_cast<const bf16*>(bias)[n]);
      int acc[2][BN / 2];  // rows [0, 64) and [64, 128) of the tile
      for (int ks = 0; ks < ksteps; ++ks) {
        const int it = i * ksteps + ks, s = it % C::STAGES;
        hopper::mbar_wait(&full[s], (it / C::STAGES) & 1);
        const unsigned char* a = base + s * C::STAGE;
        const unsigned char* b = a + BM * BK;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t db = hopper::desc_sw128(b + 32 * kk, 16, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            hopper::wgmma_m64n128k32_s8_ss(
                acc[h], hopper::desc_sw128(a + h * 64 * BK + 32 * kk, 16, 1024), db,
                ks > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous slice's products are done: release it
        if (ks > 0 && tid == 0) hopper::mbar_arrive(&empty[(it - 1) % C::STAGES]);
      }
      if (tid == 0) hopper::mbar_arrive(&order[c]);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc[0]);
      hopper::reg_fence(acc[1]);
      if (tid == 0) hopper::mbar_arrive(&empty[((i + 1) * ksteps - 1) % C::STAGES]);

      // epilogue: fma in registers -> swizzled staging tile -> TMA stores
      if (tid == 0) hopper::tma_store_wait_read();  // the last tile's stores left the staging
      col_sc[tid] = sc_n;  // the last tile's epilogue read these before its second barrier
      col_b[tid] = b_n;
      hopper::named_barrier(1 + c, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 sc = *reinterpret_cast<const float2*>(col_sc + col);
        const float2 bv = *reinterpret_cast<const float2*>(col_b + col);
        const int box = col / C::EPI_COLS;
        const int byte = (col % C::EPI_COLS) * (int)sizeof(OutT);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 64 * h + row0 + 8 * r;
            unsigned char* dst = stage_out + box * C::EPI_BOX + row * 128 +
                                 (((byte / 16) ^ (row % 8)) * 16) + byte % 16;
            store_pair(reinterpret_cast<OutT*>(dst),
                       epilogue<BIAS>(acc[h][4 * j + 2 * r], sxm[h][r], sc.x, bv.x),
                       epilogue<BIAS>(acc[h][4 * j + 2 * r + 1], sxm[h][r], sc.y, bv.y));
          }
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + c, 128);
      if (tid == 0) {
        for (int box = 0; box < BN / C::EPI_COLS; ++box)
          if (n0 + box * C::EPI_COLS < N)
            hopper::tma_store_2d(&tout, stage_out + box * C::EPI_BOX, n0 + box * C::EPI_COLS, m0);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait_all();
  }
}

template <typename OutT, int BIAS>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout,
                        const float* sx, const float* scale, const void* bias, int M, int N,
                        int Kp, int sms, cudaStream_t stream) {
  using C = GemmCfg<OutT>;
  auto kernel = gemm_kernel<OutT, BIAS>;
  // above the 48 KB default; the opt-in holds per device, so it is set on every call
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, 384, C::BYTES, stream>>>(ta, tb, tout, sx, scale, bias, M, N, Kp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, long long xs, const void* w, const float* scale,
                   const void* bias, int bias_dtype, void* xq, float* sx, void* out,
                   long long out_pitch, int M, int N, int K, int Kp, int sms,
                   cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (xs * sizeof(T)) % 16 == 0;
  // threads per row: the row's 16-element units rounded down to a power of 2, 32 .. 256
  // (K = 560: 35 units on 32 threads, not 64 threads half idle)
  int tpr_log2 = 5;
  while (tpr_log2 < 8 && (2 << tpr_log2) <= Kp / 16) ++tpr_log2;
  const int rows = QTHREADS >> tpr_log2;
  auto quantize = Kp / 16 <= (1 << tpr_log2) ? quantize_rows_kernel<T, 1>
                                             : quantize_rows_kernel<T, 2>;
  quantize<<<(M + rows - 1) / rows, QTHREADS, 0, stream>>>(
      static_cast<const T*>(x), xs, M, K, Kp, vec, tpr_log2, static_cast<int8_t*>(xq), sx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // x_q (M, Kp) and w_q (N, Kp) in 128 x 128-byte boxes; out (M, N) in 128-row boxes
  CUtensorMap ta, tb, tout;
  const cuuint64_t a_dims[2] = {(cuuint64_t)Kp, (cuuint64_t)M};
  const cuuint64_t b_dims[2] = {(cuuint64_t)Kp, (cuuint64_t)N};
  const cuuint64_t o_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint64_t o_strides[1] = {(cuuint64_t)out_pitch * sizeof(T)};
  const cuuint32_t box[2] = {BK, BM}, o_box[2] = {(cuuint32_t)(128 / sizeof(T)), BM};
  err = hopper::make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, a_dims, strides, box);
  if (err != cudaSuccess) return err;
  err = hopper::make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, b_dims, strides, box);
  if (err != cudaSuccess) return err;
  err = hopper::make_map(&tout, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         2, out, o_dims, o_strides, o_box);
  if (err != cudaSuccess) return err;
  if (bias_dtype == 1)
    return launch_gemm<T, 1>(ta, tb, tout, sx, scale, bias, M, N, Kp, sms, stream);
  if (bias_dtype == 2)
    return launch_gemm<T, 2>(ta, tb, tout, sx, scale, bias, M, N, Kp, sms, stream);
  return launch_gemm<T, 0>(ta, tb, tout, sx, scale, bias, M, N, Kp, sms, stream);
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. xs: row stride of x in elements.
// w: (N, Kp) int8 contiguous, Kp = K rounded up to 16 (zeros above K). bias_dtype: 0 = no
// bias, 1 = float32, 2 = bfloat16. xq: (M, Kp) int8 scratch and sx: (M,) fp32 scratch.
// out: (M, N) with row pitch out_pitch elements (16-byte multiple); w, xq and out
// 16-byte aligned (TMA). sms: the device's SM count, the persistent GEMM's grid limit.
extern "C" int w8a8_linear_fwd(int dtype, const void* x, long long xs, const void* w,
                               const void* scale, const void* bias, int bias_dtype, void* xq,
                               void* sx, void* out, long long out_pitch, int M, int N, int K,
                               int Kp, int sms, void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  if (M < 1 || N < 1 || K < 1 || Kp < K || Kp % 16 || out_pitch < N ||
      (out_pitch * esz) % 16 || bias_dtype < 0 || bias_dtype > 2 || sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* sxf = static_cast<float*>(sx);
  if (dtype == 0)
    return (int)launch<float>(x, xs, w, sc, bias, bias_dtype, xq, sxf, out, out_pitch, M, N, K,
                              Kp, sms, s);
  if (dtype == 1)
    return (int)launch<bf16>(x, xs, w, sc, bias, bias_dtype, xq, sxf, out, out_pitch, M, N, K,
                             Kp, sms, s);
  return (int)cudaErrorInvalidValue;
}
