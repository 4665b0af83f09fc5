// Flash attention forward for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces the TPU kernel funasr_tpu/ops/flash_attention.py::flash_attention
// (kernel _flash_kernel): softmax(Q K^T / sqrt(D)) V with an online softmax over key
// tiles, fp32 scores and fp32 accumulation, keys at or past lengths[b] scored -1e30,
// output acc / max(l, 1e-30) in q's dtype.
//
// Two kernels: bf16 (the path's dtype) on wgmma fed by TMA, and fp32 on CUDA-core FMAs
// (no TF32: it would move results by ~1e-3), which only the CPU-parity sizes use.
//
// What bounds bf16 on the H100 (NVIDIA H100 80GB HBM3 at 700 W: 3.35 TB/s, 989 TFLOP/s
// bf16). Per (b, h) the kernel reads q, k, v once and writes o once (8 T D bytes) and
// does 4 T L D flops (L = keys up to the row's length). At T = 384, D = 128 that is
// 50.3 MB for B H = 128 (15.0 us) against 9.7 GFLOP (9.8 us): bytes bound. At the
// long-form T = 1408, B H = 4, 5.8 MB (1.7 us) against 4.1 GFLOP (4.1 us): operations
// bound. What the design does about it:
//   * q, k, v and o move once, by TMA, straight from and to the strided head views of
//     the fused q|k|v projection and the head-interleaved (B, T, H, D) output: no copy,
//     no register or instruction spent on addresses (bytes);
//   * one producer warp keeps the next K/V tile in flight in a 2-stage ring (full /
//     empty mbarriers) while the consumers compute, so the loads overlap the products;
//   * each consumer warpgroup owns 64 query rows: S = Q K^T runs as wgmma m64n128k16
//     with Q and K in shared memory; the scores, the online softmax (exp2 with log2(e)
//     folded into the scale; each row's max is two shuffles among the 4 threads that
//     hold it; the sums stay per thread until the end) and the accumulator O stay in
//     registers; the probabilities, rounded to bf16 in registers, are the register A
//     operand of O += P V (wgmma with V as an N-major B operand, imm-trans-b), so
//     nothing of S, P or O goes through shared memory (operations);
//   * key tiles wholly past the row's length are neither loaded nor computed;
//   * blocks of 128 query rows (two consumer warpgroups sharing each K/V tile) where
//     the grid fills the card with them, else 64 rows (the wrapper chooses: at
//     (1, 4, 1408) 128-row blocks would leave 88 of 132 SMs idle).
//
// Masking (both kernels). Keys in [lengths[b], T) score -1e30 like the Pallas kernel;
// keys past T (the ragged last tile, which Pallas never has because it requires
// T % block == 0; TMA fills it with zeros) score -inf and contribute exactly 0. A row
// with lengths[b] == 0 therefore gets the uniform average of V over all T keys, as the
// Pallas kernel gives. When lengths[b] > 0 key tiles wholly past the length are
// skipped: their exp() is exactly 0. Query rows at or past lengths[b] are computed like
// any other row (callers ignore them); rows past T are not written.
//
// Inputs are (B, H, T, D) with any strides whose last one is 1 and the others
// multiples of 16 bytes; the wrapper (funasr_tpu_torch/ops/flash_attention.py) checks
// this, allocates the output, picks the bf16 block rows and passes the stream.
// D <= 128, a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DP = 128;  // head dim held in shared memory (zero-filled above D)

typedef __nv_bfloat16 bf16;

// ---- bf16: wgmma + TMA ------------------------------------------------------------------

constexpr int BKB = 128;   // keys per tile
constexpr int STAGES = 2;  // K/V ring depth
constexpr int QR = 64;     // query rows per consumer warpgroup
constexpr int HALF = 64;   // head-dim columns per 128-byte swizzled block

// every array a multiple of 1024 bytes from a 1024-aligned base
template <int NC> struct BfSmem {
  bf16 q[NC][2][QR * HALF];  // Q of each consumer, then its output staging
  bf16 k[STAGES][2][BKB * HALF];
  bf16 v[STAGES][2][BKB * HALF];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// NC consumer warpgroups of QR query rows each, plus one producer warpgroup (warpgroup
// 0, of which one thread issues the loads). Grid (B * H, ceil(T / (NC * QR))).
template <int NC>
__global__ void __launch_bounds__(384, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  const int* __restrict__ lengths, int H, int T_len, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  BfSmem<NC>& sm = *reinterpret_cast<BfSmem<NC>*>(hopper::align1024(smem_raw));
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * (NC * QR);
  const int len = min(max(lengths[b], 0), T_len);
  const int ntiles = ((len > 0 ? len : T_len) + BKB - 1) / BKB;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.empty[s], NC);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.q_full, NC * QR * DP * sizeof(bf16));
      for (int c = 0; c < NC; ++c)
        for (int hf = 0; hf < 2; ++hf)
          hopper::tma_load_4d(sm.q[c][hf], &tq, &sm.q_full, hf * HALF, q0 + c * QR, h, b);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        hopper::mbar_wait(&sm.empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&sm.k_full[s], BKB * DP * sizeof(bf16));
        for (int hf = 0; hf < 2; ++hf)
          hopper::tma_load_4d(sm.k[s][hf], &tk, &sm.k_full[s], hf * HALF, kt * BKB, h, b);
        hopper::mbar_expect_tx(&sm.v_full[s], BKB * DP * sizeof(bf16));
        for (int hf = 0; hf < 2; ++hf)
          hopper::tma_load_4d(sm.v[s][hf], &tv, &sm.v_full[s], hf * HALF, kt * BKB, h, b);
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f};  // rows lane / 4 and + 8

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt < ntiles; ++kt) {
      const int s = kt % STAGES;
      const uint32_t ph = (kt / STAGES) & 1;

      // S = Q K^T over the 128 head-dim columns, 16 per wgmma
      float sc[64];
      hopper::mbar_wait(&sm.k_full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(&sm.q[c][kk / 4][(kk % 4) * 16], 16, 1024);
        const uint64_t db = hopper::desc_sw128(&sm.k[s][kk / 4][(kk % 4) * 16], 16, 1024);
        hopper::wgmma_m64n128k16_bf16_ss(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(sc);

      // mask, scale to log2 units, online softmax
      const int k0 = kt * BKB;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * quad + (e & 1);
          const float x = sc[4 * j + e] * scale_log2;
          sc[4 * j + e] = key >= T_len ? -INFINITY : (key >= len ? MASKED : x);
          mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * j + e] - mx[e / 2]);
          sc[4 * j + e] = p;
          l_r[e / 2] += p;
          o[4 * j + e] *= alpha[e / 2];
        }
      // the accumulator layout of S is the A-fragment layout of P: 16 keys per wgmma
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

      // O += P V, V (keys x head dim) as an N-major B operand
      hopper::mbar_wait(&sm.v_full[s], ph);
      hopper::reg_fence(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKB / 16; ++kk) {
        const uint64_t db =
            hopper::desc_sw128(&sm.v[s][0][kk * 16 * HALF], BKB * HALF * sizeof(bf16), 1024);
        hopper::wgmma_m64n128k16_bf16_rs_tb(o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(o);
      if (tid == 0) hopper::mbar_arrive(&sm.empty[s]);
    }

    // out = O / max(l, 1e-30): staged in this consumer's Q tile (swizzled as TMA
    // expects), then one TMA store per 64-column block; rows past T are clipped
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l_r[r]), 1e-30f);
    hopper::named_barrier(1 + c, 128);  // every warp is past its last read of Q
    const int row0 = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        bf16* dst = &sm.q[c][j / 8][row * HALF + ((j % 8) ^ (row % 8)) * 8 + 2 * quad];
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + c, 128);
    if (tid == 0 && q0 + c * QR < T_len) {
      for (int hf = 0; hf < 2; ++hf)
        hopper::tma_store_4d(&to, sm.q[c][hf], hf * HALF, q0 + c * QR, h, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait_all();
    }
  }
}

// above the 48 KB default; the opt-in holds per device, so it is set on every call
template <int NC> cudaError_t opt_in_smem() {
  return cudaFuncSetAttribute(flash_bf16_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(BfSmem<NC>) + 1024));
}

cudaError_t launch_bf16(const void* const* ptrs, const int* lengths, int B, int H, int T_len,
                        int D, const long long* st, float sm_scale, int block_rows,
                        cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, o as (D, T, H, B)
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T_len, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)st[3 * i + 2] * sizeof(bf16),
                                   (cuuint64_t)st[3 * i + 1] * sizeof(bf16),
                                   (cuuint64_t)st[3 * i] * sizeof(bf16)};
    const cuuint32_t box[4] = {HALF, (cuuint32_t)(i == 1 || i == 2 ? BKB : QR), 1, 1};
    const cudaError_t err =
        hopper::make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptrs[i], dims, strides,
                         box);
    if (err != cudaSuccess) return err;
  }
  const bool two = block_rows == 2 * QR;
  const size_t bytes = (two ? sizeof(BfSmem<2>) : sizeof(BfSmem<1>)) + 1024;
  auto kernel = two ? flash_bf16_kernel<2> : flash_bf16_kernel<1>;
  const cudaError_t err = two ? opt_in_smem<2>() : opt_in_smem<1>();
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T_len + block_rows - 1) / block_rows);
  kernel<<<grid, 128 * (two ? 3 : 2), bytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                      lengths, H, T_len, sm_scale * LOG2E);
  return cudaGetLastError();
}

// ---- fp32: CUDA-core FMAs -------------------------------------------------------------
//
// One block of 4 warps per (b*h, 64-row query tile); K and V stream through shared
// memory in 64-key tiles; q is pre-scaled as the Pallas kernel does.

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block: 4 warps x 16 query rows

struct F32Layout {
  static constexpr int QP = DP, KP = DP + 1, VP = DP;
  static constexpr int SP = BK;  // probabilities overwrite the scores in place
  static constexpr int OP = DP;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + BQ * QP * sizeof(float);
  static constexpr size_t v = k + BK * KP * sizeof(float);
  static constexpr size_t s = v + BK * VP * sizeof(float);
  static constexpr size_t o = s + BQ * SP * sizeof(float);
  static constexpr size_t stats = o + BQ * OP * sizeof(float);
  static constexpr size_t bytes = stats + 3 * BQ * sizeof(float);
};

// rows [row0, row0 + 64) x [0, DP) of a (T, D) slice with row stride st, zero past T / D
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src, long long st,
                                          int row0, int T, int D, float scale) {
  for (int i = threadIdx.x; i < BQ * (DP / 4); i += NT) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T && c < D)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * st + c);
    float* d = dst + r * pitch + c;
    d[0] = val.x * scale;
    d[1] = val.y * scale;
    d[2] = val.z * scale;
    d[3] = val.w * scale;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ lengths, int H, int T_len, int D,
                 long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst,
                 long long osb, long long osh, long long ost, float sm_scale) {
  using L = F32Layout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float* S = reinterpret_cast<float*>(smem + L::s);
  float* O = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first query row in the tile
  const int len = min(max(lengths[b], 0), T_len);

  const float* qg = q + b * qsb + h * qsh;
  const float* kg = k + b * ksb + h * ksh;
  const float* vg = v + b * vsb + h * vsh;
  float* og = o + b * osb + h * osh;

  for (int i = tid; i < BQ * L::OP; i += NT) O[i] = 0.f;
  if (tid < BQ) {
    m_s[tid] = MASKED;
    l_s[tid] = 0.f;
  }
  load_tile(Qs, L::QP, qg, qst, q0, T_len, D, sm_scale);

  const int kend = len > 0 ? len : T_len;
  const int ntiles = (kend + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    load_tile(Ks, L::KP, kg, kst, k0, T_len, D, 1.f);
    load_tile(Vs, L::VP, vg, vst, k0, T_len, D, 1.f);
    __syncthreads();

    // scores S[r0:r0+16, 0:64] = Q K^T: thread owns rows ty*8 .. ty*8+7 and keys tx + 16*j
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[8][4];
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[8], kv[4];
        for (int i = 0; i < 8; ++i) qv[i] = Qs[(ty * 8 + i) * L::QP + d];
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * L::KP + d];
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) S[(ty * 8 + i) * L::SP + tx + 16 * j] = acc[i][j];
    }
    __syncwarp();

    // online softmax over this warp's 16 rows
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float sv[2];
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2, key = k0 + c;
        const float s = S[r * L::SP + c];
        sv[h2] = key >= T_len ? -INFINITY : (key >= len ? MASKED : s);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      S[r * L::SP + lane] = p0;
      S[r * L::SP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
    }
    __syncwarp();

    // O = alpha * O + P V: thread owns rows ty*8 .. ty*8+7 and columns tx + 16*j
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[8][DP / 16];
      for (int i = 0; i < 8; ++i) {
        const float alpha = a_s[ty * 8 + i];
        for (int j = 0; j < DP / 16; ++j) acc[i][j] = O[(ty * 8 + i) * L::OP + tx + 16 * j] * alpha;
      }
      for (int kk = 0; kk < BK; ++kk) {
        float pv[8], vv[DP / 16];
        for (int i = 0; i < 8; ++i) pv[i] = S[(ty * 8 + i) * L::SP + kk];
        for (int j = 0; j < DP / 16; ++j) vv[j] = Vs[kk * L::VP + tx + 16 * j];
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < DP / 16; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < DP / 16; ++j) O[(ty * 8 + i) * L::OP + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();  // K/V tiles are overwritten next iteration
  }

  // out = O / max(l, 1e-30), rows < T, columns < D
  for (int i = tid; i < BQ * (DP / 4); i += NT) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    if (q0 + r >= T_len || c >= D) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    float* dst = og + (long long)(q0 + r) * ost + c;
    for (int e = 0; e < 4; ++e) dst[e] = O[r * L::OP + c + e] * inv;
  }
}

cudaError_t launch_f32(const void* const* ptrs, const int* lengths, int B, int H, int T_len,
                       int D, const long long* st, float sm_scale, cudaStream_t stream) {
  const size_t bytes = F32Layout::bytes;  // above the 48 KB default: opt in per device
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T_len + BQ - 1) / BQ);
  flash_f32_kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), static_cast<float*>(const_cast<void*>(ptrs[3])),
      lengths, H, T_len, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: (b, h, t) for q, k, v, o in elements.
// block_rows: query rows per bf16 block, 64 or 128 (the fp32 kernel always takes 64).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* lengths, int B, int H, int T_len,
                                   int D, const long long* strides, float sm_scale,
                                   int block_rows, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > DP || D % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_f32(ptrs, lens, B, H, T_len, D, strides, sm_scale, s);
  if (dtype == 1 && (block_rows == QR || block_rows == 2 * QR))
    return (int)launch_bf16(ptrs, lens, B, H, T_len, D, strides, sm_scale, block_rows, s);
  return (int)cudaErrorInvalidValue;
}
