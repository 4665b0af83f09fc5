// Flash attention forward for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces the TPU kernel funasr_tpu/ops/flash_attention.py::flash_attention
// (kernel _flash_kernel): softmax(Q K^T / sqrt(D)) V with an online softmax over key
// tiles, fp32 scores and fp32 accumulation, keys at or past lengths[b] scored -1e30,
// output acc / max(l, 1e-30) in q's dtype.
//
// Design. One block of 4 warps per (b*h, 64-row query tile). The Pallas kernel keeps a
// whole K/V row in VMEM; here K and V stream through shared memory in 64-key tiles and
// each warp owns 16 query rows for the score tile, the online softmax and its slice of
// the output accumulator, so only the K/V tile loads need the whole block in step.
//   * bf16: both products run on the tensor cores (wmma 16x16x16, fp32 accumulate).
//     Scores are scaled after the product; the probabilities are rounded to bf16 for
//     the P V product while the softmax sums stay fp32.
//   * fp32: both products run as fp32 FMAs on the CUDA cores (no TF32), q pre-scaled
//     as the Pallas kernel does.
// What bounds it: at the path's shapes (T <= 1408, D = 128) the work is the two
// products, 4*T^2*D flops per head against 4*T*D*2 bytes moved, so it is compute
// bound; this first version leaves wgmma, TMA and a pipelined K/V ring to later work.
//
// Masking. Keys in [lengths[b], T) score -1e30 like the Pallas kernel; keys past T
// (the ragged last tile, which Pallas never has because it requires T % block == 0)
// score -inf and contribute exactly 0. A row with lengths[b] == 0 therefore gets the
// uniform average of V over all T keys, as the Pallas kernel gives. When
// lengths[b] > 0 key tiles wholly past the length are skipped: their exp() is exactly 0.
// Query rows at or past lengths[b] are computed like any other row (callers ignore
// them); rows past T are not written.
//
// Inputs are (B, H, T, D) with any strides whose last one is 1 and the others
// multiples of 16 bytes; the wrapper (funasr_tpu_torch/ops/flash_attention.py) checks
// this, allocates the output and passes the stream. D <= 128, a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int DP = 128;   // head dim held in shared memory (zero padded above D)
constexpr int NT = 128;   // threads per block: 4 warps x 16 query rows
constexpr float MASKED = -1e30f;

typedef __nv_bfloat16 bf16;

// Shared-memory layout, in elements of each region's own type. Pitches keep wmma
// pointers 32-byte aligned (bf16) and scalar accesses mostly free of bank conflicts.
template <typename T> struct Layout;

template <> struct Layout<bf16> {
  static constexpr int QP = DP + 8, KP = DP + 8, VP = DP + 8;  // bf16
  static constexpr int SP = BK + 4;                            // fp32 scores
  static constexpr int PP = BK + 8;                            // bf16 probabilities
  static constexpr int OP = DP + 4;                            // fp32 accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + BQ * QP * sizeof(bf16);
  static constexpr size_t v = k + BK * KP * sizeof(bf16);
  static constexpr size_t s = v + BK * VP * sizeof(bf16);
  static constexpr size_t p = s + BQ * SP * sizeof(float);
  static constexpr size_t o = p + BQ * PP * sizeof(bf16);
  static constexpr size_t stats = o + BQ * OP * sizeof(float);
  static constexpr size_t bytes = stats + 3 * BQ * sizeof(float);
};

template <> struct Layout<float> {
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
__device__ __forceinline__ void load_tile(bf16* dst, int pitch, const bf16* src, long long st,
                                          int row0, int T, int D, float) {
  for (int i = threadIdx.x; i < BQ * (DP / 8); i += NT) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T && c < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

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

template <typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, const int* __restrict__ lengths, int H, int T_len, int D,
                 long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst,
                 long long osb, long long osh, long long ost, float sm_scale) {
  using L = Layout<T>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
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

  const T* qg = q + b * qsb + h * qsh;
  const T* kg = k + b * ksb + h * ksh;
  const T* vg = v + b * vsb + h * vsh;
  T* og = o + b * osb + h * osh;

  for (int i = tid; i < BQ * L::OP; i += NT) O[i] = 0.f;
  if (tid < BQ) {
    m_s[tid] = MASKED;
    l_s[tid] = 0.f;
  }
  // fp32 scales q before the product, as the Pallas kernel does; bf16 scales the
  // fp32 scores instead (q stays exactly as given on the tensor cores)
  load_tile(Qs, L::QP, qg, qst, q0, T_len, D, kBf16 ? 1.f : sm_scale);
  const float s_scale = kBf16 ? sm_scale : 1.f;

  const int kend = len > 0 ? len : T_len;
  const int ntiles = (kend + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    load_tile(Ks, L::KP, kg, kst, k0, T_len, D, 1.f);
    load_tile(Vs, L::VP, vg, vst, k0, T_len, D, 1.f);
    __syncthreads();

    // ---- scores S[r0:r0+16, 0:64] = Q K^T --------------------------------------
    if constexpr (kBf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DP / 16];
      for (int kk = 0; kk < DP / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], Qs + r0 * L::QP + kk * 16, L::QP);
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + n * 16 * L::KP + kk * 16, L::KP);
          wmma::mma_sync(acc, qa[kk], kb, acc);
        }
        wmma::store_matrix_sync(S + r0 * L::SP + n * 16, acc, L::SP, wmma::mem_row_major);
      }
    } else {
      // thread owns rows ty*8 .. ty*8+7 (inside its warp's 16) and keys tx + 16*j
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

    // ---- online softmax over this warp's 16 rows ---------------------------------
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float sv[2];
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2, key = k0 + c;
        const float s = S[r * L::SP + c] * s_scale;
        sv[h2] = key >= T_len ? -INFINITY : (key >= len ? MASKED : s);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      if constexpr (kBf16) {
        bf16* P = reinterpret_cast<bf16*>(smem + Layout<bf16>::p);
        P[r * Layout<bf16>::PP + lane] = __float2bfloat16(p0);
        P[r * Layout<bf16>::PP + lane + 32] = __float2bfloat16(p1);
      } else {
        S[r * L::SP + lane] = p0;
        S[r * L::SP + lane + 32] = p1;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
    }
    __syncwarp();

    // ---- O[r0:r0+16, :] = alpha * O + P V -----------------------------------------
    if constexpr (kBf16) {
      for (int rr = 0; rr < 16; ++rr) {
        const float alpha = a_s[r0 + rr];
        for (int c = lane; c < DP; c += 32) O[(r0 + rr) * L::OP + c] *= alpha;
      }
      __syncwarp();
      const bf16* P = reinterpret_cast<const bf16*>(smem + Layout<bf16>::p);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], P + r0 * Layout<bf16>::PP + kk * 16, Layout<bf16>::PP);
      for (int n = 0; n < DP / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, O + r0 * L::OP + n * 16, L::OP, wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
          wmma::load_matrix_sync(vb, Vs + kk * 16 * L::VP + n * 16, L::VP);
          wmma::mma_sync(acc, pa[kk], vb, acc);
        }
        wmma::store_matrix_sync(O + r0 * L::OP + n * 16, acc, L::OP, wmma::mem_row_major);
      }
    } else {
      // thread owns rows ty*8 .. ty*8+7 and columns tx + 16*j of the accumulator
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

  // ---- out = O / max(l, 1e-30), rows < T, columns < D -----------------------------
  for (int i = tid; i < BQ * (DP / 4); i += NT) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    if (q0 + r >= T_len || c >= D) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* dst = og + (long long)(q0 + r) * ost + c;
    for (int e = 0; e < 4; ++e) {
      const float val = O[r * L::OP + c + e] * inv;
      if constexpr (kBf16) dst[e] = __float2bfloat16(val);
      else dst[e] = val;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* lengths,
                   int B, int H, int T_len, int D, const long long* st, float sm_scale,
                   cudaStream_t stream) {
  const size_t bytes = Layout<T>::bytes;  // above the 48 KB default: opt in per device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T_len + BQ - 1) / BQ);
  flash_fwd_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lengths, H, T_len, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: (b, h, t) for q, k, v, o in elements.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* lengths, int B, int H, int T_len,
                                   int D, const long long* strides, float sm_scale,
                                   void* stream) {
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, lens, B, H, T_len, D, strides, sm_scale, s);
  if (dtype == 1) return (int)launch<bf16>(q, k, v, o, lens, B, H, T_len, D, strides, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
