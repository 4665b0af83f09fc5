// Flash attention backward for Hopper (sm_90a), fp32, plain C interface loaded with ctypes.
//
// The gradient of funasr_tpu_torch/ops/flash_attention.py::flash_attention (the forward
// kernel in flash_attention.cu, which replaces the TPU kernel
// funasr_tpu/ops/flash_attention.py::flash_attention). The JAX package has no backward
// kernel: its gradients come from XLA's autodiff of the einsum attention
// (funasr_tpu/models/sanm/attention.py:121-133). This kernel keeps the forward kernels on
// the training path: with S = Q K^T / sqrt(D), masked keys at -1e30 as in the forward,
//   P = exp(S - m) / l            (m, l: each row's max and sum, recomputed here)
//   Dr = rowsum(dO o O)
//   dV = P^T dO,  dS = P o (dO V^T - Dr),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// and dS = 0 at masked keys (masked_fill's gradient): a row of length 0 averages V over
// all Tk keys, so its dV share is dO / Tk and it sends nothing to Q or K.
//
// Two kernels, launched one after the other on the caller's stream, neither with a float
// atomic, so two runs give bit-equal gradients:
//   * dq kernel, one block of 64 query rows: a first pass over the key tiles recomputes
//     each row's (m, l) (the tuned forward kernels stay as they are and keep no
//     log-sum-exp), Dr from O and dO, all three written to `stats`; a second pass over
//     the key tiles forms P and dS and accumulates dQ in registers;
//   * dkdv kernel, one block of 64 keys: one pass over the query tiles, with (m, l, Dr)
//     read back from `stats`, accumulates dK and dV in registers.
// Key limits as in the forward (modes none, causal, corner): a key tile wholly past a
// query block's largest limit is skipped in the dq kernel, a query tile whose largest
// limit does not reach a key block in the dkdv kernel (limits never decrease with the
// row, so a tile's largest is its last row's).
//
// What bounds it on the H100: operations. Per (b, h) the two kernels do 16 Tq L D flops
// (S three times, dO V^T twice, dV, dK and dQ once; L = keys each row sees) against
// 11 T D fp32 values moved (q, k, v, o, dO read, dq, dk, dv written). At the training
// batch's (B, 4, T, 128) the CUDA cores' 67 TFLOP/s bound it. This first kernel runs on
// them with FFMA (no 3xTF32 split on the tensor cores yet, ROADMAP section 2): 256
// threads a block, each a 4 x 4 tile of the 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j), its operands read as 16-byte vectors from row-major shared tiles of pitch
// 132 floats, which makes every such read conflict-free; the products P dO, dS K and
// dS^T Q read P / dS from shared memory and accumulate 4 rows x 8 head-dim columns a
// thread. Q and dO (dq kernel) or K and V (dkdv kernel) stay in shared memory for the
// block's life; the other pair streams through one tile buffer.
//
// Shapes: q, o, dO, dq (B, H, Tq, D); k, v, dk, dv (B, H, Tk, D); Tq <= Tk; D <= 128,
// a multiple of 8; any strides with a unit last one and the others multiples of 4
// elements, bases 16-byte aligned (the wrapper checks). stats: 3 x B H Tq floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DP = 128;         // head dim held in shared memory (zero above D)
constexpr int BR = 64;          // rows a block owns
constexpr int BC = 64;          // columns of a streamed tile
constexpr int PITCH = DP + 4;   // 132 floats: 16-byte reads of 8 neighbouring rows hit 8 bank groups
constexpr int SP = BC + 1;      // P / dS tile pitch
constexpr int THREADS = 256;

struct DqSmem {  // 152,320 bytes
  float q[BR * PITCH];
  float dout[BR * PITCH];
  float k[BC * PITCH];
  float v[BC * PITCH];
  float ds[BR * SP];
  float dd[BR];
  int lim[BR];
};

struct DkdvSmem {  // 169,472 bytes
  float k[BR * PITCH];
  float v[BR * PITCH];
  float q[BC * PITCH];
  float dout[BC * PITCH];
  float p[BR * SP];
  float ds[BR * SP];
  float m[BC], l[BC], dd[BC];
  int lim[BC];
};

struct Strides {  // (b, h, t) in elements
  long long sb, sh, st;
};

struct Args {
  const float *q, *k, *v, *o, *dout;
  float *dq, *dk, *dv, *stats;
  const int *lengths, *vad_pos;
  int H, Tq, Tk, D, mode;
  Strides q_s, k_s, v_s, o_s, do_s, dq_s, dk_s, dv_s;
  float sm_scale, scale_log2;
};

__device__ __forceinline__ int key_limit(int mode, int row, int len, int vp) {
  if (mode == 1) return min(row + 1, len);
  if (mode == 2 && row <= vp - 2) return min(vp, len);
  return len;
}

// sum / max over the 16 lanes of a half warp (the threads that share a score row)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows [r0, r0 + 64) of a (., D) slab into a shared tile, zero past `rows` and D
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long st, int r0,
                                          int rows, int D) {
  for (int i = threadIdx.x; i < BR * (DP / 4); i += THREADS) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows && c < D)
      val = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * PITCH + c) = val;
  }
}

// acc[i][j] += a[row ty + 16 i] . b[row tx + 16 j] over D, and the same for a2 . b2
template <bool TWO>
__device__ __forceinline__ void dots(float (&acc)[4][4], float (&acc2)[4][4], const float* a,
                                     const float* b, const float* a2, const float* b2, int ty,
                                     int tx, int D) {
  for (int c = 0; c < D; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * PITCH + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * PITCH + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
    if (TWO) {
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a2 + (ty + 16 * i) * PITCH + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b2 + (tx + 16 * j) * PITCH + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc2[i][j] = fmaf(av[i].x, bv[j].x, acc2[i][j]);
          acc2[i][j] = fmaf(av[i].y, bv[j].y, acc2[i][j]);
          acc2[i][j] = fmaf(av[i].z, bv[j].z, acc2[i][j]);
          acc2[i][j] = fmaf(av[i].w, bv[j].w, acc2[i][j]);
        }
    }
  }
}

// out[i][0..7] += sum_j w[row ty + 16 i][j] * src[j][cols tx*4 + {0..3}, 64 + tx*4 + {0..3}]
__device__ __forceinline__ void accumulate(float (&out)[4][8], const float* w, const float* src,
                                           int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < BC; ++j) {
    const float4 s0 = *reinterpret_cast<const float4*>(src + j * PITCH + 4 * tx);
    const float4 s1 = *reinterpret_cast<const float4*>(src + j * PITCH + 64 + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = w[(ty + 16 * i) * SP + j];
      out[i][0] = fmaf(x, s0.x, out[i][0]);
      out[i][1] = fmaf(x, s0.y, out[i][1]);
      out[i][2] = fmaf(x, s0.z, out[i][2]);
      out[i][3] = fmaf(x, s0.w, out[i][3]);
      out[i][4] = fmaf(x, s1.x, out[i][4]);
      out[i][5] = fmaf(x, s1.y, out[i][5]);
      out[i][6] = fmaf(x, s1.z, out[i][6]);
      out[i][7] = fmaf(x, s1.w, out[i][7]);
    }
  }
}

__device__ __forceinline__ void store_rows(float* dst, long long st, const float (&val)[4][8],
                                           int r0, int rows, int D, int ty, int tx, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * h + 4 * tx;
      if (c >= D) continue;
      *reinterpret_cast<float4*>(dst + (long long)r * st + c) =
          make_float4(val[i][4 * h] * scale, val[i][4 * h + 1] * scale,
                      val[i][4 * h + 2] * scale, val[i][4 * h + 3] * scale);
    }
  }
}

// P of one score (log2 units already scaled and masked) given its row's (m, l)
__device__ __forceinline__ float prob(float s2, float m, float l) { return exp2f(s2 - m) / l; }

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.y * BR;
  const int len = min(max(a.lengths[b], 0), a.Tk);
  const int vp = a.mode == 2 ? a.vad_pos[b] : 0;
  const int block_lim = key_limit(a.mode, min(q0 + BR, a.Tq) - 1, len, vp);
  const int ntiles = ((block_lim > 0 ? block_lim : a.Tk) + BC - 1) / BC;
  const float* kg = a.k + b * a.k_s.sb + h * a.k_s.sh;
  const float* vg = a.v + b * a.v_s.sb + h * a.v_s.sh;

  load_tile(sm.q, a.q + b * a.q_s.sb + h * a.q_s.sh, a.q_s.st, q0, a.Tq, a.D);
  load_tile(sm.dout, a.dout + b * a.do_s.sb + h * a.do_s.sh, a.do_s.st, q0, a.Tq, a.D);
  if (tid < BR) sm.lim[tid] = q0 + tid < a.Tq ? key_limit(a.mode, q0 + tid, len, vp) : 0;
  {  // Dr = rowsum(dO o O): four threads a row
    const int r = tid / 4, part = tid % 4;
    float s = 0.f;
    if (q0 + r < a.Tq) {
      const float* orow = a.o + b * a.o_s.sb + h * a.o_s.sh + (long long)(q0 + r) * a.o_s.st;
      const float* drow = a.dout + b * a.do_s.sb + h * a.do_s.sh + (long long)(q0 + r) * a.do_s.st;
      for (int c = 4 * part; c < a.D; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) sm.dd[r] = s;
  }
  __syncthreads();

  // pass 1: each row's max m and sum l over its keys (log2 units), online over tiles
  float m_r[4], l_r[4];
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_r[i] = MASKED, l_r[i] = 0.f, lim[i] = sm.lim[ty + 16 * i];
  float unused[4][4];
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile(sm.k, kg, a.k_s.st, kt * BC, a.Tk, a.D);
    __syncthreads();
    float s[4][4] = {};
    dots<false>(s, unused, sm.q, sm.k, nullptr, nullptr, ty, tx, a.D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * BC + tx + 16 * j;
        s[i][j] = key >= a.Tk ? -INFINITY : (key >= lim[i] ? MASKED : s[i][j] * a.scale_log2);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - mx);
      l_r[i] = l_r[i] * exp2f(m_r[i] - mx) + half_sum(sum);
      m_r[i] = mx;
    }
  }
  if (tx == 0) {
    const long long bh = (long long)blockIdx.x * a.Tq;
    const long long n = (long long)gridDim.x * a.Tq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (q0 + r < a.Tq) {
        a.stats[bh + q0 + r] = m_r[i];
        a.stats[n + bh + q0 + r] = l_r[i];
        a.stats[2 * n + bh + q0 + r] = sm.dd[r];
      }
    }
  }

  // pass 2: dQ = dS K over the same tiles
  float dq[4][8] = {};
  float dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dd[i] = sm.dd[ty + 16 * i];
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // the previous tile's dS, K and V are read
    load_tile(sm.k, kg, a.k_s.st, kt * BC, a.Tk, a.D);
    load_tile(sm.v, vg, a.v_s.st, kt * BC, a.Tk, a.D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dots<true>(s, dp, sm.q, sm.k, sm.dout, sm.v, ty, tx, a.D);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * BC + tx + 16 * j;
        float ds = 0.f;
        if (key < lim[i]) ds = prob(s[i][j] * a.scale_log2, m_r[i], l_r[i]) * (dp[i][j] - dd[i]);
        sm.ds[(ty + 16 * i) * SP + tx + 16 * j] = ds;
      }
    __syncthreads();
    accumulate(dq, sm.ds, sm.k, ty, tx);
  }
  store_rows(a.dq + b * a.dq_s.sb + h * a.dq_s.sh, a.dq_s.st, dq, q0, a.Tq, a.D, ty, tx,
             a.sm_scale);
}

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(smem_raw);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.y * BR;
  const int len = min(max(a.lengths[b], 0), a.Tk);
  const int vp = a.mode == 2 ? a.vad_pos[b] : 0;
  const float* qg = a.q + b * a.q_s.sb + h * a.q_s.sh;
  const float* dog = a.dout + b * a.do_s.sb + h * a.do_s.sh;
  const long long bh = (long long)blockIdx.x * a.Tq;
  const long long n = (long long)gridDim.x * a.Tq;

  load_tile(sm.k, a.k + b * a.k_s.sb + h * a.k_s.sh, a.k_s.st, k0, a.Tk, a.D);
  load_tile(sm.v, a.v + b * a.v_s.sb + h * a.v_s.sh, a.v_s.st, k0, a.Tk, a.D);

  float dk[4][8] = {}, dv[4][8] = {};
  const int qtiles = (a.Tq + BC - 1) / BC;
  for (int qt = 0; qt < qtiles; ++qt) {
    const int r0 = qt * BC;
    // a length-0 row averages V over every key; otherwise the tile's largest limit
    // (its last row's) must reach this key block
    if (len > 0 && key_limit(a.mode, min(r0 + BC, a.Tq) - 1, len, vp) <= k0) continue;
    __syncthreads();  // the previous tile's P, dS, Q and dO are read
    load_tile(sm.q, qg, a.q_s.st, r0, a.Tq, a.D);
    load_tile(sm.dout, dog, a.do_s.st, r0, a.Tq, a.D);
    if (tid < BC) {
      const int r = r0 + tid;
      const bool ok = r < a.Tq;
      sm.m[tid] = ok ? a.stats[bh + r] : 0.f;
      sm.l[tid] = ok ? a.stats[n + bh + r] : 1.f;
      sm.dd[tid] = ok ? a.stats[2 * n + bh + r] : 0.f;
      sm.lim[tid] = ok ? key_limit(a.mode, r, len, vp) : -1;  // -1: no such row
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};  // rows: keys ty + 16 i; columns: queries tx + 16 j
    dots<true>(s, dp, sm.k, sm.q, sm.v, sm.dout, ty, tx, a.D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, lim = sm.lim[c];
      const float m = sm.m[c], l = sm.l[c], ddq = sm.dd[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        float p = 0.f, ds = 0.f;
        if (lim >= 0 && key < a.Tk) {
          p = prob(key >= lim ? MASKED : s[i][j] * a.scale_log2, m, l);
          if (key < lim) ds = p * (dp[i][j] - ddq);
        }
        sm.p[(ty + 16 * i) * SP + c] = p;
        sm.ds[(ty + 16 * i) * SP + c] = ds;
      }
    }
    __syncthreads();
    accumulate(dv, sm.p, sm.dout, ty, tx);
    accumulate(dk, sm.ds, sm.q, ty, tx);
  }
  store_rows(a.dk + b * a.dk_s.sb + h * a.dk_s.sh, a.dk_s.st, dk, k0, a.Tk, a.D, ty, tx,
             a.sm_scale);
  store_rows(a.dv + b * a.dv_s.sb + h * a.dv_s.sh, a.dv_s.st, dv, k0, a.Tk, a.D, ty, tx, 1.f);
}

template <typename S> cudaError_t opt_in(void (*kernel)(Args)) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(S));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// q, o, dout, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); fp32. strides: (b, h, t) in
// elements for q, k, v, o, dout, dq, dk, dv (24 values). stats: 3 B H Tq floats of
// scratch (each row's m, l and Dr). mode: 0 none, 1 causal, 2 corner, which reads vad_pos
// (B int32; NULL otherwise). Two kernel launches on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* stats,
                                   const void* lengths, int B, int H, int Tq, int Tk, int D,
                                   const long long* strides, float sm_scale, int mode,
                                   const void* vad_pos, void* stream) {
  if (D < 8 || D > DP || D % 8 || Tq < 1 || Tk < Tq || mode < 0 || mode > 2 ||
      (mode == 2 && vad_pos == nullptr) || B * H < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.stats = static_cast<float*>(stats);
  a.lengths = static_cast<const int*>(lengths);
  a.vad_pos = static_cast<const int*>(vad_pos);
  a.H = H, a.Tq = Tq, a.Tk = Tk, a.D = D, a.mode = mode;
  Strides* dst[8] = {&a.q_s, &a.k_s, &a.v_s, &a.o_s, &a.do_s, &a.dq_s, &a.dk_s, &a.dv_s};
  for (int i = 0; i < 8; ++i) *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.scale_log2 = sm_scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = opt_in<DqSmem>(flash_bwd_dq_kernel);
  if (err == cudaSuccess) err = opt_in<DkdvSmem>(flash_bwd_dkdv_kernel);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<<<dim3(B * H, (Tq + BR - 1) / BR), THREADS, sizeof(DqSmem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<<<dim3(B * H, (Tk + BR - 1) / BR), THREADS, sizeof(DkdvSmem), s>>>(a);
  return (int)cudaGetLastError();
}
