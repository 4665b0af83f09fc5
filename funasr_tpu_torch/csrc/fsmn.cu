// FSMN memory block for Hopper (sm_90a), plain C interface loaded with ctypes.
//
//   out[b, t, c] = m[b, t] * ( round(sum_i w[c, i] * xm[b, t + i - left, c]) + xm[b, t, c] )
//   xm = m * x, zero outside [0, T);  m = mask (all ones when no mask is given)
//
// Replaces the TPU kernel benchmarks/bench_pallas_dwconv.py::dw_pallas (the FSMN
// depthwise conv1d) fused with the mask / residual / mask passes around it in
// funasr_tpu/models/sanm/attention.py::_fsmn and ::fsmn_decoder_apply, which are the
// same function. The taps accumulate in fp32 in the order i = 0 .. k - 1; round() is a
// rounding to x's dtype, and the residual sum is rounded again, in the order of the JAX
// functions (depthwise_conv1d_apply casts its fp32 sum to x's dtype before "+ v").
//
// What bounds it on the H100: bytes. One read of x and one write of out; k = 11 taps are
// 23 flops per element. At (32, 384, 512) bf16 that is 25.2 MB, 7.5 us at 3.35 TB/s
// (NVIDIA H100 80GB HBM3, 700 W); fp32 twice that. The first port (one scalar load per
// thread and time step, a runtime tap count, the mask byte read again by every thread,
// the window staged in shared memory) reached 15 % of it (0.0488 ms bf16): too few bytes
// in flight. What this design does about it:
//   * 16-byte loads and stores: a thread owns 8 bf16 or 4 fp32 channels (one vector),
//     a warp 32 neighbouring vectors of one time chunk (512 contiguous bytes a row);
//   * k and the left pad are template parameters (11 and 5, the SAN-M path's; 11 and 10,
//     the streaming decoder's causal step; 20 and 19, the VAD's causal memory, fp32
//     only; 21 and 10, the SeACo decoder's memory; 12 and 9, the keyword spotters'
//     FSMN with its lookahead (below), and 12 and 2, its input gradient; 17 and 8,
//     MossFormer's FFConvM conv (h + dwconv(h) with symmetric pads and no mask), which
//     its input gradient maps onto itself, at 4 channels a thread as k = 21; a
//     generic instantiation serves any other k up to 64 and any pads, with runtime taps
//     read through L1): the time loop is unrolled and the k-vector window of inputs
//     lives in registers (input row r in slot r % k); each input is loaded once per
//     thread through a per-thread ring of PREFETCH = 16 shared-memory slots (32 KB a
//     block) that cp.async fills 15 rows ahead, so 15 16-byte loads per thread are in
//     flight without costing registers; the halo rows of neighbouring chunks come from L2;
//   * at k = 21 a bf16 thread owns 4 channels (8-byte loads and stores, a 16 KB ring):
//     8 channels' window and taps would be 2 x 21 x 8 floats, and ptxas spilled them
//     (255 registers, 764 bytes of spill stores, even with the window kept as packed
//     bf16 pairs: it widens each once and keeps the floats); 4 channels take 198, as fp32's;
//   * the weights (each thread's k x vector taps, contiguous in the (C, k) layout, so
//     k 16-byte loads) are read once per thread into registers;
//   * the mask is read once per warp and time step, one byte per lane, and turned into
//     bits with __ballot_sync; a masked or out-of-range row is not loaded at all;
//   * TT = 24 time steps per warp: at (32, 384, 512) bf16 16 chunks x 2 vector groups x
//     32 utterances = 1,024 warps, about one wave at the 8 warps per SM that the bf16 register
//     count allows (222 registers; 2,048 warps for fp32, whose 4-channel vectors need
//     116, four blocks an SM); halo reads are (24 + 10) / 24 = 1.4x the inputs, from L2.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): bf16 0.0120 ms at (32, 384, 512), 63 % of the
// bytes bound (the first port 0.0488 ms), fp32 0.0181 ms, 83 %. The VAD's (1, 6019, 128)
// k = 20 fp32 took 0.0902 ms on the generic instantiation (2 % of its 1.8 us bound, 5x
// F.conv1d), hence its own instantiation; so did the SeACo decoder's k = 21 / left 10,
// which PERF.md's kernel table times against the generic one at (32, 208, 512).
//
// The lookahead FSMN (the keyword spotters' encoder: lorder 10, rorder 2) adds a right
// conv over frames t + 1 .. t + rorder to the causal left one. The two are one conv of
// k = lorder + rorder taps over frames t - (lorder - 1) .. t + rorder, the taps
// [conv_left | conv_right], pads (lorder - 1, rorder): this kernel at k 12 / left 9, one
// launch a block (models/fsmn_vad_streaming/encoder.py). With a streaming cache the
// input is concat(cache, h) and the first lorder - 1 rows are dropped; the right pad's
// zeros past the chunk's end are what the JAX block's right conv sees. The taps sum in
// one fp32 pass and round once, where the JAX block rounds h + left and then + right: at
// fp32 an ulp apart. k 12 / left 9 and its input gradient's k 12 / left 2 run at 4
// channels a thread (bf16's 8 would hold 2 x 12 x 8 floats of window and taps), and the
// weight gradient has a vector instantiation at k 12 / left 9.
//
// Training: the input gradient is this kernel run on dout with the taps reversed and the
// pads swapped (the transpose of a depthwise correlation; the wrapper's
// fsmn_memory_bwd_input). The streaming decoder's (10, 0) pads swap to (0, 10): on the
// generic instantiation its input gradient took 0.0324-0.0331 ms at (B, 49-73, 512),
// 3.6x torch.nn.grad.conv1d_input's (NVIDIA H100 80GB HBM3, 700 W), hence k = 11 / left
// 0 of its own (the phase 18 rows of PERF.md time it). The weight gradient is fsmn_memory_bwd_weight at the end of
// this file, per-chunk partials from one pass over the rows, then their ordered sum, with
// no float atomics (its own note is there).
//
// The plain mode (PLAIN = true; entry fsmn_depthwise_fwd) is dw_pallas's own function,
// core/layers.py::depthwise_conv1d_apply, as the Conformer's convolution module (k 15,
// pads 7 / 7), the Branchformer's cgMLP gate (k 31, pads 15 / 15, input masked) and the
// E-Branchformer's merge conv (k 3, pads 1 / 1) call it:
//
//   out[b, t, c] = round( (sum_i w[c, i] * xm[b, t + i - left, c]) + bias[c] )
//
// with no residual and no output mask. Each tap is a rounded product added with its own
// rounding (__fmul_rn, __fadd_rn: no fma), from 0 in the order i = 0 .. k - 1, then the
// bias, as the plain PyTorch version (ops/fsmn.py::depthwise_conv1d_ref) runs on the
// card, so the two agree bit for bit. k = 15 / left 7 has its own instantiation at 4
// channels a thread (8 bf16 channels' window and taps, 2 x 15 x 8 floats, would spill as
// k = 21's did), k = 3 / left 1 its own at the vector's channels, and fp32 k = 31 / left
// 15 its own at 2 channels a thread (8-byte loads: 2 x 31 x 2 floats of window and taps);
// bf16 k = 31 and any other k take the generic one, which reads each input row k times
// through L1 and each tap from global memory at every step. Measured (NVIDIA H100 80GB
// HBM3, 700 W), specialised against generic: fp32 k 31 at (4, 198, 1024) 0.0102 against
// 0.0806 ms (F.conv1d 0.0166), k 3 at (4, 198, 512) 0.0045 against 0.0131, k 15 at
// (1, 198, 256) 0.0075 against 0.0417; all launch-bound at these shapes. The chunk
// conformer's causal conv (k 15, pads 14 / 0) has its own instantiation too.
//
// In training the plain mode's input gradient is this kernel in the plain mode on dout with
// the taps reversed, the pads swapped and no bias (the causal conv's maps onto k 15 / left
// 0, an instantiation of its own; the symmetric ones onto themselves); the wrapper
// (ops/fsmn.py::depthwise_conv1d_bwd_input) multiplies by the input mask. The weight and
// bias gradients are fsmn_depthwise_bwd_weight at the end of this file. Neither replaces a
// TPU kernel: the JAX package takes the gradient of dw_pallas's function by XLA autodiff.
// Both are bytes-bound (x and dout read once, dx or dw + db written). Measured (NVIDIA
// H100 80GB HBM3, 700 W) at the AISHELL Conformer recipe's (16, 443, 256), k 15: dx
// 0.0130 ms (33 % of its bytes bound, 3.3x faster than torch.nn.grad.conv1d_input), dw +
// db 0.0176 (25 %, 4.8x faster than conv1d_weight and a sum); the causal conv's masked dx,
// the mask's multiply a launch of its own, 0.0215 (1.45x behind conv1d_input and that
// multiply).
//
// x is (B, T, C) with unit channel stride and batch / time strides that are multiples of
// the vector (it is the v slice of the fused q|k|v projection in the encoder, or the
// decoder's contiguous input), its base 16-byte aligned and C a multiple of the vector;
// the wrapper (funasr_tpu_torch/ops/fsmn.py) checks this and raises otherwise. w is
// (C, k) contiguous in x's dtype, 16-byte aligned; out is (B, T, C) contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// The library is compiled one nvcc process per source, all at once, so this file's many
// instantiations are split over four units that compile side by side: each of
// fsmn_bf16.cu, fsmn_depthwise.cu and fsmn_bwd.cu includes this file with FSMN_UNIT set
// and takes its own entry points (the build waited ~32 s on this file alone, the other
// sources ~8 s each; NVIDIA H100 host, nvcc 12.9).
//   0: the FSMN mode's forward (fsmn_memory_fwd, fsmn_memory_generic_fwd), fp32 here;
//   1: its bf16 instantiations (fsmn_memory_fwd_bf16, called by unit 0);
//   2: the plain depthwise mode's forward (fsmn_depthwise_fwd);
//   3: the weight gradients (fsmn_memory_bwd_weight, fsmn_depthwise_bwd_weight).
#ifndef FSMN_UNIT
#define FSMN_UNIT 0
#endif
// each unit leaves unreferenced the helpers that only the others' kernels use
#pragma nv_diag_suppress 177

namespace {

constexpr int TT = 24;        // time steps per warp
constexpr int WARPS = 4;      // warps per block, on consecutive time chunks
constexpr int PREFETCH = 16;  // cp.async ring slots per thread: 15 input rows in flight
constexpr int MAX_K = 64;

typedef __nv_bfloat16 bf16;

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// the raw load of V channels of T: 16 bytes, or 8 for 4 bf16 channels
template <typename T, int V> struct RawOf { typedef uint4 type; };
template <> struct RawOf<bf16, 4> { typedef uint2 type; };
template <> struct RawOf<float, 2> { typedef uint2 type; };

// the N floats of one 16-byte vector
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// round to T and back
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack(const uint2& u, float (&f)[4]) {  // 4 bf16
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const uint2& u, float (&f)[2]) {  // 2 fp32
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
}
__device__ __forceinline__ uint2 pack(const float (&f)[2], float*) {
  return make_uint2(__float_as_uint(f[0]), __float_as_uint(f[1]));
}

__device__ __forceinline__ uint4 pack(const float (&f)[4], float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint2 pack(const float (&f)[4], bf16*) {
  __nv_bfloat162 p0 = __floats2bfloat162_rn(f[0], f[1]), p1 = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<uint32_t*>(&p0), *reinterpret_cast<uint32_t*>(&p1));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], bf16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename R> __device__ __forceinline__ R load(const void* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

__device__ __forceinline__ void cp_async(uint4* dst, const void* src, bool full) {
  hopper::cp_async16(dst, src, full);
}
__device__ __forceinline__ void cp_async(uint2* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// one tap: fma for the FSMN memory; for the plain mode the product and the sum each
// rounded, as the plain PyTorch version's separate multiply and add
template <bool PLAIN> __device__ __forceinline__ float tap(float x, float w, float acc) {
  return PLAIN ? __fadd_rn(acc, __fmul_rn(x, w)) : fmaf(x, w, acc);
}

// KS > 0: k = KS and left = LS, window in registers; KS == 0: any k and left (the
// runtime `k`, `left`), taps read through L1. V channels a thread (one raw load). Block:
// WARPS warps on consecutive time chunks of TT steps, each warp 32 channel vectors. Grid
// (ceil(C / V / 32), ceil(chunks / WARPS), B). PLAIN: the plain depthwise conv (bias, or
// none when `bias` is null; no residual, no output mask), else the FSMN memory.
template <bool PLAIN, typename T, int KS, int LS, int V>
__global__ void __launch_bounds__(32 * WARPS, 2)
fsmn_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
            const uint8_t* __restrict__ mask, T* __restrict__ out, int T_len, int C, int k,
            int left_rt, long long xsb, long long xst) {
  typedef typename RawOf<T, V>::type Raw;
  constexpr int NW = KS > 0 ? (TT + KS - 1 + 31) / 32 : (TT + MAX_K - 1 + 31) / 32;
  const int K = KS > 0 ? KS : k;
  const int left = KS > 0 ? LS : left_rt;
  const int R = TT + K - 1;  // input rows of the chunk: t0 - left + r
  const int lane = threadIdx.x % 32;
  const int t0 = (blockIdx.y * WARPS + threadIdx.x / 32) * TT;
  const int b = blockIdx.z;
  if (t0 >= T_len) return;  // the whole warp
  const int cv = blockIdx.x * 32 + lane;  // channel vector
  const bool active = cv * V < C;

  // valid[r]: row r inside [0, T) and unmasked; one mask byte per lane and row
  uint32_t valid[NW];
  const uint8_t* mrow = mask ? mask + (long long)b * T_len : nullptr;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int r = lane + 32 * i, t = t0 - left + r;
    const bool ok = r < R && t >= 0 && t < T_len && (!mrow || mrow[t]);
    valid[i] = __ballot_sync(0xffffffffu, ok);
  }
  if (!active) return;
  auto row_ok = [&](int r) -> bool {  // selects, no dynamic index into valid[]
    const uint32_t word = r < 32 ? valid[0] : (r < 64 ? valid[NW > 1 ? 1 : 0] : valid[NW - 1]);
    return (word >> (r & 31)) & 1u;
  };

  const T* xb = x + b * xsb + (long long)cv * V;
  T* ob = out + ((long long)b * T_len + t0) * C + (long long)cv * V;
  const T* wv = w + (long long)cv * V * K;  // this thread's V x K taps, contiguous
  float bv[V];  // the plain mode's bias
#pragma unroll
  for (int e = 0; e < V; ++e) bv[e] = 0.f;
  if (PLAIN && bias) unpack(load<Raw>(bias + (long long)cv * V), bv);
  // the plain mode's output: the tap sum, plus the bias when there is one, rounded once
  auto plain_out = [&](float acc, int e) -> float {
    return round_to(bias ? __fadd_rn(acc, bv[e]) : acc, (T*)nullptr);
  };

  if constexpr (KS > 0) {
    // weights: wr[i][j] = w[cv * V + j, i], from K raw loads
    float wr[KS][V];
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      float f[V];
      unpack(load<Raw>(wv + u * V), f);
#pragma unroll
      for (int e = 0; e < V; ++e) wr[(u * V + e) % KS][(u * V + e) / KS] = f[e];
    }

    // input rows ride a per-thread ring of PREFETCH raw slots, filled by cp.async
    // PREFETCH - 1 rows ahead (a masked or out-of-range row is zero-filled, not read);
    // each thread reads back only its own copies, so no barrier is needed
    constexpr int RS = TT + KS - 1;
    __shared__ Raw ring[WARPS][PREFETCH][32];
    Raw* slot = &ring[threadIdx.x / 32][0][lane];
    auto issue = [&](int r) {
      const bool ok = row_ok(r);
      cp_async(slot + (r % PREFETCH) * 32, ok ? xb + (t0 - left + r) * xst : xb, ok);
    };
#pragma unroll
    for (int r = 0; r < PREFETCH - 1; ++r) {
      if (r < RS) issue(r);
      hopper::cp_async_commit();
    }

    float xw[KS][V];  // input row r in slot r % KS
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      if (r + PREFETCH - 1 < RS) issue(r + PREFETCH - 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<PREFETCH - 1>();  // row r has landed
      unpack(slot[(r % PREFETCH) * 32], xw[r % KS]);
      if (r < KS - 1) continue;
      const int tt = r - (KS - 1);  // output t0 + tt reads rows tt .. tt + KS - 1
      if (t0 + tt >= T_len) break;
      float res[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < KS; ++i) acc = tap<PLAIN>(xw[(tt + i) % KS][e], wr[i][e], acc);
        res[e] = PLAIN ? plain_out(acc, e) : round_to(acc, (T*)nullptr) + xw[(tt + left) % KS][e];
      }
      // row tt + left is output t0 + tt's own: valid means unmasked (t < T holds); the
      // plain mode masks no output
      if (!PLAIN && !row_ok(tt + left))
#pragma unroll
        for (int e = 0; e < V; ++e) res[e] = 0.f;
      *reinterpret_cast<Raw*>(ob + (long long)tt * C) = pack(res, (T*)nullptr);
    }
  } else {
    for (int tt = 0; tt < TT && t0 + tt < T_len; ++tt) {
      float acc[V], f[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int i = 0; i < K; ++i) {
        if (!row_ok(tt + i)) continue;  // a zero input adds exactly 0 to every tap
        unpack(load<Raw>(xb + (t0 - left + tt + i) * xst), f);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = tap<PLAIN>(f[e], to_float(wv[e * K + i]), acc[e]);
      }
      float res[V];
      if (PLAIN) {
#pragma unroll
        for (int e = 0; e < V; ++e) res[e] = plain_out(acc[e], e);
      } else if (row_ok(tt + left)) {
        unpack(load<Raw>(xb + (t0 + tt) * xst), f);
#pragma unroll
        for (int e = 0; e < V; ++e) res[e] = round_to(acc[e], (T*)nullptr) + f[e];
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) res[e] = 0.f;
      }
      *reinterpret_cast<Raw*>(ob + (long long)tt * C) = pack(res, (T*)nullptr);
    }
  }
}

template <bool PLAIN, typename T, int KS, int LS, int V = Vec<T>::N>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* mask, void* out,
                   int B, int T_len, int C, int K, int left, long long xsb, long long xst,
                   cudaStream_t stream) {
  const int vectors = C / V, chunks = (T_len + TT - 1) / TT;
  dim3 grid((vectors + 31) / 32, (chunks + WARPS - 1) / WARPS, B);
  fsmn_kernel<PLAIN, T, KS, LS, V><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), T_len, C, K, left, xsb, xst);
  return cudaGetLastError();
}

// generic: launch the runtime-k instantiation whatever k and pads are (to time it
// against a specialised one)
template <bool PLAIN, typename T>
cudaError_t dispatch(const void* x, const void* w, const void* bias, const void* mask,
                     void* out, int B, int T_len, int C, int K, int left, long long xsb,
                     long long xst, bool generic, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (K < 1 || K > MAX_K || left < 0 || left > K - 1 || C % V || xsb % V || xst % V ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16)
    return cudaErrorInvalidValue;
  if (generic)
    return launch<PLAIN, T, 0, 0>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst, stream);
  if constexpr (PLAIN) {
    // the Conformer's convolution module (cnn_module_kernel 15): 4 channels a thread
    if (K == 15 && left == 7)
      return launch<PLAIN, T, 15, 7, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                        stream);
    // the chunk conformer's causal conv (pads 14 / 0), and its input gradient in training
    // (the taps reversed, the pads swapped to 0 / 14)
    if (K == 15 && left == 14)
      return launch<PLAIN, T, 15, 14, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                         stream);
    if (K == 15 && left == 0)
      return launch<PLAIN, T, 15, 0, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                        stream);
    // the E-Branchformer's merge conv
    if (K == 3 && left == 1)
      return launch<PLAIN, T, 3, 1>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                    stream);
    // the cgMLP gate (cgmlp_conv_kernel 31), fp32: 2 channels a thread (8-byte loads), so
    // that the 31-row window and the taps fit in registers; bf16 stays generic
    if constexpr (Vec<T>::N == 4)
      if (K == 31 && left == 15)
        return launch<PLAIN, T, 31, 15, 2>(x, w, bias, mask, out, B, T_len, C, K, left, xsb,
                                           xst, stream);
    return launch<PLAIN, T, 0, 0>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst, stream);
  } else {
    if (K == 11 && left == 5)  // the SAN-M encoders' and decoder's k and pads
      return launch<PLAIN, T, 11, 5>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                     stream);
    // the streaming decoder's causal step over concat(cache, x) (the offline decoder of a
    // streaming model, sanm_shfit 5, has the same pads)
    if (K == 11 && left == 10)
      return launch<PLAIN, T, 11, 10>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                      stream);
    // that decoder's input gradient in training: the forward kernel, pads swapped to (0, 10)
    if (K == 11 && left == 0)
      return launch<PLAIN, T, 11, 0>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                     stream);
    // the VAD's causal memory (lorder 20, fp32): its window and taps take 160 registers
    // a thread at 4 channels; bf16's 8 channels would spill, so bf16 stays generic
    if constexpr (Vec<T>::N == 4)
      if (K == 20 && left == 19)
        return launch<PLAIN, T, 20, 19>(x, w, bias, mask, out, B, T_len, C, K, left, xsb,
                                        xst, stream);
    // the SeACo decoder's memory (kernel_size 21, sanm_shfit 0): 4 channels a thread, so
    // that bf16's window and taps fit in registers as fp32's do
    if (K == 21 && left == 10)
      return launch<PLAIN, T, 21, 10, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb,
                                         xst, stream);
    // the keyword spotters' FSMN with its lookahead (lorder 10, rorder 2: the left and
    // right taps as one k = 12 conv over frames t - 9 .. t + 2), and its input gradient in
    // training (the taps reversed, the pads swapped to 2 / 9); 4 channels a thread, so
    // that bf16's window and taps fit in registers as at k = 21
    if (K == 12 && left == 9)
      return launch<PLAIN, T, 12, 9, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb,
                                        xst, stream);
    if (K == 12 && left == 2)
      return launch<PLAIN, T, 12, 2, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb,
                                        xst, stream);
    // MossFormer's FFConvM conv (k 17, pads 8 / 8, no mask), which its input gradient
    // maps onto itself: 4 channels a thread, as at k = 21
    if (K == 17 && left == 8)
      return launch<PLAIN, T, 17, 8, 4>(x, w, bias, mask, out, B, T_len, C, K, left, xsb,
                                        xst, stream);
    return launch<PLAIN, T, 0, 0>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                  stream);
  }
}

template <bool PLAIN>
int run(int dtype, const void* x, const void* w, const void* bias, const void* mask, void* out,
        int B, int T_len, int C, int K, int left, long long xsb, long long xst, bool generic,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<PLAIN, float>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                       generic, s);
  if (dtype == 1)
    return (int)dispatch<PLAIN, bf16>(x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst,
                                      generic, s);
  return (int)cudaErrorInvalidValue;
}

// ---- the weight gradient ---------------------------------------------------------------
//
//   dw[c, j] = sum_{b, t} g[b, t, c] * xm[b, t + j - left, c],  g = m * dout
//
// (the input gradient is the forward kernel itself, run by the wrapper on dout with the
// taps reversed and the pads swapped). A reduction over B T rows for each of the C k taps,
// deterministic: each chunk of rows writes a (k, C) partial, and a second kernel adds the
// partials in chunk order. No float atomics, so two runs give bit-equal gradients.
//
// What bounds it on the H100: bytes. x and dout are read once, 8 B T C bytes (3.9 MB at
// the recipe's (5, 190, 512), 1.2 us at 3.35 TB/s); 2 k flops a value. The first kernel
// (grid (C / 128, k, chunks), one 4-byte scalar a thread and row) read every g and x row
// once per tap, k = 11 times, mostly from L2, and took 0.0357 ms there (NVIDIA H100 80GB
// HBM3, 700 W), 2x torch.nn.grad.conv1d_weight. What the specialised kernel (k and left
// as template parameters: 11 and 5, the pads of every FSMN the training path runs) does:
//   * the forward's shape: a thread owns a 16-byte vector of 4 channels, a warp 128
//     neighbouring channels, and a warp walks a chunk of (b, t) rows in time order;
//   * a block (4 warps on 4 consecutive chunks of the same 128 channels) stages its g
//     rows and its x rows with their (k - 1)-row halo in shared memory by one batch of
//     cp.async (a row outside [0, B T) is zero-filled, not read): one memory latency a
//     block. A first version streamed each warp's rows through a per-thread
//     cp.async ring instead and paid ~0.28 us a row (0.0147 ms in all at (5, 190, 512));
//   * the last k rows of x stay in registers (row of step i in slot i % k, the walk
//     unrolled k steps at a time), the k x 4 tap accumulators too; the window slides on
//     over flat rows, and a tap whose x row lies outside its g row's utterance is
//     skipped, so a batch boundary inside a chunk costs nothing;
//   * the mask bits of the block's rows and halo are read once, a byte a lane, as
//     __ballot_sync words, while the rows load: a masked x row or g row is loaded all the
//     same and skipped as its taps are formed;
//   * the 4 warps' accumulators are added in warp order into one partial a block, and
//     the second kernel adds the blocks' partials in order, 16 loads in flight a thread;
//   * chunks of 4-16 rows, as many as give every SM two blocks (ops/fsmn.py::dw_plan):
//     60 blocks of 4 x 4 rows for each of the 4 channel groups at (5, 190, 512); the
//     halo adds (k - 1) / (4 rows) of x reads.
// Measured (NVIDIA H100 80GB HBM3, 700 W): 0.0102 ms at (5, 190, 512), 11 % of the bound
// and 1.7x faster than conv1d_weight; what is left is two launches' latency (the block
// kernel ~0.0057, the sum ~0.0028 by profile). Any other k or pads, or C not a multiple
// of 4, take the first kernel as the generic instantiation (the wrapper hands the vector
// kernel 16-byte vectorizable x and dout).
//
// The plain depthwise mode's gradient (fsmn_depthwise_bwd_weight) runs the same two
// kernels with PLAIN set: dout is not masked (only x is, as the forward masks its input),
// and one more partial row sums dout, the bias gradient, in the same pass and the same
// ordered second pass. Its vector instantiations: k 15 / left 7 (the Conformer's), k 15 /
// left 14 (the chunk conformer's causal conv) and k 3 / left 1 (the E-Branchformer's
// merge) at 4 channels a thread, k 31 / left 15 (the cgMLP gate) at 2, so that 31 rows of
// window and 32 of accumulators stay in registers as in the forward.
constexpr int DW_THREADS = 128;   // generic kernel: channels a block
constexpr int DW_WARPS = 4;       // specialised kernel: warps a block, on consecutive chunks
constexpr int DW_MAX_ROWS = 16;   // rows a warp's chunk, at most
constexpr int DW_MASK_WORDS = 3;  // ballot words: a block's rows and its k - 1 halo rows

// Block (z, y): the 32 V channels of group y (V a thread) of the flat rows [R0, R0 +
// DW_WARPS rows), R0 = z DW_WARPS rows; warp w walks rows R0 + w rows + [0, rows). The
// block stages its g rows and its x rows with the (k - 1)-row halo in shared memory by one
// batch of cp.async, then each warp slides a k-row window of x over its chunk in registers;
// the warps' accumulators are added in warp order into the block's partial (z, KP, C).
// PLAIN (the plain depthwise mode's gradient): g = dout is not masked (only x is), and a
// (K + 1)-th partial row sums g, the bias gradient, in the same pass; else the FSMN mode:
// g = m dout, KP = K.
template <int K, int LEFT, int V, bool PLAIN>
__global__ void __launch_bounds__(32 * DW_WARPS)
fsmn_bwd_weight_vec_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           const uint8_t* __restrict__ mask, float* __restrict__ partial,
                           int B, int T_len, int C, long long xsb, long long xst, long long gsb,
                           long long gst, int rows) {
  typedef typename RawOf<float, V>::type Raw;  // 16 bytes (V 4) or 8 (V 2)
  constexpr int KP = PLAIN ? K + 1 : K;       // partial rows: the taps, then the bias's
  static_assert(K <= 31, "tap masks are 32-bit words");
  static_assert(DW_WARPS * DW_MAX_ROWS + K - 1 <= 32 * DW_MASK_WORDS, "mask words");
  // x rows [R0 - LEFT, R1 + RIGHT), then g rows [R0, R1); at the end the warps' sums
  extern __shared__ uint4 stage_words[];
  Raw* stage = reinterpret_cast<Raw*>(stage_words);
  __shared__ uint32_t bits[DW_MASK_WORDS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (blockIdx.y * 32 * V >= C) return;  // the whole block
  const int cv = blockIdx.y * 32 + lane;  // channel vector
  const bool active = cv * V < C;
  const int n_rows = B * T_len;
  const int R0 = blockIdx.x * DW_WARPS * rows, R1 = min(R0 + DW_WARPS * rows, n_rows);
  const int h0 = R0 - LEFT;           // the flat row of x slot 0 and of bit 0
  const int xrows = R1 - R0 + K - 1;  // staged x rows
  Raw* xs = stage;
  Raw* gs = stage + xrows * 32;

  // one batch of loads: a warp a row (32 V floats), a lane one vector; rows outside
  // [0, B T) are zero-filled, not read. The mask is applied as the rows are used, so the
  // loads need not wait for it.
  const float* xv = x + (long long)cv * V;
  const float* gv = g + (long long)cv * V;
  for (int r = warp; r < xrows; r += DW_WARPS) {
    const int f = h0 + r, b = f / T_len, t = f - b * T_len;
    const bool ok = active && f >= 0 && f < n_rows;
    cp_async(xs + r * 32 + lane, ok ? xv + b * xsb + t * xst : xv, ok);
  }
  for (int r = warp; r < R1 - R0; r += DW_WARPS) {
    const int f = R0 + r, b = f / T_len, t = f - b * T_len;
    cp_async(gs + r * 32 + lane, active ? gv + b * gsb + t * gst : gv, active);
  }
  hopper::cp_async_commit();
  if (warp == 0) {  // valid rows (inside [0, B T) and unmasked), one mask byte a lane
#pragma unroll
    for (int i = 0; i < DW_MASK_WORDS; ++i) {
      const int f = h0 + 32 * i + lane;
      const bool ok = f >= 0 && f < n_rows && (!mask || mask[f]);
      const uint32_t word = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) bits[i] = word;
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
  // the K bits of rows o .. o + K - 1 past h0 (o >= 0)
  auto window = [&](int o) -> uint32_t {
    const int w = o >> 5;
    const uint64_t two =
        ((uint64_t)(w + 1 < DW_MASK_WORDS ? bits[w + 1] : 0u) << 32) | bits[w];
    return (uint32_t)(two >> (o & 31)) & ((1u << K) - 1u);
  };

  // this warp's chunk [c0, c1): step i loads x row c0 - LEFT + i into slot i % K; from
  // step K - 1 on, g row r = c0 + i - (K - 1) takes the window, tap j reading x row
  // r + j - LEFT, the row of step i - (K - 1) + j; taps outside the row's utterance
  // ([0, T)) are skipped: the window runs on across batch boundaries
  const int c0 = R0 + warp * rows, c1 = min(c0 + rows, R1);
  const int steps = c1 > c0 ? c1 - c0 + K - 1 : 0;
  int t = c0 >= 0 && c0 < n_rows ? c0 % T_len : 0;  // the time of g row r
  float xw[K][V], acc[KP][V];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) xw[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KP; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
  for (int i0 = 0; i0 < steps; i0 += K) {
#pragma unroll
    for (int s = 0; s < K; ++s) {  // step i = i0 + s: its x row goes to slot s
      const int i = i0 + s;
      if (i >= steps) break;
      unpack(xs[(c0 - R0 + i) * 32 + lane], xw[s]);
      if (i < K - 1) continue;
      const int r = c0 + i - (K - 1);
      // taps j whose x row r + j - LEFT is valid and inside r's utterance ([0, T)), if
      // g row r counts (the FSMN mode's g row must be unmasked)
      const uint32_t taps = (PLAIN || (window(r - h0) & 1u))
                                ? window(r - LEFT - h0) &
                                      (((1u << K) - 1u) << max(LEFT - t, 0)) &
                                      ((1u << min(T_len - t + LEFT, K)) - 1u)
                                : 0u;
      if (PLAIN || taps) {
        float gf[V];
        unpack(gs[(r - R0) * 32 + lane], gf);
#pragma unroll
        for (int j = 0; j < K; ++j)
          if ((taps >> j) & 1u)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[j][e] = fmaf(gf[e], xw[(s + 1 + j) % K][e], acc[j][e]);
        if (PLAIN)  // the bias gradient: every g row
#pragma unroll
          for (int e = 0; e < V; ++e) acc[KP - 1][e] += gf[e];
      }
      if (++t == T_len) t = 0;
    }
  }
  __syncthreads();  // every warp is done with the staged rows: they hold the sums now

  // the block's partial: warp 0's accumulators, then warps 1, 2, 3's, in that order
  float* red = reinterpret_cast<float*>(stage_words);  // [warp - 1][V j + e][lane]
  if (warp > 0)
#pragma unroll
    for (int j = 0; j < KP; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) red[((warp - 1) * V * KP + V * j + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  if (warp > 0 || !active) return;
#pragma unroll
  for (int w = 0; w < DW_WARPS - 1; ++w)
#pragma unroll
    for (int j = 0; j < KP; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][e] += red[(w * V * KP + V * j + e) * 32 + lane];
#pragma unroll
  for (int j = 0; j < KP; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e)
      partial[((long long)blockIdx.x * KP + j) * C + cv * V + e] = acc[j][e];
}

// the generic instantiation: block (x, j, z) sums the rows of chunk z for 128 channels of
// tap j in a fixed order (four accumulators, by row mod 4, added at the end), one 4-byte
// scalar a thread and row. PLAIN: g is not masked, and j = K (the grid's last row) sums
// g, the bias gradient; partials (chunks, K + PLAIN, C).
template <bool PLAIN>
__global__ void __launch_bounds__(DW_THREADS)
fsmn_bwd_weight_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                               const uint8_t* __restrict__ mask, float* __restrict__ partial,
                               int B, int T_len, int C, int K, int left, long long xsb,
                               long long xst, long long gsb, long long gst, int rows_per_chunk) {
  const int c = blockIdx.x * DW_THREADS + threadIdx.x;
  const int j = blockIdx.y, z = blockIdx.z;
  const int KP = PLAIN ? K + 1 : K;
  const int r0 = z * rows_per_chunk, r1 = min(r0 + rows_per_chunk, B * T_len);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < C) {
    for (int r = r0; r < r1; ++r) {
      const int b = r / T_len, t = r % T_len, s = t + j - left;
      if (PLAIN && j == K) {
        acc[r & 3] += g[b * gsb + t * gst + c];
        continue;
      }
      if (s < 0 || s >= T_len) continue;
      if (mask && ((!PLAIN && !mask[(long long)b * T_len + t]) || !mask[(long long)b * T_len + s]))
        continue;
      acc[r & 3] = fmaf(g[b * gsb + t * gst + c], x[b * xsb + s * xst + c], acc[r & 3]);
    }
    partial[((long long)z * KP + j) * C + c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

// dw[c, j] = the partials[z, j, c] added in z order (j < K), db[c] those of row K; a thread
// a (j, c), c the fastest, so the partials are read in whole rows, 16 loads in flight
// before their adds
__global__ void fsmn_bwd_weight_reduce_kernel(const float* __restrict__ partial,
                                              float* __restrict__ dw, float* __restrict__ db,
                                              int C, int K, int KP, int parts) {
  constexpr int ILP = 16;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // j * C + c
  if (i >= C * KP) return;
  const long long step = (long long)KP * C;
  float sum = 0.f;
  int z = 0;
  for (; z + ILP <= parts; z += ILP) {
    float v[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) v[u] = partial[(z + u) * step + i];
#pragma unroll
    for (int u = 0; u < ILP; ++u) sum += v[u];
  }
  for (; z < parts; ++z) sum += partial[z * step + i];
  if (i / C < K)
    dw[(i % C) * K + i / C] = sum;
  else
    db[i % C] = sum;
}

// the vector kernel at (K, LEFT, V): opt in to the shared memory a block stages (above
// 48 KB at 16 rows a chunk), then one launch of `parts` blocks a channel group
template <int K, int LEFT, int V, bool PLAIN>
cudaError_t launch_bwd_weight_vec(const float* x, const float* g, const uint8_t* m, float* part,
                                  int parts, int B, int T_len, int C, long long xsb,
                                  long long xst, long long gsb, long long gst, int rows,
                                  cudaStream_t s) {
  constexpr int KP = PLAIN ? K + 1 : K;
  const int bytes = max((2 * DW_WARPS * rows + K - 1) * 32 * V * (int)sizeof(float),
                        (DW_WARPS - 1) * V * KP * 32 * (int)sizeof(float));
  const cudaError_t opt = cudaFuncSetAttribute(fsmn_bwd_weight_vec_kernel<K, LEFT, V, PLAIN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
  if (opt != cudaSuccess) return opt;
  fsmn_bwd_weight_vec_kernel<K, LEFT, V, PLAIN>
      <<<dim3(parts, (C + 32 * V - 1) / (32 * V)), 32 * DW_WARPS, bytes, s>>>(
          x, g, m, part, B, T_len, C, xsb, xst, gsb, gst, rows);
  return cudaGetLastError();
}

// one pass of partials, then their ordered sum; vec: 0 the generic kernel, else the
// vector kernel at V = vec channels a thread, for the (K, left) it was instantiated at
template <bool PLAIN>
int bwd_weight(const void* x, const void* dout, const void* mask, void* partial, void* dw,
               void* db, int B, int T_len, int C, int K, int left, long long xsb, long long xst,
               long long gsb, long long gst, int rows_per_chunk, int vec, void* stream) {
  if (K < 1 || K > MAX_K || left < 0 || left > K - 1 || rows_per_chunk < 1 || B < 1 ||
      T_len < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (B * T_len + rows_per_chunk - 1) / rows_per_chunk;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(dout);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* part = static_cast<float*>(partial);
  const int KP = PLAIN ? K + 1 : K;
  int parts = chunks;
  cudaError_t err;
  if (vec) {
    if (C % vec || xsb % vec || xst % vec || gsb % vec || gst % vec ||
        reinterpret_cast<uintptr_t>(x) % (4 * vec) ||
        reinterpret_cast<uintptr_t>(dout) % (4 * vec) || rows_per_chunk > DW_MAX_ROWS)
      return (int)cudaErrorInvalidValue;
    parts = (chunks + DW_WARPS - 1) / DW_WARPS;
    const auto at = [&](int k, int l, int v) { return K == k && left == l && vec == v; };
    if (!PLAIN && at(11, 5, 4))  // every FSMN of the training path
      err = launch_bwd_weight_vec<11, 5, 4, false>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                   xst, gsb, gst, rows_per_chunk, s);
    else if (!PLAIN && at(12, 9, 4))  // the keyword spotters' FSMN with its lookahead
      err = launch_bwd_weight_vec<12, 9, 4, false>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                   xst, gsb, gst, rows_per_chunk, s);
    else if (!PLAIN && at(17, 8, 4))  // MossFormer's FFConvM conv
      err = launch_bwd_weight_vec<17, 8, 4, false>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                   xst, gsb, gst, rows_per_chunk, s);
    else if (PLAIN && at(15, 7, 4))  // the Conformer's convolution module
      err = launch_bwd_weight_vec<15, 7, 4, true>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                  xst, gsb, gst, rows_per_chunk, s);
    else if (PLAIN && at(15, 14, 4))  // the chunk conformer's causal conv
      err = launch_bwd_weight_vec<15, 14, 4, true>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                   xst, gsb, gst, rows_per_chunk, s);
    else if (PLAIN && at(3, 1, 4))  // the E-Branchformer's merge conv
      err = launch_bwd_weight_vec<3, 1, 4, true>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                 xst, gsb, gst, rows_per_chunk, s);
    else if (PLAIN && at(31, 15, 2))  // the cgMLP gate, 2 channels a thread as its forward
      err = launch_bwd_weight_vec<31, 15, 2, true>(xf, gf, m, part, parts, B, T_len, C, xsb,
                                                   xst, gsb, gst, rows_per_chunk, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    fsmn_bwd_weight_partial_kernel<PLAIN>
        <<<dim3((C + DW_THREADS - 1) / DW_THREADS, KP, chunks), DW_THREADS, 0, s>>>(
            xf, gf, m, part, B, T_len, C, K, left, xsb, xst, gsb, gst, rows_per_chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  fsmn_bwd_weight_reduce_kernel<<<(C * KP + 255) / 256, 256, 0, s>>>(
      part, static_cast<float*>(dw), static_cast<float*>(db), C, K, KP, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// the FSMN mode's bf16 forward: dispatch<false, bf16>, defined in unit 1 (fsmn_bf16.cu)
cudaError_t fsmn_memory_fwd_bf16(const void* x, const void* w, const void* mask, void* out,
                                 int B, int T_len, int C, int K, int left, long long xsb,
                                 long long xst, bool generic, cudaStream_t stream);

#if FSMN_UNIT == 0
namespace {

int fsmn_forward(int dtype, const void* x, const void* w, const void* mask, void* out, int B,
                 int T_len, int C, int K, int left, long long xsb, long long xst, bool generic,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<false, float>(x, w, nullptr, mask, out, B, T_len, C, K, left, xsb,
                                       xst, generic, s);
  if (dtype == 1)
    return (int)fsmn_memory_fwd_bf16(x, w, mask, out, B, T_len, C, K, left, xsb, xst,
                                     generic, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, w and out): 0 = float32, 1 = bfloat16. mask: (B, T) bytes or NULL.
// xsb, xst: batch and time strides of x in elements.
extern "C" int fsmn_memory_fwd(int dtype, const void* x, const void* w, const void* mask,
                               void* out, int B, int T_len, int C, int K, int left,
                               long long xsb, long long xst, void* stream) {
  return fsmn_forward(dtype, x, w, mask, out, B, T_len, C, K, left, xsb, xst, false, stream);
}

// the same, always on the generic (runtime-k) instantiation
extern "C" int fsmn_memory_generic_fwd(int dtype, const void* x, const void* w,
                                       const void* mask, void* out, int B, int T_len, int C,
                                       int K, int left, long long xsb, long long xst,
                                       void* stream) {
  return fsmn_forward(dtype, x, w, mask, out, B, T_len, C, K, left, xsb, xst, true, stream);
}
#endif

#if FSMN_UNIT == 1
cudaError_t fsmn_memory_fwd_bf16(const void* x, const void* w, const void* mask, void* out,
                                 int B, int T_len, int C, int K, int left, long long xsb,
                                 long long xst, bool generic, cudaStream_t stream) {
  return dispatch<false, bf16>(x, w, nullptr, mask, out, B, T_len, C, K, left, xsb, xst,
                               generic, stream);
}
#endif

#if FSMN_UNIT == 2
// the plain depthwise conv (dw_pallas's function): x (B, T, C), w (C, K), bias (C,) or
// NULL, all in x's dtype (fp32 0 / bf16 1), w and bias 16-byte aligned; mask (B, T) bytes
// or NULL masks the input; out (B, T, C) contiguous. generic: 1 forces the runtime-k
// instantiation (to time k 15's own against it).
extern "C" int fsmn_depthwise_fwd(int dtype, const void* x, const void* w, const void* bias,
                                  const void* mask, void* out, int B, int T_len, int C, int K,
                                  int left, long long xsb, long long xst, int generic,
                                  void* stream) {
  return run<true>(dtype, x, w, bias, mask, out, B, T_len, C, K, left, xsb, xst, generic != 0,
                   stream);
}
#endif

#if FSMN_UNIT == 3
// fp32 weight gradient of the FSMN memory: x (B, T, C) the forward's input, dout (B, T, C)
// the output's gradient (any batch / time strides, unit channel stride), mask (B, T)
// bytes or NULL -> dw (C, K) contiguous. specialised: 1 for the vector kernel (k 11, left
// 5, k 12, left 9, or k 17, left 8; C, x's and dout's batch / time strides multiples of 4,
// bases 16-byte aligned; rows_per_chunk <= 16), 0 for the generic one. partial: parts x K
// x C floats of scratch; chunks = ceil(B T / rows_per_chunk), and parts = ceil(chunks / 4)
// for the vector kernel (a block of 4 chunks), chunks for the generic one. Two kernel
// launches on `stream`.
extern "C" int fsmn_memory_bwd_weight(const void* x, const void* dout, const void* mask,
                                      void* partial, void* dw, int B, int T_len, int C, int K,
                                      int left, long long xsb, long long xst, long long gsb,
                                      long long gst, int rows_per_chunk, int specialised,
                                      void* stream) {
  return bwd_weight<false>(x, dout, mask, partial, dw, nullptr, B, T_len, C, K, left, xsb, xst,
                           gsb, gst, rows_per_chunk, specialised ? 4 : 0, stream);
}

// fp32 weight and bias gradients of the plain depthwise conv: x (B, T, C) the forward's
// input, dout (B, T, C) the output's gradient (any batch / time strides, unit channel
// stride), mask (B, T) bytes or NULL (the input's) -> dw (C, K), db (C,) contiguous.
// vec: 4 or 2, the vector kernel at that many channels a thread, for its (K, left): (15,
// 7), (15, 14), (3, 1) at 4, (31, 15) at 2 (C, x's and dout's batch / time strides
// multiples of vec, bases 4 vec-byte aligned, rows_per_chunk <= 16); 0, the generic one.
// partial: parts x (K + 1) x C floats of scratch, parts as for fsmn_memory_bwd_weight.
// Two kernel launches on `stream`.
extern "C" int fsmn_depthwise_bwd_weight(const void* x, const void* dout, const void* mask,
                                         void* partial, void* dw, void* db, int B, int T_len,
                                         int C, int K, int left, long long xsb, long long xst,
                                         long long gsb, long long gst, int rows_per_chunk,
                                         int vec, void* stream) {
  return bwd_weight<true>(x, dout, mask, partial, dw, db, B, T_len, C, K, left, xsb, xst, gsb,
                          gst, rows_per_chunk, vec, stream);
}
#endif
