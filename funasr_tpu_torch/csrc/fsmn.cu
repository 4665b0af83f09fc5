// FSMN memory block for Hopper (sm_90a), plain C interface loaded with ctypes.
//
//   out[b, t, c] = m[b, t] * ( round(sum_i w[c, i] * xm[b, t + i - left, c]) + xm[b, t, c] )
//   xm = m * x, zero outside [0, T);  m = mask (all ones when no mask is given)
//
// Replaces the TPU kernel benchmarks/bench_pallas_dwconv.py::dw_pallas (the FSMN
// depthwise conv1d) fused with the mask / residual / mask passes around it in
// funasr_tpu/models/sanm/attention.py::_fsmn and ::fsmn_decoder_apply, which are the
// same function. The taps accumulate in fp32; round() is a rounding to x's dtype, and
// the residual sum is rounded again, in the order of the JAX functions
// (depthwise_conv1d_apply casts its fp32 sum to x's dtype before "+ v").
//
// Design. Pure bandwidth: one read of x and one write of out (k = 11 taps are 22
// flops per element). A block of 128 threads owns 128 channels x 32 time steps of one
// row b. Each thread stages its own channel's column of masked inputs (32 + k - 1
// values) and its k weights in shared memory, so neighbouring threads read and write
// neighbouring channels (coalesced) and no block-wide barrier is needed; the k-fold
// reuse of each input hits shared memory instead of device memory. The mask is read
// as bytes (torch.bool), so any mask is exact, not only prefix masks.
//
// x is (B, T, C) with unit channel stride and any batch / time strides (it is a
// slice of the fused q|k|v projection in the encoder); w is (C, k) contiguous
// (torch's depthwise Conv1d weight (C, 1, k)) in x's dtype; out is (B, T, C)
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 128;  // channels per block (= threads)
constexpr int TT = 32;   // time steps per block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(CT)
fsmn_kernel(const T* __restrict__ x, const T* __restrict__ w, const uint8_t* __restrict__ mask,
            T* __restrict__ out, int T_len, int C, int K, int left, long long xsb, long long xst) {
  extern __shared__ float smem[];
  float* col = smem;             // (TT + K - 1) x CT masked inputs
  float* wk = smem + (TT + K - 1) * CT;  // K x CT weights
  const int tx = threadIdx.x;
  const int c = blockIdx.x * CT + tx;
  const int t0 = blockIdx.y * TT;
  const int b = blockIdx.z;
  const uint8_t* mrow = mask ? mask + (long long)b * T_len : nullptr;
  const T* xb = x + b * xsb;

  for (int i = 0; i < K; ++i) wk[i * CT + tx] = c < C ? to_f(w[(long long)c * K + i]) : 0.f;
  for (int r = 0; r < TT + K - 1; ++r) {
    const int t = t0 - left + r;
    float val = 0.f;
    if (c < C && t >= 0 && t < T_len && (!mrow || mrow[t]))
      val = to_f(xb[(long long)t * xst + c]);
    col[r * CT + tx] = val;
  }
  if (c >= C) return;

  for (int tt = 0; tt < TT; ++tt) {
    const int t = t0 + tt;
    if (t >= T_len) break;
    float acc = 0.f;
    for (int i = 0; i < K; ++i) acc += col[(tt + i) * CT + tx] * wk[i * CT + tx];
    const float mem = to_f(from_f<T>(acc)) + col[(tt + left) * CT + tx];
    const bool valid = !mrow || mrow[t];
    out[((long long)b * T_len + t) * C + c] = from_f<T>(valid ? mem : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* mask, void* out, int B, int T_len,
                   int C, int K, int left, long long xsb, long long xst, cudaStream_t stream) {
  const size_t bytes = (size_t)(TT + 2 * K - 1) * CT * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fsmn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((C + CT - 1) / CT, (T_len + TT - 1) / TT, B);
  fsmn_kernel<T><<<grid, CT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), T_len, C, K, left, xsb, xst);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, w and out): 0 = float32, 1 = bfloat16. mask: (B, T) bytes or NULL.
// xsb, xst: batch and time strides of x in elements.
extern "C" int fsmn_memory_fwd(int dtype, const void* x, const void* w, const void* mask,
                               void* out, int B, int T_len, int C, int K, int left,
                               long long xsb, long long xst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, mask, out, B, T_len, C, K, left, xsb, xst, s);
  if (dtype == 1) return (int)launch<bf16>(x, w, mask, out, B, T_len, C, K, left, xsb, xst, s);
  return (int)cudaErrorInvalidValue;
}
