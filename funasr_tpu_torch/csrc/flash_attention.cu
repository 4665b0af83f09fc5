// Flash attention forward for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces the TPU kernel funasr_tpu/ops/flash_attention.py::flash_attention
// (kernel _flash_kernel): softmax(Q K^T / sqrt(D)) V with an online softmax over key
// tiles, fp32 scores and fp32 accumulation, keys at or past lengths[b] scored -1e30,
// output acc / max(l, 1e-30) in q's dtype.
//
// Two kernels: bf16 (the dtype of the bf16 paths) on wgmma fed by TMA, and fp32, the
// dtype of the public default AutoModel (no bf16, no quant): 50 launches per decode,
// every encoder self-attention. fp32 runs on the tensor cores with the 3xTF32 split
// (three TF32 products per fp32 product, fp32 accuracy), not plain TF32, which moves
// results by ~1e-3 (its design note is below, at "fp32: 3xTF32").
//
// What bounds fp32 on the H100 (NVIDIA H100 80GB HBM3 at 700 W): at (32, 4, 384, 128)
// with the smoke's lengths 27.6 GFLOP of TF32 products (3 x 4 T L D), 0.056 ms at 495
// TFLOP/s, against 98 MB of bytes (0.029 ms): operations. On the CUDA cores (67 TFLOP/s)
// the same work is bound at 0.137 ms; the first port, on CUDA-core FMAs with O in shared
// memory and one block of 4 warps per SM, took 0.777 ms, 2.8x
// scaled_dot_product_attention's 0.276 ms. This design takes 0.191 ms (29 % of the
// 3xTF32 bound, 1.4x faster than that call), most likely held by mma.sync's TF32 rate.
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
// Shapes. Queries are (B, H, Tq, D), keys and values (B, H, Tk, D) with Tq <= Tk: the
// streaming encoder's chunk attends over [cached K/V | chunk] (Tq = 15 rows over Tk = 15
// to 55 keys at look-back 4, unbounded at look-back -1); offline Tq = Tk.
//
// Masking (both kernels). Row r of batch b sees the keys below its limit
//   mode 0 (none):   klim = len_b = lengths[b]
//   mode 1 (causal): klim = min(r + 1, len_b)
//   mode 2 (corner): klim = min(vp_b, len_b) for r <= vp_b - 2, else len_b
// (vp_b = vad_pos[b]; mode 2 is the streaming punctuation encoder's last layer,
// ~((rows <= vp - 2) & (cols >= vp)) & (cols < len), so vp <= 1 or vp >= Tk masks no
// more than the length does; mode 1 its other layers). Keys in [klim, Tk) score -1e30
// like the Pallas kernel; keys past Tk (the ragged last tile, which Pallas never has
// because it requires T % block == 0; TMA or cp.async fills it with zeros) score -inf
// and contribute exactly 0. A row with lengths[b] == 0 (so klim == 0) therefore gets the
// uniform average of V over all Tk keys, as the Pallas kernel gives; every other row's
// limit is >= 1, so key 0 is live in the first tile. klim does not decrease with r, so
// a block's largest limit is its last row's: key tiles wholly past it are neither
// loaded nor computed (their exp() is exactly 0). Query rows at or past lengths[b] are
// computed like any other row (callers ignore them); rows past Tq are not written.
//
// Inputs have any strides whose last one is 1 and the others multiples of 16 bytes;
// the wrapper (funasr_tpu_torch/ops/flash_attention.py) checks this, allocates the
// output, picks the bf16 block rows and passes the stream. D <= 128, a multiple of 8.

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

// the keys row r sees (the masking note above); mode 2 reads vp, the others ignore it
__device__ __forceinline__ int key_limit(int mode, int row, int len, int vp) {
  if (mode == 1) return min(row + 1, len);
  if (mode == 2 && row <= vp - 2) return min(vp, len);
  return len;
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
                  const int* __restrict__ lengths, const int* __restrict__ vad_pos, int H,
                  int Tq, int Tk, int mode, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  BfSmem<NC>& sm = *reinterpret_cast<BfSmem<NC>*>(hopper::align1024(smem_raw));
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * (NC * QR);
  const int len = min(max(lengths[b], 0), Tk);
  const int vp = mode == 2 ? vad_pos[b] : 0;
  const int block_lim = key_limit(mode, min(q0 + NC * QR, Tq) - 1, len, vp);
  const int ntiles = ((block_lim > 0 ? block_lim : Tk) + BKB - 1) / BKB;

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
    const int row_a = q0 + c * QR + warp * 16 + lane / 4;
    const int lim[2] = {key_limit(mode, row_a, len, vp), key_limit(mode, row_a + 8, len, vp)};

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
          sc[4 * j + e] = key >= Tk ? -INFINITY : (key >= lim[e / 2] ? MASKED : x);
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
    // expects), then one TMA store per 64-column block; rows past Tq are clipped
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
    if (tid == 0 && q0 + c * QR < Tq) {
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

cudaError_t launch_bf16(const void* const* ptrs, const int* lengths, const int* vad_pos, int B,
                        int H, int Tq, int Tk, int D, const long long* st, float sm_scale,
                        int mode, int block_rows, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, o as (D, T, H, B): T = Tk for k and v, else Tq
  for (int i = 0; i < 4; ++i) {
    const int t = i == 1 || i == 2 ? Tk : Tq;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)t, (cuuint64_t)H, (cuuint64_t)B};
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
  dim3 grid(B * H, (Tq + block_rows - 1) / block_rows);
  kernel<<<grid, 128 * (two ? 3 : 2), bytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                      lengths, vad_pos, H, Tq, Tk, mode,
                                                      sm_scale * LOG2E);
  return cudaGetLastError();
}

// ---- fp32: 3xTF32 on mma.sync --------------------------------------------------------
//
// Each product is three TF32 products on the tensor cores (hopper.cuh: split_tf32,
// mma_tf32; the backward kernel in flash_attention_bwd.cu shares them), fp32 accuracy.
//
// Block: 4 warps, 16 query rows each (64 rows). Q sits in shared memory; K and V tiles
// of 32 keys come through a 2-stage cp.async ring (all threads copy, one barrier per
// tile), so the next tile's loads overlap this one's products; 104 KB of shared memory
// and at most 255 registers a thread let two blocks share an SM. Per warp the
// accumulator O (16 rows x 128 columns) stays in registers; S = Q K^T and O += P V run
// on mma.sync with the fragments read from shared memory, P taken straight from S's
// accumulators; each term's products are issued across 4 (S) or 4 (P V) independent
// accumulators, so none waits on the one before it.
//
// Why mma.sync and not wgmma: tf32 wgmma needs both operands K-major, and V's tile
// (keys x head dim, D contiguous) is N-major for P V, so V would have to be transposed
// through shared memory on every tile; mma.sync reads V's fragments from the padded
// row-major tile as it is.
//
// Index maps (reductions are order-free, so logical and actual indices may differ):
//   * S: mma step 2s / 2s+1 of head-dim chunk s covers columns 16s + 4 tig + {0,1} /
//     {2,3}, so one 16-byte load gives a thread's K values of both steps; the B column g
//     of key tile j is key 8j + (g >> 1) + 4 (g & 1), so accumulator c0 / c1 hold keys
//     8j + tig / 8j + tig + 4;
//   * P V: P's A fragment of key step j is S's accumulator of key tile j as it is, and
//     the B column g of output tile jn is head-dim column 16 g + jn, so a thread reads
//     its V values as 16-byte vectors and holds output columns 32 tig + [0, 32).
// Row pitches of 132 floats for K and V (= 4 mod 32 banks) and 144 for Q (= 16 mod 32)
// make every such 16-byte read conflict-free.
//
// Training: FlashAttentionFn launches the STATS instantiation, which also writes each
// row's max m (log2 units) and sum l, the two numbers the backward kernel needs to form
// P without recomputing S twice; every inference path launches the other, which is the
// kernel as it was before the flag.

using hopper::mma_tf32;
using hopper::split4;

constexpr int FQ = 64;           // query rows per block (4 warps x 16)
constexpr int FK = 32;           // keys per tile
constexpr int FSTAGES = 2;       // cp.async ring depth
constexpr int FPITCH = DP + 4;   // K / V row pitch in floats (= 4 mod 32 banks)
constexpr int QPITCH = DP + 16;  // Q row pitch in floats (= 16 mod 32 banks)
constexpr int FTHREADS = 128;

struct F32Smem {  // 104,448 bytes: two blocks per SM
  float q[FQ * QPITCH];
  float k[FSTAGES][FK * FPITCH];
  float v[FSTAGES][FK * FPITCH];
};

template <bool STATS>
__global__ void __launch_bounds__(FTHREADS, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ lengths, const int* __restrict__ vad_pos, int H,
                 int Tq, int Tk, int D, int mode,
                 long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst,
                 long long osb, long long osh, long long ost, float scale_log2,
                 float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(smem_raw);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int len = min(max(lengths[b], 0), Tk);
  const int vp = mode == 2 ? vad_pos[b] : 0;
  const int block_lim = key_limit(mode, min((int)blockIdx.y * FQ + FQ, Tq) - 1, len, vp);
  const int ntiles = ((block_lim > 0 ? block_lim : Tk) + FK - 1) / FK;

  const float* kg = k + b * ksb + h * ksh;
  const float* vg = v + b * vsb + h * vsh;

  // K and V rows [kt * FK, + FK) into stage st, zero past Tk and D
  auto load_kv = [&](int st, int kt) {
#pragma unroll
    for (int n = 0; n < FK * (DP / 4) / FTHREADS; ++n) {
      const int i = tid + n * FTHREADS, r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const int key = kt * FK + r;
      const bool full = key < Tk && c < D;
      const long long row = full ? key : 0;
      hopper::cp_async16(&sm.k[st][r * FPITCH + c], kg + (full ? row * kst + c : 0), full);
      hopper::cp_async16(&sm.v[st][r * FPITCH + c], vg + (full ? row * vst + c : 0), full);
    }
  };
  {  // the block's Q rows, zero past Tq and D, with the first K / V tile
    const float* qg = q + b * qsb + h * qsh;
#pragma unroll
    for (int n = 0; n < FQ * (DP / 4) / FTHREADS; ++n) {
      const int i = tid + n * FTHREADS, r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const int row = blockIdx.y * FQ + r;
      const bool full = row < Tq && c < D;
      hopper::cp_async16(&sm.q[r * QPITCH + c], qg + (full ? (long long)row * qst + c : 0), full);
    }
  }
#pragma unroll
  for (int st = 0; st < FSTAGES - 1; ++st) {
    if (st < ntiles) load_kv(st, st);
    hopper::cp_async_commit();
  }
  const int r0 = blockIdx.y * FQ + warp * 16;  // this warp's rows r0 + g, r0 + g + 8
  const int lim[2] = {key_limit(mode, r0 + g, len, vp), key_limit(mode, r0 + g + 8, len, vp)};
  const float* qs = &sm.q[(warp * 16 + g) * QPITCH + 4 * tig];

  float acc[DP / 8][4];  // O: output tile jn, rows g / g + 8
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
  float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f};

  for (int kt = 0; kt < ntiles; ++kt) {
    hopper::cp_async_wait<FSTAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();               // everyone's have; everyone is done with tile kt - 1
    if (kt + FSTAGES - 1 < ntiles) load_kv((kt + FSTAGES - 1) % FSTAGES, kt + FSTAGES - 1);
    hopper::cp_async_commit();
    const float* ks = sm.k[kt % FSTAGES];
    const float* vs = sm.v[kt % FSTAGES];

    // S = Q K^T over 16 head-dim columns (two mma steps) at a time
    float sc[FK / 8][4];
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const int krow = (g >> 1) + 4 * (g & 1);
#pragma unroll
    for (int s = 0; s < DP / 16; ++s) {
      const float4 q0 = *reinterpret_cast<const float4*>(qs + 16 * s);
      const float4 q1 = *reinterpret_cast<const float4*>(qs + 8 * QPITCH + 16 * s);
      uint32_t ah[2][4], al[2][4];
      split4({q0.x, q1.x, q0.y, q1.y}, ah[0], al[0]);
      split4({q0.z, q1.z, q0.w, q1.w}, ah[1], al[1]);
      uint32_t bh[FK / 8][4], bl[FK / 8][4];
#pragma unroll
      for (int j = 0; j < FK / 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[(8 * j + krow) * FPITCH + 16 * s + 4 * tig]);
        split4({kv.x, kv.y, kv.z, kv.w}, bh[j], bl[j]);
      }
      // term by term across the key tiles, so no product waits on the one before it
#pragma unroll
      for (int st = 0; st < 2; ++st) {
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) mma_tf32(sc[j], al[st], bh[j][2 * st], bh[j][2 * st + 1]);
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) mma_tf32(sc[j], ah[st], bl[j][2 * st], bl[j][2 * st + 1]);
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) mma_tf32(sc[j], ah[st], bh[j][2 * st], bh[j][2 * st + 1]);
      }
    }

    // mask, scale to log2 units, online softmax (rows g and g + 8, a quad per row)
    const int k0 = kt * FK;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + tig + 4 * (e & 1);
        const float x = sc[j][e] * scale_log2;
        sc[j][e] = key >= Tk ? -INFINITY : (key >= lim[e / 2] ? MASKED : x);
        mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
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
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e / 2]);
        sc[j][e] = p;
        l_r[e / 2] += p;
      }
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] *= alpha[e / 2];

    // O += P V, one key step of 8 keys per key tile j of S
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
      uint32_t ph[4], pl[4];
      split4({sc[j][0], sc[j][2], sc[j][1], sc[j][3]}, ph, pl);
      const float* v0 = &vs[(8 * j + tig) * FPITCH + 16 * g];
      const float* v1 = v0 + 4 * FPITCH;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const float4 x0 = *reinterpret_cast<const float4*>(v0 + 4 * c4);
        const float4 x1 = *reinterpret_cast<const float4*>(v1 + 4 * c4);
        uint32_t vh0[4], vl0[4], vh1[4], vl1[4];  // keys 8j + tig / + 4, tiles 4 c4 + e
        split4({x0.x, x0.y, x0.z, x0.w}, vh0, vl0);
        split4({x1.x, x1.y, x1.z, x1.w}, vh1, vl1);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_tf32(acc[4 * c4 + e], pl, vh0[e], vh1[e]);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_tf32(acc[4 * c4 + e], ph, vl0[e], vl1[e]);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_tf32(acc[4 * c4 + e], ph, vh0[e], vh1[e]);
      }
    }
  }
  hopper::cp_async_wait<0>();

  // out = O / max(l, 1e-30): row g + 8 hr, columns 32 tig + 16 e + jn
  float* og = o + b * osb + h * osh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    const float inv = 1.f / fmaxf(quad_sum(l_r[hr]), 1e-30f);
    if (row >= Tq) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int c = 32 * tig + 16 * e + 4 * c4;
        if (c >= D) continue;
        const float4 val = make_float4(
            acc[4 * c4 + 0][2 * hr + e] * inv, acc[4 * c4 + 1][2 * hr + e] * inv,
            acc[4 * c4 + 2][2 * hr + e] * inv, acc[4 * c4 + 3][2 * hr + e] * inv);
        *reinterpret_cast<float4*>(og + row * ost + c) = val;
      }
  }
  if constexpr (STATS) {  // (m, l) of rows r0 + g, + 8: m at [bh Tq + row], l B H Tq later
    const long long n = (long long)gridDim.x * Tq, at = (long long)blockIdx.x * Tq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + g + 8 * hr;
      const float l_sum = quad_sum(l_r[hr]);
      if (tig == 0 && row < Tq) {
        stats[at + row] = m_r[hr];
        stats[n + at + row] = l_sum;
      }
    }
  }
}

cudaError_t launch_f32(const void* const* ptrs, const int* lengths, const int* vad_pos, int B,
                       int H, int Tq, int Tk, int D, const long long* st, float sm_scale,
                       int mode, float* stats, cudaStream_t stream) {
  const size_t bytes = sizeof(F32Smem);  // above the 48 KB default: opt in per device
  auto kernel = stats ? flash_f32_kernel<true> : flash_f32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)  // the whole carveout as shared memory: two blocks per SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + FQ - 1) / FQ);
  kernel<<<grid, FTHREADS, bytes, stream>>>(
      static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), static_cast<float*>(const_cast<void*>(ptrs[3])),
      lengths, vad_pos, H, Tq, Tk, D, mode, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], sm_scale * LOG2E, stats);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and o are (B, H, Tq, D), k and v (B, H, Tk, D);
// strides: (b, h, t) for q, k, v, o in elements. mode: 0 none, 1 causal, 2 corner, which
// reads vad_pos (B int32; NULL otherwise). block_rows: query rows per bf16 block, 64 or
// 128 (the fp32 kernel always takes 64). stats: NULL, or (fp32 only) 2 B H Tq floats that
// receive each row's max m (log2 units) and sum l, the backward kernel's input.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* lengths, int B, int H, int Tq, int Tk,
                                   int D, const long long* strides, float sm_scale, int mode,
                                   const void* vad_pos, int block_rows, void* stats,
                                   void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  const int* lens = static_cast<const int*>(lengths);
  const int* vps = static_cast<const int*>(vad_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > DP || D % 8 || Tq < 1 || Tk < Tq || mode < 0 || mode > 2 ||
      (mode == 2 && vps == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_f32(ptrs, lens, vps, B, H, Tq, Tk, D, strides, sm_scale, mode,
                           static_cast<float*>(stats), s);
  if (dtype == 1 && stats == nullptr && (block_rows == QR || block_rows == 2 * QR))
    return (int)launch_bf16(ptrs, lens, vps, B, H, Tq, Tk, D, strides, sm_scale, mode,
                            block_rows, s);
  return (int)cudaErrorInvalidValue;
}
