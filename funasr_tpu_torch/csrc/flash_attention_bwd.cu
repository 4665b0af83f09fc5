// Flash attention backward for Hopper (sm_90a), fp32, plain C interface loaded with ctypes.
//
// The gradient of funasr_tpu_torch/ops/flash_attention.py::flash_attention (the forward
// kernel in flash_attention.cu, which replaces the TPU kernel
// funasr_tpu/ops/flash_attention.py::flash_attention). The JAX package has no backward
// kernel: its gradients come from XLA's autodiff of the einsum attention
// (funasr_tpu/models/sanm/attention.py:121-133). With S = Q K^T / sqrt(D), masked keys at
// -1e30 as in the forward:
//   P = exp(S - m) / l            (m, l: each row's max and sum, written by the forward)
//   Dr = rowsum(dO o O)
//   dV = P^T dO,  dS = P o (dO V^T - Dr),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// and dS = 0 at masked keys (masked_fill's gradient): a row of length 0 averages V over
// all Tk keys, so its dV share is dO / Tk and it sends nothing to Q or K. m and l stay
// apart: such a row's scores are all -1e30, m + log2(l) rounds back to -1e30 in fp32,
// and one log-sum-exp would give it P = 1 instead of 1 / Tk.
//
// What bounds it on the H100: operations. Per (b, h) it does 10 Tq L D flops (S, dO V^T,
// dV, dK and dQ once each; L = keys each row sees) against 11 T D fp32 values moved; at
// fp32 accuracy the fastest route is 3xTF32 on the tensor cores, three TF32 products a
// product (hopper.cuh). At the training batch's (5, 4, 190, 128) that is 0.0052 ms at
// 495 TFLOP/s. The first kernel (FFMA on the CUDA cores, 0.124-0.127 ms there, 1.38x
// behind scaled_dot_product_attention's backward) lost in three ways: the CUDA cores'
// 67 TFLOP/s; S formed three times and dO V^T twice (a dq kernel whose first pass
// recomputed each row's (m, l), its second pass, then a dk / dv kernel); and a grid of
// (B H, T / 64) = 60 blocks of 152-169 KB for 132 SMs. What this design does:
//   * every product on mma.sync m16n8k8 in 3xTF32;
//   * S and dO V^T once each: the forward's STATS instantiation writes (m, l), a small
//     kernel computes Dr once a row, and one block per 32 keys walks the query tiles,
//     forming S^T, P^T, dP^T and dS^T once, accumulating dK and dV in registers and
//     writing its share of dQ = dS K to a (key blocks, B H, Tq, D) scratch; a last small
//     kernel adds the shares in key-block order, times 1 / sqrt(D), into dq. Three
//     launches, no float atomics: two runs give bit-equal gradients;
//   * 32-key blocks: (B H, Tk / 32) = 120 blocks at (5, 4, 190), one an SM, of 8 warps
//     (180 KB of shared memory: K and V, a 2-stage cp.async ring of Q / dO tiles of 64
//     rows with their m, l and Dr, the dS^T tile). Warp w owns keys 16 (w & 1) + [0, 16)
//     and queries 16 (w >> 1) + [0, 16) of each tile: its S^T and dP^T accumulators are
//     the A fragments of P^T dO and dS^T Q as they stand (the query order of S^T's B
//     operand is permuted so that accumulator columns 2t, 2t + 1 are A columns t, t + 4,
//     as in the forward's P V), so P^T stays in registers; dS^T goes through shared
//     memory once for dQ^T = K^T dS^T (each warp 8 queries x 128 head-dim columns). The
//     four query quarters' dK / dV partials are added in a fixed order at the end;
//   * operands come from shared memory by ldmatrix (A from row-major K / V, B from the
//     [query][d] Q / dO tiles) or as 16-byte vectors (the B operands of P^T dO and dS^T Q,
//     16 head-dim columns a thread, and K^T); pitches of 132 floats (= 4 mod 32 banks) for
//     the K, V, Q, dO tiles and 72 (= 8 mod 32) for dS^T make each such read conflict-free;
//   * query tiles whose largest limit does not reach the key block are skipped (limits
//     never fall with the row, so a tile's largest is its last row's and the live tiles
//     are a suffix), as are key blocks' shares of dQ: the dQ kernel adds only the key
//     blocks each tile reached.
// Measured (NVIDIA H100 80GB HBM3, 700 W): 0.046-0.049 ms at (5, 4, 190, 128) in the
// three modes, 10 % of the bound, 1.9x faster than scaled_dot_product_attention's
// backward; by profile Dr ~0.0024, the key blocks 0.037-0.040, the dQ sum ~0.0044 ms.
// Splitting K and V once a block instead of at each use moved the key blocks by < 3 %:
// the splits do not bound it.
//
// Chunk mode (mode 3; flash_attention.cu's note at "Chunk mode"): P and dS are formed only
// at live scores, the predicate computed from the row and key indices, so a fully masked
// row (the forward's (m, l) = (-1e30, 0)) adds nothing to dK or dV and gets dq = 0. Key
// block [k0, k0 + 32) is seen only by the rows of chunks c' = k0 / shift ... c'' + lb
// (c'' its last key's chunk), so it walks only the query tiles of those rows; its keys at
// or past len_b are seen by none. The dQ sum adds, in key-block order, the shares of the
// key blocks whose walk covered the row's tile (the same range function), so a row no
// block reached gets 0. The CHUNK template flag keeps the other modes' kernel as it was.
//
// Shapes: q, o, dO, dq (B, H, Tq, D); k, v, dk, dv (B, H, Tk, D); Tq <= Tk; D <= 128,
// a multiple of 8; any strides with a unit last one and the others multiples of 4
// elements, bases 16-byte aligned (the wrapper checks). stats: 2 x B H Tq floats (m in
// log2 units, then l); scratch: flash_bwd_scratch_floats(B, H, Tq, Tk, D) floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mma_3xtf32;
using hopper::split4;
using hopper::split_tf32;

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DP = 128;             // head dim held in shared memory (zero above D)
constexpr int KB = 32;              // keys a block
constexpr int QT = 64;              // query rows a tile
constexpr int WARPS = 8;            // 2 key halves x 4 query quarters
constexpr int THREADS = 32 * WARPS;
constexpr int PITCH = DP + 4;       // K, V, Q, dO row pitch: 132 floats (= 4 mod 32 banks)
constexpr int DSP = QT + 8;         // dS^T row pitch: 72 floats (= 8 mod 32 banks)
constexpr int DR_ROWS = THREADS / 32;  // rows a block of the Dr kernel: a warp a row

struct Smem {  // 179,712 bytes
  float k[KB * PITCH];
  float v[KB * PITCH];
  float q[2][QT * PITCH];     // the ring's two stages; with dout, 98 KB of dK / dV
  float dout[2][QT * PITCH];  // partials at the end
  float m[2][QT], l[2][QT], dr[2][QT];
  float ds[KB * DSP];
};

struct Strides {  // (b, h, t) in elements
  long long sb, sh, st;
};

struct Args {
  const float *q, *k, *v, *o, *dout, *stats;
  float *dq, *dk, *dv, *dr, *dq_part;
  const int *lengths, *vad_pos;
  int BH, H, Tq, Tk, D, mode;
  int shift, sf, stride, lb;  // chunk mode (3)
  Strides q_s, k_s, v_s, o_s, do_s, dq_s, dk_s, dv_s;
  float sm_scale, scale_log2;
};

__device__ __forceinline__ int key_limit(int mode, int row, int len, int vp) {
  if (mode == 1) return min(row + 1, len);
  if (mode == 2 && row <= vp - 2) return min(vp, len);
  return len;
}

// the largest key limit of query tile qt (its last row's)
__device__ __forceinline__ int tile_limit(const Args& a, int qt, int len, int vp) {
  return key_limit(a.mode, min((qt + 1) * QT, a.Tq) - 1, len, vp);
}

// chunk mode: whether a row of chunk rc at in-chunk index rj sees a key of chunk kc at
// index kj (the key's length check aside)
__device__ __forceinline__ bool chunk_sees(const Args& a, int rc, int rj, int kc, int kj) {
  return rj >= 0 && kj >= 0 &&
         (kc == rc || (kc < rc && kc >= rc - a.lb && rj < a.stride && kj < a.stride));
}

// chunk mode: the query tiles [first, end) whose rows can see key block kb (none when
// its keys are all at or past len)
__device__ __forceinline__ void chunk_tiles(const Args& a, int kb, int len, int& first,
                                            int& end) {
  const int k0 = kb * KB, k1 = min(k0 + KB, len);
  if (k1 <= k0) {
    first = end = 0;
    return;
  }
  const int c0 = k0 / a.shift, c1 = (k1 - 1) / a.shift;
  first = (c0 * a.shift + a.sf) / QT;
  end = (min(a.Tq, (c1 + a.lb + 1) * a.shift) + QT - 1) / QT;
}

__device__ __forceinline__ void split4u(const uint32_t (&r)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}

// Dr = rowsum(dO o O), a warp a row (bh Tq + t), in a fixed order
__global__ void __launch_bounds__(THREADS) flash_bwd_dr_kernel(Args a) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * DR_ROWS + threadIdx.x / 32;
  if (row >= (long long)a.BH * a.Tq) return;
  const int bh = (int)(row / a.Tq), t = (int)(row % a.Tq), b = bh / a.H, h = bh % a.H;
  const int c = 4 * lane;
  float s = 0.f;
  if (c < a.D) {
    const float4 x = *reinterpret_cast<const float4*>(a.o + b * a.o_s.sb + h * a.o_s.sh +
                                                      (long long)t * a.o_s.st + c);
    const float4 y = *reinterpret_cast<const float4*>(a.dout + b * a.do_s.sb + h * a.do_s.sh +
                                                      (long long)t * a.do_s.st + c);
    s = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) a.dr[row] = s;
}

// One block of KB keys of one (b, h): dK, dV and its share of dQ. Grid (B H, Tk / KB).
template <bool CHUNK>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int kh = warp & 1, qh = warp >> 1;
  const int k0 = blockIdx.y * KB;
  const int len = min(max(a.lengths[b], 0), a.Tk);
  const int vp = a.mode == 2 ? a.vad_pos[b] : 0;
  // the live query tiles [first, end): a suffix outside chunk mode (a length-0 row sends
  // dO / Tk to every key), the rows of the chunks that see this block in it
  int first = 0, end = (a.Tq + QT - 1) / QT;
  if constexpr (CHUNK) {
    chunk_tiles(a, blockIdx.y, len, first, end);
  } else if (len > 0) {
    while (first < end && tile_limit(a, first, len, vp) <= k0) ++first;
  }
  const float* qg = a.q + b * a.q_s.sb + h * a.q_s.sh;
  const float* dog = a.dout + b * a.do_s.sb + h * a.do_s.sh;
  const long long n = (long long)a.BH * a.Tq, at = (long long)bh * a.Tq;

  // Q and dO rows [qt QT, + QT) with their m, l and Dr into stage st, zero past Tq and D
  auto load_tile = [&](int st, int qt) {
    const int r0 = qt * QT;
#pragma unroll
    for (int i_ = 0; i_ < QT * (DP / 4) / THREADS; ++i_) {
      const int i = tid + i_ * THREADS, r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const int row = r0 + r;
      const bool full = row < a.Tq && c < a.D;
      hopper::cp_async16(&sm.q[st][r * PITCH + c], full ? qg + (long long)row * a.q_s.st + c : qg,
                         full);
      hopper::cp_async16(&sm.dout[st][r * PITCH + c],
                         full ? dog + (long long)row * a.do_s.st + c : dog, full);
    }
    if (tid < QT) {
      const int row = r0 + tid;
      const bool ok = row < a.Tq;
      hopper::cp_async4(&sm.m[st][tid], a.stats + (ok ? at + row : 0), ok);
      hopper::cp_async4(&sm.l[st][tid], a.stats + (ok ? n + at + row : 0), ok);
      hopper::cp_async4(&sm.dr[st][tid], a.dr + (ok ? at + row : 0), ok);
    }
  };

  float dv[DP / 8][4], dk[DP / 8][4];  // keys 16 kh + g (+ 8), columns 32 tig + 16 e' + jn
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[jn][e] = dk[jn][e] = 0.f;

  if (first < end) {
    const float* kg = a.k + b * a.k_s.sb + h * a.k_s.sh;
    const float* vg = a.v + b * a.v_s.sb + h * a.v_s.sh;
#pragma unroll
    for (int i_ = 0; i_ < KB * (DP / 4) / THREADS; ++i_) {
      const int i = tid + i_ * THREADS, r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const int key = k0 + r;
      const bool full = key < a.Tk && c < a.D;
      hopper::cp_async16(&sm.k[r * PITCH + c], full ? kg + (long long)key * a.k_s.st + c : kg,
                         full);
      hopper::cp_async16(&sm.v[r * PITCH + c], full ? vg + (long long)key * a.v_s.st + c : vg,
                         full);
    }
    load_tile(0, first);
    hopper::cp_async_commit();
  }

  // ldmatrix row addresses: A (K / V rows of this warp's keys), B (Q / dO rows of its
  // queries, in the permuted order n -> n / 2 + 4 (n % 2))
  const int a_off = (16 * kh + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH + 4 * (lane >> 4);
  const int b_off =
      (16 * qh + 8 * (lane >> 4) + ((lane & 7) >> 1) + 4 * (lane & 1)) * PITCH + 4 * ((lane >> 3) & 1);

  // chunk mode: this thread's two keys' chunks and in-chunk indices
  int kc[2] = {0, 0}, kj[2] = {-1, -1};
  if constexpr (CHUNK) {
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const int key = k0 + 16 * kh + g + 8 * hk;
      kc[hk] = key / a.shift;
      kj[hk] = key < len ? key - kc[hk] * a.shift - a.sf : -1;  // -1: never live
    }
  }

  for (int qt = first; qt < end; ++qt) {
    const int st = (qt - first) & 1;
    hopper::cp_async_wait<0>();  // this thread's copies of tile qt have landed
    __syncthreads();             // everyone's have; everyone is done with tile qt - 1
    if (qt + 1 < end) load_tile(st ^ 1, qt + 1);
    hopper::cp_async_commit();
    const float* qs = sm.q[st];
    const float* dos = sm.dout[st];

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries a warp; n-tile j holds queries
    // 16 qh + 8 j + tig (columns 2 tig) and + 4 (columns 2 tig + 1)
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t r[4], ah[4], al[4], bh_[4], bl[4];
      hopper::ldmatrix_x4(r, &sm.k[a_off + 8 * kk]);
      split4u(r, ah, al);
      hopper::ldmatrix_x4(r, &qs[b_off + 8 * kk]);
      split4u(r, bh_, bl);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_3xtf32(s[j], ah, al, bh_[2 * j], bh_[2 * j + 1], bl[2 * j], bl[2 * j + 1]);
      hopper::ldmatrix_x4(r, &sm.v[a_off + 8 * kk]);
      split4u(r, ah, al);
      hopper::ldmatrix_x4(r, &dos[b_off + 8 * kk]);
      split4u(r, bh_, bl);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_3xtf32(dp[j], ah, al, bh_[2 * j], bh_[2 * j + 1], bl[2 * j], bl[2 * j + 1]);
    }

    // P^T and dS^T; element e = 2 hk + hq: key 16 kh + g + 8 hk, query 16 qh + 8 j + tig + 4 hq
    const int row0 = qt * QT;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int ql = 16 * qh + 8 * j + tig + 4 * hq, row = row0 + ql;
        const int lim = row < a.Tq ? key_limit(a.mode, row, len, vp) : -1;  // -1: no such row
        const float m = sm.m[st][ql], l = sm.l[st][ql], dr = sm.dr[st][ql];
        int rc = 0, rj = -1;  // chunk mode: the row's chunk and index (-1: never live)
        if constexpr (CHUNK) {
          rc = row / a.shift;
          rj = row < a.Tq ? row - rc * a.shift - a.sf : -1;
        }
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int e = 2 * hk + hq, kl = 16 * kh + g + 8 * hk, key = k0 + kl;
          float p = 0.f, d = 0.f;
          if constexpr (CHUNK) {
            if (chunk_sees(a, rc, rj, kc[hk], kj[hk])) {
              p = exp2f(s[j][e] * a.scale_log2 - m) / l;
              d = p * (dp[j][e] - dr);
            }
          } else if (lim >= 0 && key < a.Tk) {
            p = exp2f((key >= lim ? MASKED : s[j][e] * a.scale_log2) - m) / l;
            if (key < lim) d = p * (dp[j][e] - dr);
          }
          s[j][e] = p;
          dp[j][e] = d;
          sm.ds[kl * DSP + ql] = d;
        }
      }

    // dV += P^T dO and dK += dS^T Q over this warp's 16 queries: the A fragment of key
    // step j is accumulator j as it stands; the B column g of output tile 4 c4 + e is
    // head-dim column 16 g + 4 c4 + e, read as 16-byte vectors
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split4({s[j][0], s[j][2], s[j][1], s[j][3]}, ph, pl);
      split4({dp[j][0], dp[j][2], dp[j][1], dp[j][3]}, sh, sl);
      const int qa = 16 * qh + 8 * j + tig;
      const float* d0 = &dos[qa * PITCH + 16 * g];
      const float* q0 = &qs[qa * PITCH + 16 * g];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        uint32_t xh0[4], xl0[4], xh1[4], xl1[4];
        const float4 x0 = *reinterpret_cast<const float4*>(d0 + 4 * c4);
        const float4 x1 = *reinterpret_cast<const float4*>(d0 + 4 * PITCH + 4 * c4);
        split4({x0.x, x0.y, x0.z, x0.w}, xh0, xl0);
        split4({x1.x, x1.y, x1.z, x1.w}, xh1, xl1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mma_3xtf32(dv[4 * c4 + e], ph, pl, xh0[e], xh1[e], xl0[e], xl1[e]);
        const float4 y0 = *reinterpret_cast<const float4*>(q0 + 4 * c4);
        const float4 y1 = *reinterpret_cast<const float4*>(q0 + 4 * PITCH + 4 * c4);
        split4({y0.x, y0.y, y0.z, y0.w}, xh0, xl0);
        split4({y1.x, y1.y, y1.z, y1.w}, xh1, xl1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mma_3xtf32(dk[4 * c4 + e], sh, sl, xh0[e], xh1[e], xl0[e], xl1[e]);
      }
    }
    __syncthreads();  // dS^T is whole

    // this key block's share of dQ^T = K^T dS^T: warp w takes queries 8 w + [0, 8); m-tile
    // i row g / g + 8 is head-dim column 16 g + 2 i / + 1, so a thread reads its K values
    // as 16-byte vectors and holds 16 neighbouring columns of each of its 2 queries
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      const int qn = 8 * warp;
#pragma unroll
      for (int ks = 0; ks < KB / 8; ++ks) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(sm.ds[(8 * ks + tig) * DSP + qn + g], bh0, bl0);
        split_tf32(sm.ds[(8 * ks + tig + 4) * DSP + qn + g], bh1, bl1);
        const float* k0p = &sm.k[(8 * ks + tig) * PITCH + 16 * g];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 x0 = *reinterpret_cast<const float4*>(k0p + 4 * c);
          const float4 x1 = *reinterpret_cast<const float4*>(k0p + 4 * PITCH + 4 * c);
          uint32_t ah[4], al[4];
          split4({x0.x, x0.y, x1.x, x1.y}, ah, al);
          mma_3xtf32(acc[2 * c], ah, al, bh0, bh1, bl0, bl1);
          split4({x0.z, x0.w, x1.z, x1.w}, ah, al);
          mma_3xtf32(acc[2 * c + 1], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      float* part = a.dq_part + ((long long)blockIdx.y * a.BH + bh) * a.Tq * a.D;
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int row = row0 + qn + 2 * tig + e1;
        if (row >= a.Tq) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 16 * g + 4 * c;
          if (col >= a.D) continue;
          *reinterpret_cast<float4*>(part + (long long)row * a.D + col) = make_float4(
              acc[2 * c][e1], acc[2 * c][2 + e1], acc[2 * c + 1][e1], acc[2 * c + 1][2 + e1]);
        }
      }
    }
  }

  // dK, dV: the four query quarters' partials added in order (quarters 1-3 through the
  // ring's shared memory, 4,096 floats a warp)
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* red = sm.q[0];
  if (qh > 0) {
    float* dst = red + ((qh - 1) * 2 + kh) * 4096 + lane;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[(4 * jn + e) * 32] = dv[jn][e];
        dst[(64 + 4 * jn + e) * 32] = dk[jn][e];
      }
  }
  __syncthreads();
  if (qh > 0) return;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* src = red + (r * 2 + kh) * 4096 + lane;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[jn][e] += src[(4 * jn + e) * 32];
        dk[jn][e] += src[(64 + 4 * jn + e) * 32];
      }
  }
  float* dkg = a.dk + b * a.dk_s.sb + h * a.dk_s.sh;
  float* dvg = a.dv + b * a.dv_s.sb + h * a.dv_s.sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + 16 * kh + g + 8 * hr;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int c = 32 * tig + 16 * e + 4 * c4;
        if (c >= a.D) continue;
        const int x = 2 * hr + e;
        *reinterpret_cast<float4*>(dvg + (long long)key * a.dv_s.st + c) =
            make_float4(dv[4 * c4][x], dv[4 * c4 + 1][x], dv[4 * c4 + 2][x], dv[4 * c4 + 3][x]);
        *reinterpret_cast<float4*>(dkg + (long long)key * a.dk_s.st + c) = make_float4(
            dk[4 * c4][x] * a.sm_scale, dk[4 * c4 + 1][x] * a.sm_scale,
            dk[4 * c4 + 2][x] * a.sm_scale, dk[4 * c4 + 3][x] * a.sm_scale);
      }
  }
}

// dq = the key blocks' shares added in key-block order, times 1 / sqrt(D); a thread a
// 16-byte vector of a row. Only the key blocks that reached the row's tile wrote one.
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(Args a) {
  const int vecs = a.D / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.BH * a.Tq * vecs) return;
  const int c = (int)(i % vecs) * 4;
  const long long row = i / vecs;  // bh Tq + t
  const int bh = (int)(row / a.Tq), t = (int)(row % a.Tq), b = bh / a.H, h = bh % a.H;
  const int len = min(max(a.lengths[b], 0), a.Tk);
  const int vp = a.mode == 2 ? a.vad_pos[b] : 0;
  const int nkb = (a.Tk + KB - 1) / KB;
  const int live = a.mode == 3 ? nkb
                   : len > 0 ? min(nkb, (tile_limit(a, t / QT, len, vp) + KB - 1) / KB) : nkb;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kb = 0; kb < live; ++kb) {
    if (a.mode == 3) {  // only the key blocks whose walk covered this row's tile wrote
      int first, end;
      chunk_tiles(a, kb, len, first, end);
      if (t / QT < first || t / QT >= end) continue;
    }
    const float4 x =
        *reinterpret_cast<const float4*>(a.dq_part + ((long long)kb * a.BH * a.Tq + row) * a.D + c);
    sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
  }
  *reinterpret_cast<float4*>(a.dq + b * a.dq_s.sb + h * a.dq_s.sh + (long long)t * a.dq_s.st + c) =
      make_float4(sum.x * a.sm_scale, sum.y * a.sm_scale, sum.z * a.sm_scale, sum.w * a.sm_scale);
}

}  // namespace

// q, o, dout, dq: (B, H, Tq, D); k, v, dk, dv: (B, H, Tk, D); fp32. strides: (b, h, t) in
// elements for q, k, v, o, dout, dq, dk, dv (24 values). stats: the forward's 2 B H Tq
// floats (m in log2 units, l). scratch: B H Tq rounded up to a multiple of 4 (Dr), then
// ceil(Tk / 32) B H Tq D (the key blocks' shares of dQ) floats. mode: 0 none, 1 causal,
// 2 corner, which reads vad_pos (B int32; NULL otherwise), 3 chunk (Tq = Tk), which reads
// chunk (4 host ints: shift, s_fsmn, stride, look-back; NULL otherwise). Three kernel
// launches on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* stats, void* dq, void* dk,
                                   void* dv, void* scratch, const void* lengths, int B, int H,
                                   int Tq, int Tk, int D, const long long* strides,
                                   float sm_scale, int mode, const void* vad_pos,
                                   const int* chunk, void* stream) {
  if (D < 8 || D > DP || D % 8 || Tq < 1 || Tk < Tq || mode < 0 || mode > 3 ||
      (mode == 2 && vad_pos == nullptr) || B * H < 1 || stats == nullptr ||
      (mode == 3) != (chunk != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.shift = 1, a.sf = 0, a.stride = 1, a.lb = 0;
  if (mode == 3) {
    a.shift = chunk[0], a.sf = chunk[1], a.stride = chunk[2], a.lb = chunk[3];
    if (Tk != Tq || a.shift < 1 || a.sf < 0 || a.sf >= a.shift || a.stride < 1 || a.lb < 0)
      return (int)cudaErrorInvalidValue;
  }
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.stats = static_cast<const float*>(stats);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  const long long rows = (long long)B * H * Tq;
  a.dr = static_cast<float*>(scratch);
  a.dq_part = a.dr + (rows + 3) / 4 * 4;
  a.lengths = static_cast<const int*>(lengths);
  a.vad_pos = static_cast<const int*>(vad_pos);
  a.BH = B * H, a.H = H, a.Tq = Tq, a.Tk = Tk, a.D = D, a.mode = mode;
  Strides* dst[8] = {&a.q_s, &a.k_s, &a.v_s, &a.o_s, &a.do_s, &a.dq_s, &a.dk_s, &a.dv_s};
  for (int i = 0; i < 8; ++i) *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.scale_log2 = sm_scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = mode == 3 ? flash_bwd_kernel<true> : flash_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dr_kernel<<<(unsigned)((rows + DR_ROWS - 1) / DR_ROWS), THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * H, (Tk + KB - 1) / KB), THREADS, sizeof(Smem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long vecs = rows * (D / 4);
  flash_bwd_dq_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}
