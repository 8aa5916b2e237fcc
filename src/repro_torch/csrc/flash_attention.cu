// Causal flash attention, forward only, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:33, called at :106): the
// serving-prefill attention of the LM path. It computes the same function,
// not the TPU's block schedule:
//
//   q (BH, Sq, D), k/v (BHkv, Skv, D), float32 or bfloat16, batch*heads
//   folded; q head h reads kv head h / (BH / BHkv) (GQA, MQA, MHA).
//   s[i, j] = (q_i . k_j) * scale in float32, set to -1e30 (not -inf)
//   where kv_pos[j] > q_pos[i]; an online softmax over kv tiles starting
//   at m = -1e30, l = 0 with a float32 accumulator; out = acc / max(l,
//   1e-30), rounded to the input type. A kv tile whose first position is
//   past the q tile's last position is skipped (the reference's
//   `k_pos[0] <= q_pos[-1]` predicate), so a q tile whose every kv tile is
//   skipped writes 0, and a row whose first processed tile is all masked
//   takes uniform weights there, as the reference does.
//
// Two kernels, picked by the C entry on type and head dim (the wrapper's
// `_variant` states the same rule):
//
// * `flash_wgmma_kernel`: bfloat16 with D a multiple of 16, D <= 256 --
//   the serving path (deepseek-7b, D 128). Products on the bf16 tensor
//   cores with `wgmma`, tiles brought in by TMA. One block owns a
//   (bh, 128-row q tile): two consumer warpgroups of 64 q rows each and a
//   producer warpgroup, one thread of which issues every TMA load (its
//   registers go to the consumers through `setmaxnreg`). The producer
//   loads the q tile once and keeps a ring of 64-row K/V tiles in flight
//   (2-4 stages, by D), each stage guarded by a "full" and an "empty"
//   mbarrier. A consumer computes S = Q Kᵀ as m64n64k16 wgmmas out of
//   shared memory (float32 accumulator), masks and scales S, runs the
//   online softmax in registers with the reference's arithmetic, and adds
//   P V with P from registers. P is kept at float32 precision: p_hi =
//   bf16(p) and p_lo = bf16(p - p_hi) each multiply the same V tile, so P
//   carries ~16 significant bits (|p - p_hi - p_lo| <= 2^-16 p) and every
//   product is exact in float32; l sums the float32 p. That is 1.5x the
//   function's flops on the tensor cores. A consumer skips the compute of
//   a tile past its own 64 rows' last position, so the skip rule is the
//   one the 64-row tiles of the first kernel apply. TMA reads the tensors
//   as 3-D (D, S, heads) maps, so a tile's rows past S are zeros (K = V =
//   0, position masked), never the next head's rows; repeated kv heads
//   are never formed. Tiles are stored interleaved (8 x 16-byte core
//   matrices, one TMA box per 8-column chunk), which any D that is a
//   multiple of 16 fills; V is read by `wgmma` as an MN-major operand.
//   The kernel is instantiated per head dim, so every product width and
//   tile loop is known to the compiler: with D a run-time value, ptxas
//   serialised the wgmmas (its warning C7511) and the kernel ran at about
//   half the speed.
// * `flash_fwd_kernel`: float32, and bfloat16 at any other D. One block
//   per (bh, 64-row q tile), 256 threads, thread (ty, tx) owning q rows
//   ty + 16 i and score columns tx + 16 j; Q, K, V and the probabilities
//   staged in shared memory as float32, the products float32 FMAs on the
//   CUDA cores; row max and sum reduced over 16 lanes with shuffles.
//   Ragged Skv rows are masked with K = V = 0, ragged Sq rows never
//   written. float32's contract (rtol 1e-3, atol 2e-5) leaves no room for
//   bf16 operands, so it stays on the CUDA cores.
//
// Bound on the card. Attention does 4 D flops per (q, k) pair the causal
// mask keeps and moves q, out and the live kv rows once: at B = 4,
// S = 2048, H = 32, D = 128 in bf16 it is bound by operations on the
// tensor cores (989 TFLOP/s dense), 0.139 ms. The wgmma kernel does 6 D
// flops per pair, on 64 x 64 tiles (the diagonal tiles whole); each
// warpgroup waits for its own products before its softmax, and the two
// warpgroups of a block overlap each other. (Issuing S of one tile with
// P V of the tile before, with or without the two warpgroups taking
// turns at the tensor cores, ran slower on the H100.)

#include <algorithm>
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int ROWS = BQ / 16;   // q rows per thread (4)
constexpr int COLS = BKV / 16;  // score columns per thread (4)
constexpr float NEG_INF = -1e30f;
constexpr int KV_PAD_POS = 1 << 30;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Reduce over the 16 lanes that share a q row (lanes tx = 0..15 of one ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
         (size_t)BQ * (BKV + 1) + BKV;  // + kv positions (int, same size)
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out, int group,
                 int Sq, int Skv, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;               // BQ x ld
  float* sK = sQ + BQ * ld;       // BKV x ld
  float* sV = sK + BKV * ld;      // BKV x D
  float* sP = sV + BKV * D;       // BQ x (BKV + 1)
  int* sKpos = reinterpret_cast<int*>(sP + BQ * (BKV + 1));  // BKV

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Sq - q0);
  const T* qb = q + ((size_t)bh * Sq + q0) * D;
  const size_t kv_off = (size_t)(bh / group) * Skv * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    sQ[r * ld + d] = r < nq ? to_f32(qb[(size_t)r * D + d]) : 0.f;
  }
  int my_pos[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) my_pos[i] = qpos[q0 + min(ty + 16 * i, nq - 1)];
  const int last_pos = qpos[q0 + nq - 1];

  float m[ROWS], l[ROWS], acc[ROWS][DMAX / 16];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DMAX / 16; ++jj) acc[i][jj] = 0.f;
  }

  const int n_kv = (Skv + BKV - 1) / BKV;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    if (kpos[k0] > last_pos) continue;  // the same for every thread
    const int nk = min(BKV, Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const bool live = c < nk;
      sK[c * ld + d] = live ? to_f32(kb[(size_t)(k0 + c) * D + d]) : 0.f;
      sV[c * D + d] = live ? to_f32(vb[(size_t)(k0 + c) * D + d]) : 0.f;
    }
    if (tid < BKV) sKpos[tid] = tid < nk ? kpos[k0 + tid] : KV_PAD_POS;
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = sKpos[c] <= my_pos[i] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BKV; ++c) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DMAX / 16; ++jj) {
        const int d = tx + 16 * jj;
        if (d < D) {
          const float vv = sV[c * D + d];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
  }

  T* ob = out + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DMAX / 16; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) ob[(size_t)r * D + d] = from_f32<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qpos,
                   const void* kpos, void* out, int BH, int BHkv, int Sq, int Skv,
                   int D, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(smem_floats(DMAX) * sizeof(float)));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos), static_cast<T*>(out),
      BH / BHkv, Sq, Skv, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* qpos,
                     const void* kpos, void* out, int BH, int BHkv, int Sq, int Skv,
                     int D, float scale, cudaStream_t stream) {
  if (D <= 32) return launch<T, 32>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, stream);
  return launch<T, 256>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, stream);
}

// ------------------------------------------------- wgmma kernel (bf16) --

using hopper::LAYOUT_INTERLEAVE;
using hopper::make_desc;

constexpr int WQ = 128;             // q rows per block: two warpgroups of 64
constexpr int WKV = 64;             // kv rows per tile
constexpr int W_THREADS = 384;      // two consumer warpgroups + a producer warpgroup
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (227 KB)

// Interleaved tiles: the 8-column chunk c of a tile of R rows starts at
// c * R * 16 bytes, row r of it at r * 16.
int wgmma_stages(int D) {
  const int free = SMEM_LIMIT - 1024 - 128 - WQ * D * 2;
  return std::min(MAX_STAGES, free / (2 * WKV * D * 2));
}
int wgmma_smem(int D, int stages) { return 1024 + WQ * D * 2 + stages * 2 * WKV * D * 2 + 128; }

// The consumer warpgroups' part of flash_wgmma_kernel: warpgroup wg owns
// q rows q0 + 64 wg ..; each thread rows r0 and r0 + 8 of them (h = 0, 1)
// and columns 8 j + 2 t4 + e of every 64-column product.
template <int D>
__device__ __forceinline__ void consume(uint32_t sQ, uint32_t sKV, uint32_t q_bar,
                                        const int* __restrict__ qpos,
                                        const int* __restrict__ kpos,
                                        __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                                        float scale, int stages, int q0, int bh,
                                        int block_last) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_bytes = WKV * D * 2;
  const int n_kv = (Skv + WKV - 1) / WKV;
  const int wg = warp >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int q_lo = q0 + 64 * wg;
  const int nrows = max(0, min(64, Sq - q_lo));
  const int wg_last = nrows > 0 ? qpos[q_lo + nrows - 1] : INT_MIN;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = nrows > 0 ? qpos[q_lo + min(r0 + 8 * h, nrows - 1)] : 0;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 2];  // 16-column chunk c: o[8 c + 4 j + 2 h + e]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  hopper::mbar_wait(q_bar, 0);
  const uint32_t sQw = sQ + wg * 64 * 16;
  int it = 0;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * WKV;
    const int first = kpos[k0];
    if (first > block_last) continue;
    const int s = it % stages;
    hopper::mbar_wait(q_bar + 8 * (1 + s), (it / stages) & 1);
    if (first <= wg_last) {
      const uint32_t sK = sKV + 2 * s * tile_bytes, sV = sK + tile_bytes;
      // S = Q Kᵀ: Q and K both K-major
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64_ss(
            sc, make_desc(sQw + kk * 2 * (WQ * 16), WQ * 16, 128, LAYOUT_INTERLEAVE),
            make_desc(sK + kk * 2 * (WKV * 16), WKV * 16, 128, LAYOUT_INTERLEAVE), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // mask, scale and the online softmax, as the first kernel does it
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * t4 + e;
          const int kp = c < Skv ? kpos[c] : KV_PAD_POS;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = sc[4 * j + 2 * h + e];
            v = kp <= pos[h] ? v * scale : NEG_INF;
            mx[h] = fmaxf(mx[h], v);
          }
        }
      float m_new[2], sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m[h], mx[h]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = expf(sc[i] - m_new[h]);
        sum[h] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        corr[h] = expf(m[h] - m_new[h]);
        l[h] = l[h] * corr[h] + sum[h];
        m[h] = m_new[h];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P as two bf16 A fragments per k16 step: p_hi = bf16(p), p_lo =
      // bf16(p - p_hi); fragment register r of step kk holds sc[8 kk + 2 r],
      // sc[8 kk + 2 r + 1]
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(a - hf.x, b - hf.y);
          phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
        }

      // O += P V: V MN-major (d contiguous); 64-column products, then
      // 16-column ones for the rest of D
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t sVk = sV + kk * 256;  // kv rows 16 kk ..
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          if (64 * (c + 1) <= D) {
            const uint64_t db = make_desc(sVk + c * 8 * (WKV * 16), 128, WKV * 16, LAYOUT_INTERLEAVE);
            float(&oc)[32] = *reinterpret_cast<float(*)[32]>(o + 32 * c);
            hopper::wgmma_m64n64_rs_tb(oc, phi[kk], db, 1);
            hopper::wgmma_m64n64_rs_tb(oc, plo[kk], db, 1);
          }
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
          if (c >= (D / 64) * 4 && 16 * c < D) {
            const uint64_t db = make_desc(sVk + c * 2 * (WKV * 16), 128, WKV * 16, LAYOUT_INTERLEAVE);
            float(&oc)[8] = *reinterpret_cast<float(*)[8]>(o + 8 * c);
            hopper::wgmma_m64n16_rs_tb(oc, phi[kk], db, 1);
            hopper::wgmma_m64n16_rs_tb(oc, plo[kk], db, 1);
          }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_regs(phi[kk]);
        hopper::fence_regs(plo[kk]);
      }
    }
    hopper::mbar_arrive(q_bar + 8 * (1 + stages + s));
    ++it;
  }

  __nv_bfloat16* ob = out + ((size_t)bh * Sq + q_lo) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nrows) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      if (16 * c < D)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 8 * c + 4 * j + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * D + 16 * c + 8 * j + 2 * t4) =
              __floats2bfloat162_rn(o[i] / denom, o[i + 1] / denom);
        }
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const int* __restrict__ qpos,
                   const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out, int group,
                   int Sq, int Skv, float scale, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const int tile_bytes = WKV * D * 2;
  const uint32_t sKV = sQ + WQ * D * 2;  // stage s: K at sKV + 2 s tile_bytes, V after it
  const uint32_t q_bar = sKV + 2 * stages * tile_bytes;
  // full[s] at q_bar + 8 (1 + s): the stage's K and V have landed;
  // empty[s] at q_bar + 8 (1 + stages + s): all 256 consumers are done with it
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WQ;  // the longest q rows start first
  const int n_kv = (Skv + WKV - 1) / WKV;
  const int block_last = qpos[min(q0 + WQ, Sq) - 1];

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(q_bar + 8 * (1 + s), 1);
      hopper::mbar_init(q_bar + 8 * (1 + stages + s), 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one thread issues every TMA load
    // registers go to the consumers (128 x 40 + 256 x 232 <= 65,536)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const int bhkv = bh / group;
      hopper::mbar_arrive_expect_tx(q_bar, WQ * D * 2);
      for (int c = 0; c < D / 8; ++c)
        hopper::tma_load_3d(sQ + c * (WQ * 16), &tq, 8 * c, q0, bh, q_bar);
      int it = 0;
      for (int t = 0; t < n_kv; ++t) {
        const int k0 = t * WKV;
        if (kpos[k0] > block_last) continue;
        const int s = it % stages;
        const uint32_t full = q_bar + 8 * (1 + s);
        hopper::mbar_wait(q_bar + 8 * (1 + stages + s), ((it / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full, 2 * tile_bytes);
        const uint32_t sK = sKV + 2 * s * tile_bytes;
        for (int c = 0; c < D / 8; ++c) {
          hopper::tma_load_3d(sK + c * (WKV * 16), &tk, 8 * c, k0, bhkv, full);
          hopper::tma_load_3d(sK + tile_bytes + c * (WKV * 16), &tv, 8 * c, k0, bhkv, full);
        }
        ++it;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<D>(sQ, sKV, q_bar, qpos, kpos, out, Sq, Skv, scale, stages, q0, bh, block_last);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* qpos,
                         const void* kpos, void* out, int BH, int BHkv, int Sq, int Skv,
                         float scale, cudaStream_t stream) {
  // TMA reads from 16-byte aligned addresses; rows of D bf16 (D % 16 == 0)
  // are whole multiples of 16 bytes
  if (!hopper::aligned16(q) || !hopper::aligned16(k) || !hopper::aligned16(v))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[3] = {(cuuint64_t)D, (cuuint64_t)Sq, (cuuint64_t)BH};
  const cuuint64_t kdims[3] = {(cuuint64_t)D, (cuuint64_t)Skv, (cuuint64_t)BHkv};
  const cuuint64_t qstr[2] = {(cuuint64_t)D * 2, (cuuint64_t)Sq * D * 2};
  const cuuint64_t kstr[2] = {(cuuint64_t)D * 2, (cuuint64_t)Skv * D * 2};
  const cuuint32_t qbox[3] = {8, WQ, 1}, kbox[3] = {8, WKV, 1};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  cudaError_t err = hopper::encode_map(&tq, bf, 3, q, qdims, qstr, qbox, none);
  if (err == cudaSuccess) err = hopper::encode_map(&tk, bf, 3, k, kdims, kstr, kbox, none);
  if (err == cudaSuccess) err = hopper::encode_map(&tv, bf, 3, v, kdims, kstr, kbox, none);
  if (err != cudaSuccess) return err;
  auto kernel = flash_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  const int stages = wgmma_stages(D);
  const dim3 grid((Sq + WQ - 1) / WQ, BH);
  kernel<<<grid, W_THREADS, wgmma_smem(D, stages), stream>>>(
      tq, tk, tv, static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<__nv_bfloat16*>(out), BH / BHkv, Sq, Skv, scale, stages);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, const void* qpos,
                           const void* kpos, void* out, int BH, int BHkv, int Sq, int Skv,
                           int D, float scale, cudaStream_t stream) {
  // one instantiation per head dim: every tile loop and product width is
  // known to the compiler, so no branch sits inside a wgmma sequence
#define FLASH_WGMMA_CASE(n) \
  case n:                   \
    return launch_wgmma<16 * n>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, scale, stream);
  switch (D / 16) {
    FLASH_WGMMA_CASE(1) FLASH_WGMMA_CASE(2) FLASH_WGMMA_CASE(3) FLASH_WGMMA_CASE(4)
    FLASH_WGMMA_CASE(5) FLASH_WGMMA_CASE(6) FLASH_WGMMA_CASE(7) FLASH_WGMMA_CASE(8)
    FLASH_WGMMA_CASE(9) FLASH_WGMMA_CASE(10) FLASH_WGMMA_CASE(11) FLASH_WGMMA_CASE(12)
    FLASH_WGMMA_CASE(13) FLASH_WGMMA_CASE(14) FLASH_WGMMA_CASE(15) FLASH_WGMMA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_WGMMA_CASE
}

bool bad_args(int BH, int BHkv, int Sq, int Skv, int D) {
  return BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || BH > 65535 || Sq <= 0 || Skv <= 0 ||
         D <= 0 || D > 256;
}

}  // namespace

extern "C" {

// 1 when flash_attention_fwd runs the wgmma kernel for this type and head
// dim (bfloat16, D a multiple of 16 up to 256), 0 when it runs the first.
int flash_attention_variant(int is_bf16, int D) {
  return is_bf16 && D >= 16 && D <= 256 && D % 16 == 0 ? 1 : 0;
}

// q (BH, Sq, D), k/v (BHkv, Skv, D), out (BH, Sq, D), all contiguous and of
// one type (float32, or bfloat16 when is_bf16); qpos (Sq,), kpos (Skv,)
// int32. Launches the kernel flash_attention_variant names on `stream` and
// returns the CUDA error code (0 = launched); cudaErrorInvalidValue for
// shapes the kernels do not take and, on the wgmma kernel, for q, k or v
// not 16-byte aligned.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kpos, void* out, int BH,
                        int BHkv, int Sq, int Skv, int D, float scale, int is_bf16,
                        void* stream) {
  if (bad_args(BH, BHkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      flash_attention_variant(is_bf16, D)
          ? dispatch_wgmma(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, s)
      : is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, s)
                : dispatch<float>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, s);
  return (int)err;
}

// The same function on the first kernel, whatever the type and head dim:
// the yardstick the wgmma kernel is held and timed against.
int flash_attention_fwd_simt(const void* q, const void* k, const void* v,
                             const void* qpos, const void* kpos, void* out, int BH,
                             int BHkv, int Sq, int Skv, int D, float scale, int is_bf16,
                             void* stream) {
  if (bad_args(BH, BHkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, s)
              : dispatch<float>(q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, s);
  return (int)err;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
