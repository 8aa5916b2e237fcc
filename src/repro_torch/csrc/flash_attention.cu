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
// Design. The TPU grid (bh, q block, kv block) ran in order on one core
// and carried m, l, acc in VMEM scratch across kv blocks; here one thread
// block owns one (bh, 64-row q tile) and loops over 64-row kv tiles
// itself, with m, l and its share of acc in registers. 256 threads: thread
// (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 16 i (i < 4), the score
// columns tx + 16 j (j < 4) and the output columns tx + 16 jj. Q, K, V
// and the probabilities are staged in shared memory as float32; K and Q
// rows are padded by one float so a column read by 16 neighbouring
// threads hits 16 banks. A row's max and sum are reduced over its 16
// threads with warp shuffles. Ragged Sq is handled by bounds checks
// (q rows past Sq read the edge position and are never written); ragged
// Skv by treating rows past Skv as masked with K = V = 0, which is what
// the reference's padding (position 2^30, zero K/V) gives.
//
// Bound on the card. Attention does 4 D flops per (q, k) pair the causal
// mask keeps and moves q, out and the live kv rows once: at B = 4,
// S = 2048, H = 32, D = 128 in bf16 it is bound by operations on the
// tensor cores (989 TFLOP/s dense), 0.139 ms. This kernel does its
// products with float32 FMAs on the CUDA cores out of shared memory, so
// it sits far from that bound; WGMMA on bf16 tiles fed by TMA is the
// later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" {

// q (BH, Sq, D), k/v (BHkv, Skv, D), out (BH, Sq, D), all contiguous and of
// one type (float32, or bfloat16 when is_bf16); qpos (Sq,), kpos (Skv,)
// int32. Launches on `stream` and returns the CUDA error code (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kpos, void* out, int BH,
                        int BHkv, int Sq, int Skv, int D, float scale, int is_bf16,
                        void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || BH > 65535 || Sq <= 0 ||
      Skv <= 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
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
