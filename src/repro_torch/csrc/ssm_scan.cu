// Chunked Mamba2 SSD scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssm_scan/kernel.py:40, called at :97). For each
// (batch*head) sequence and each chunk of `ck` steps in order, in float32:
//
//   cum     = cumsum(dA over the chunk)
//   L[i,j]  = exp(cum[i] - cum[j]) for j <= i, else exp(-inf) = 0
//   xdt     = x * dt[:, None]
//   y       = ((C B^T) * L) xdt + (C * exp(cum)[:, None]) h
//   h      <- exp(cum[-1]) h + (B * exp(cum[-1] - cum)[:, None])^T xdt
//
// with the (ds, ph) state h zero at the first chunk. x (BH, S, ph), b and c
// (BG, S, ds) read through the head-group index bh / (BH / BG) (so heads
// that share B and C need no broadcast copy), dA and dt (BH, S) float32,
// y (BH, S, ph) in x's type (float32 or bfloat16). Steps past S in the last
// chunk read x = b = c = dA = dt = 0, which is what the reference's zero
// padding gives, and are not written.
//
// Design. The TPU grid (bh, chunk) ran chunks in order on one core and
// carried h in VMEM scratch; here one thread block owns one bh and loops
// over its chunks, with h in shared memory. Per chunk the block stages
// xdt, B, C (rows padded to ds + 1 floats, so 16 threads reading 16 rows
// at one column hit 16 banks), forms C B^T * L as a ck x (ck + 1) tile,
// then y and the new h, each as a register tile of 8 x 4 (or 8 x 8)
// outputs per thread from shared memory. At ck = 128, ds = ph = 64 that is
// 179 KB of shared memory, above the 48 KB default, so the launcher opts
// in with cudaFuncSetAttribute. The chunk's cumulative sum is a warp scan.
//
// Bound on the card, one zamba2-1.2b Mamba2 layer (B 4, S 2048, 64 heads of
// ph 64, ds 64, ck 128): the chunked products are 2 ck^2 (ds + ph) +
// 4 ck ds ph = 6.29 M flops per chunk, 25.8 G in all, 0.385 ms at the 67
// TFLOP/s float32 rate; its ~140 MB take 0.042 ms in bfloat16. The block
// count (B * H = 256, one block per SM for its shared memory) and the
// float32 FMAs from shared memory keep this kernel well off that bound;
// tensor-core products per chunk (the chunk's matmuls in bf16/tf32-split)
// are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int CK_MAX = 128;   // chunk rows: 8 per thread row ty + 16 r
constexpr int PH_MAX = 64;    // ph columns: 4 per thread column tx + 16 c
constexpr int DS_MAX = 128;   // ds rows of h: 8 per thread row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr size_t smem_floats(int ck, int ph, int ds) {
  return (size_t)ck * ph            // xdt
         + 2 * (size_t)ck * (ds + 1)  // B, C
         + (size_t)ck * (ck + 1)      // C B^T * L
         + (size_t)ds * ph            // h
         + 3 * (size_t)ck;            // cum, exp(cum), exp(total - cum)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
           const float* __restrict__ dA, const float* __restrict__ dt, T* __restrict__ y,
           int group, int S, int ph, int ds, int ck) {
  extern __shared__ float smem[];
  const int ldb = ds + 1, ldl = ck + 1;
  float* sX = smem;              // ck x ph
  float* sB = sX + ck * ph;      // ck x ldb
  float* sC = sB + ck * ldb;     // ck x ldb
  float* sL = sC + ck * ldb;     // ck x ldl: (C B^T) * L
  float* sH = sL + ck * ldl;     // ds x ph
  float* sCum = sH + ds * ph;    // ck
  float* sDin = sCum + ck;       // exp(cum)
  float* sDout = sDin + ck;      // exp(total - cum)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const size_t row0 = (size_t)bh * S;                   // x, y, dA, dt
  const size_t brow0 = (size_t)(bh / group) * S;        // b, c

  for (int i = tid; i < ds * ph; i += THREADS) sH[i] = 0.f;

  const int n_chunks = (S + ck - 1) / ck;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int s0 = chunk * ck;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < ck * ph; i += THREADS) {
      const int r = i / ph, p = i - r * ph, s = s0 + r;
      sX[i] = s < S ? to_f32(x[(row0 + s) * ph + p]) * dt[row0 + s] : 0.f;
    }
    for (int i = tid; i < ck * ds; i += THREADS) {
      const int r = i / ds, d = i - r * ds, s = s0 + r;
      const bool live = s < S;
      sB[r * ldb + d] = live ? to_f32(b[(brow0 + s) * ds + d]) : 0.f;
      sC[r * ldb + d] = live ? to_f32(c[(brow0 + s) * ds + d]) : 0.f;
    }
    if (warp == 0) {  // cum: 4 steps per lane, then a scan over the lanes
      float v[4], run = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lane * 4 + q, s = s0 + r;
        run += (r < ck && s < S) ? dA[row0 + s] : 0.f;
        v[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lane * 4 + q;
        if (r < ck) sCum[r] = excl + v[q];
      }
    }
    __syncthreads();

    const float total = sCum[ck - 1];
    if (tid < ck) {
      sDin[tid] = expf(sCum[tid]);
      sDout[tid] = expf(total - sCum[tid]);
    }
    {  // sL[i][j] = (C B^T)[i][j] * exp(cum[i] - cum[j]) for j <= i, else 0
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
      for (int d = 0; d < ds; ++d) {
        float cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = min(ty + 16 * r, ck - 1);
          cv[r] = sC[i * ldb + d];
          bv[r] = sB[min(tx + 16 * r, ck - 1) * ldb + d];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i >= ck) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = tx + 16 * q;
          if (j >= ck) continue;
          sL[i * ldl + j] = j <= i ? acc[r][q] * expf(sCum[i] - sCum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    {  // y = sL xdt + (C * exp(cum)) h
      float yi[8][4], ys[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) yi[r][q] = ys[r][q] = 0.f;
      int pc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pc[q] = min(tx + 16 * q, ph - 1);
      int ir[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) ir[r] = min(ty + 16 * r, ck - 1);
      for (int j = 0; j < ck; ++j) {
        float lv[8], xv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) lv[r] = sL[ir[r] * ldl + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = sX[j * ph + pc[q]];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yi[r][q] = fmaf(lv[r], xv[q], yi[r][q]);
      }
      float din[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) din[r] = sDin[ir[r]];
      for (int d = 0; d < ds; ++d) {
        float cv[8], hv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = sC[ir[r] * ldb + d] * din[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = sH[d * ph + pc[q]];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) ys[r][q] = fmaf(cv[r], hv[q], ys[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r, s = s0 + i;
        if (i >= ck || s >= S) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < ph) y[(row0 + s) * ph + p] = from_f32<T>(yi[r][q] + ys[r][q]);
        }
      }
    }
    __syncthreads();  // every reader of h is done

    {  // h <- exp(total) h + (B * exp(total - cum))^T xdt
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      int pc[4], dr[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) pc[q] = min(tx + 16 * q, ph - 1);
#pragma unroll
      for (int r = 0; r < 8; ++r) dr[r] = min(ty + 16 * r, ds - 1);
      for (int i = 0; i < ck; ++i) {
        const float dout = sDout[i];
        float bv[8], xv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) bv[r] = sB[i * ldb + dr[r]] * dout;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = sX[i * ph + pc[q]];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(bv[r], xv[q], acc[r][q]);
      }
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int d = ty + 16 * r;
        if (d >= ds) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < ph) sH[d * ph + p] = decay * sH[d * ph + p] + acc[r][q];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* b, const void* c, const void* dA,
                   const void* dt, void* y, int BH, int BG, int S, int ph, int ds, int ck,
                   cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  const size_t smem = smem_floats(ck, ph, ds) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(dA), static_cast<const float*>(dt), static_cast<T*>(y),
      BH / BG, S, ph, ds, ck);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (BH, S, ph), b/c (BG, S, ds), y (BH, S, ph): float32, or bfloat16 when
// is_bf16; dA/dt (BH, S) float32; all contiguous. BG divides BH; 1 <= ck <=
// 128, ph <= 64, ds <= 128, as the wrapper in kernels/ssm_scan/kernel.py
// checks. Launches on `stream` and returns the CUDA error code (0 =
// launched; cudaFuncSetAttribute refuses shapes that need more shared
// memory than a block of the card has).
int ssm_scan_fwd(const void* x, const void* b, const void* c, const void* dA,
                 const void* dt, void* y, int BH, int BG, int S, int ph, int ds, int ck,
                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, b, c, dA, dt, y, BH, BG, S, ph, ds, ck, s)
                       : launch<float>(x, b, c, dA, dt, y, BH, BG, S, ph, ds, ck, s));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
