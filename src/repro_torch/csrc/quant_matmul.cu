// Int8 GEMMs for NVIDIA Hopper (sm_90a): W8A8 and weight-only W8A16.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quant_matmul/kernel.py:
//
// * `_qmm_kernel` (:31, called at :88), W8A8. a (M, K) int8 x w (K, N) int8
//   accumulated exactly in int32, then the float32 epilogue
//     out = fma(-f32(a_zp), f32(colsum[n]), f32(acc)) * a_scale * w_scale[n]
//   rounded to float32 after each step and cast to float32 or bfloat16
//   (nearest even). colsum[n] = sum_k w[k, n] (zero-point folding). The
//   subtraction is one FMA, rounded once: the reference kernel's `acc -
//   a_zp * colsum` is contracted into an FMA by XLA, so this is its
//   arithmetic. It is spelled with the `__fmaf_rn` / `__fmul_rn`
//   intrinsics, which nvcc neither contracts nor reorders.
// * `_w8a16_kernel` (:123, called at :169), weight-only int8. x (M, K)
//   float32 or bfloat16 x w (K, N) int8: float32 FMAs of float(x) *
//   float(w) over K, then acc * w_scale[n] once in the epilogue.
//
// Design. The TPU grid (m, n, k) carried an accumulator in VMEM across its
// sequential k axis; here one thread block owns a 128 x 128 output tile
// and loops over K itself, with the accumulator in registers. Tiles are
// staged in shared memory, and the next tile's global loads are issued
// into registers before the current tile is consumed.
//
// W8A8: 8 warps as 2 (m) x 4 (n), each warp 64 x 32 outputs, as 4 x 4
// `mma.sync.m16n8k32` int8 tensor-core products per 32-deep k step (int32
// accumulate, exact). A is staged row-major with 80-byte rows, so the 32
// lanes' fragment loads hit 32 banks; w arrives k-major from device memory
// and is transposed in 4 x 4-byte blocks with byte permutes into words of
// four consecutive k of one column, the layout the B fragment reads. The
// column sums come from a small kernel launched first on the same stream.
//
// W8A16: a float32 SGEMM on the CUDA cores, 16 x 16 threads each holding
// an 8 x 8 register tile; x is staged k-major as float32, w converted to
// float32 once when it is staged.
//
// Bound on the card, at the full-width shape M 8192 (4 x 2048 tokens),
// K 4096, N 11008: W8A8 does 2 M N K = 7.39e11 int8 operations, 0.373 ms at
// the 1,979 TOPS dense int8 peak, above the 0.131 ms its bytes take.
// `mma.sync` reaches only part of that peak (`wgmma` with TMA-fed shared
// memory is the later step). W8A16 does the same count of multiply-adds;
// with bfloat16 x they could run on the bf16 tensor cores exactly (int8
// values are exact in bf16, the products exact in float32), 0.747 ms at
// 989 TFLOP/s, while this kernel uses float32 FMAs at 67 TFLOP/s at best.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------------- W8A8 --

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // k per staged tile (two 32-deep mma steps)
constexpr int THREADS = 256;   // 8 warps
constexpr int LDA = BK + 16;   // bytes per staged A row
constexpr int LDBW = BN + 8;   // words per staged row of B k-quads

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack4(const int8_t* p, int n_valid) {
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (i < n_valid) v |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return v;
}

// colsum[n] = sum_k w[k, n]: 32 columns x 8 k-slices per block.
__global__ void __launch_bounds__(256)
colsum_kernel(const int8_t* __restrict__ w, int* __restrict__ colsum, int K, int N) {
  __shared__ int part[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + tx;
  int s = 0;
  if (n < N)
    for (int k = ty; k < K; k += 8) s += w[(size_t)k * N + n];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < N) {
    for (int i = 1; i < 8; ++i) s += part[i][tx];
    colsum[n] = s;
  }
}

struct W8A8Stage {
  uint4 a[2];       // two 16-byte chunks of A
  uint32_t b[2][4]; // two 4 x 4-byte blocks of w (4 k rows x 4 columns)
};

// A tile: 128 rows x 64 bytes = 512 chunks of 16 bytes, two per thread.
// w tile: 64 k x 128 columns = 16 x 32 blocks of 4 x 4 bytes, two per
// thread; a warp reads 128 consecutive bytes of each of 4 k rows.
__device__ __forceinline__ void w8a8_load(W8A8Stage& st, const int8_t* __restrict__ a,
                                          const int8_t* __restrict__ w, int M, int K,
                                          int N, int m0, int n0, int k0, bool a_vec,
                                          bool w_vec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * THREADS;
    const int row = i >> 2, kc = k0 + (i & 3) * 16, m = m0 + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < M && kc < K) {
      const int8_t* p = a + (size_t)m * K + kc;
      if (a_vec && kc + 16 <= K) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        const int left = K - kc;
        v.x = pack4(p, left);
        v.y = pack4(p + 4, left - 4);
        v.z = pack4(p + 8, left - 8);
        v.w = pack4(p + 12, left - 12);
      }
    }
    st.a[e] = v;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * THREADS;
    const int kb = i >> 5, nb = i & 31;
    const int n = n0 + nb * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + kb * 4 + r;
      uint32_t v = 0;
      if (k < K && n < N) {
        const int8_t* p = w + (size_t)k * N + n;
        v = (w_vec && n + 4 <= N) ? *reinterpret_cast<const uint32_t*>(p) : pack4(p, N - n);
      }
      st.b[e][r] = v;
    }
  }
}

__device__ __forceinline__ void w8a8_store(const W8A8Stage& st, uint8_t* sA, uint32_t* sB) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * THREADS;
    *reinterpret_cast<uint4*>(sA + (i >> 2) * LDA + (i & 3) * 16) = st.a[e];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * THREADS;
    const int kb = i >> 5, nb = i & 31;
    const uint32_t* r = st.b[e];
    // r[q] holds (k q; columns 0..3); word j below holds (column j; k 0..3)
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    uint32_t* dst = sB + kb * LDBW + nb * 4;
    dst[0] = __byte_perm(t0, t2, 0x5410);
    dst[1] = __byte_perm(t0, t2, 0x7632);
    dst[2] = __byte_perm(t1, t3, 0x5410);
    dst[3] = __byte_perm(t1, t3, 0x7632);
  }
}

template <typename TOut> __device__ __forceinline__ TOut from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TOut>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
            const float* __restrict__ a_scale_p, const int* __restrict__ a_zp_p,
            const float* __restrict__ w_scale, const int* __restrict__ colsum,
            TOut* __restrict__ out, int M, int K, int N, bool a_vec, bool w_vec) {
  __shared__ __align__(16) uint8_t sA[BM * LDA];
  __shared__ __align__(16) uint32_t sB[(BK / 4) * LDBW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int n_k = (K + BK - 1) / BK;
  W8A8Stage st;
  w8a8_load(st, a, w, M, K, N, m0, n0, 0, a_vec, w_vec);
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    w8a8_store(st, sA, sB);
    __syncthreads();
    if (kt + 1 < n_k) w8a8_load(st, a, w, M, K, N, m0, n0, (kt + 1) * BK, a_vec, w_vec);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = sA + (wm + i * 16 + g) * LDA + ks * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* p = sB + (ks * 8 + t) * LDBW + wn + j * 8 + g;
        bf[j][0] = p[0];
        bf[j][1] = p[4 * LDBW];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }

  const float a_scale = *a_scale_p;
  const float neg_zp = -(float)(*a_zp_p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn + j * 8 + 2 * t + c;
      if (n >= N) continue;
      const float cs = __int2float_rn(colsum[n]);
      const float ws = w_scale[n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + i * 16 + g + 8 * h;
          if (m >= M) continue;
          float v = __fmaf_rn(neg_zp, cs, __int2float_rn(acc[i][j][2 * h + c]));
          v = __fmul_rn(v, a_scale);
          v = __fmul_rn(v, ws);
          out[(size_t)m * N + n] = from_f32<TOut>(v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- W8A16 --

constexpr int FBK = 16;        // k per staged tile
constexpr int LDS = BM + 4;    // floats per staged k row (x and w)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TX, typename TOut>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ w_scale, TOut* __restrict__ out, int M, int K,
             int N) {
  __shared__ __align__(16) float sX[FBK * LDS];  // k-major: sX[k][m]
  __shared__ __align__(16) float sW[FBK * LDS];  // sW[k][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // x tile: 128 rows x 16 k, 8 per thread, 16 consecutive k of a row per
  // half-warp; w tile: 16 k x 128 columns, 8 per thread, a warp on 32
  // consecutive bytes of one k row
  float xr[8], wr[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = tid + e * THREADS;
      const int row = i >> 4, k = k0 + (i & 15), m = m0 + row;
      xr[e] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
      const int kw = k0 + (i >> 7), n = n0 + (i & 127);
      wr[e] = (kw < K && n < N) ? (float)w[(size_t)kw * N + n] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = tid + e * THREADS;
      sX[(i & 15) * LDS + (i >> 4)] = xr[e];
      sW[(i >> 7) * LDS + (i & 127)] = wr[e];
    }
  };

  const int n_k = (K + FBK - 1) / FBK;
  load(0);
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();
    store();
    __syncthreads();
    if (kt + 1 < n_k) load((kt + 1) * FBK);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sX + kk * LDS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sX + kk * LDS + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sW + kk * LDS + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sW + kk * LDS + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    if (n >= N) continue;
    const float ws = w_scale[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (m < M) out[(size_t)m * N + n] = from_f32<TOut>(__fmul_rn(acc[i][j], ws));
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename TOut>
cudaError_t launch_w8a8(const void* a, const void* w, const void* a_scale, const void* a_zp,
                        const void* w_scale, void* colsum, void* out, int M, int K, int N,
                        cudaStream_t stream) {
  colsum_kernel<<<(N + 31) / 32, 256, 0, stream>>>(static_cast<const int8_t*>(w),
                                                   static_cast<int*>(colsum), K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool a_vec = K % 16 == 0 && aligned(a, 16);
  const bool w_vec = N % 4 == 0 && aligned(w, 4);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_kernel<TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const int*>(a_zp),
      static_cast<const float*>(w_scale), static_cast<const int*>(colsum),
      static_cast<TOut*>(out), M, K, N, a_vec, w_vec);
  return cudaGetLastError();
}

template <typename TX, typename TOut>
cudaError_t launch_w8a16(const void* x, const void* w, const void* w_scale, void* out,
                         int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a16_kernel<TX, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<TOut*>(out), M, K, N);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535;
}

}  // namespace

extern "C" {

// a (M, K) int8, w (K, N) int8, a_scale one float32, a_zp one int32 (both
// read on the device), w_scale (N,) float32, colsum (N,) int32 scratch,
// out (M, N) float32 or, when out_bf16, bfloat16; all contiguous. Launches
// on `stream` and returns the CUDA error code (0 = launched).
int quant_matmul_w8a8(const void* a, const void* w, const void* a_scale, const void* a_zp,
                      const void* w_scale, void* colsum, void* out, int M, int K, int N,
                      int out_bf16, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16 ? launch_w8a8<__nv_bfloat16>(a, w, a_scale, a_zp, w_scale, colsum,
                                                     out, M, K, N, s)
                        : launch_w8a8<float>(a, w, a_scale, a_zp, w_scale, colsum, out, M,
                                             K, N, s));
}

// x (M, K) float32 or, when x_bf16, bfloat16; w (K, N) int8; w_scale (N,)
// float32; out (M, N) float32 or, when out_bf16, bfloat16; all contiguous.
int quant_matmul_w8a16(const void* x, const void* w, const void* w_scale, void* out,
                       int M, int K, int N, int x_bf16, int out_bf16, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = out_bf16 ? launch_w8a16<__nv_bfloat16, __nv_bfloat16>(x, w, w_scale, out, M, K, N, s)
                   : launch_w8a16<__nv_bfloat16, float>(x, w, w_scale, out, M, K, N, s);
  else
    err = out_bf16 ? launch_w8a16<float, __nv_bfloat16>(x, w, w_scale, out, M, K, N, s)
                   : launch_w8a16<float, float>(x, w, w_scale, out, M, K, N, s);
  return (int)err;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
