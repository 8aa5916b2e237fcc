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
//   float32 or bfloat16 x w (K, N) int8: the float32 sum over K of
//   float(x) * float(w), then acc * w_scale[n] once in the epilogue.
//
// Design. The TPU grid (m, n, k) carried an accumulator in VMEM across its
// sequential k axis; here one thread block owns a 128 x 128 output tile
// and loops over K itself, with the accumulator in registers.
//
// W8A8 runs two kernels, named by a rule with a C twin
// (`quant_matmul_w8a8_variant`, mirrored by `_variant` in
// kernels/quant_matmul/kernel.py): where K % 16 == 0 and a is 16-byte
// aligned (rows TMA can read), `w8::w8a8_wgmma_kernel`; otherwise the
// `mma.sync` kernel `w8a8_kernel`. A pre-pass, `w8a8_prep_kernel`, reads w
// once and writes its column sums (atomic int32 adds into a zeroed
// vector: exact, in any order) and, for the wgmma kernel, w transposed to
// wT (N, K): for 8-bit types `wgmma` takes both operands K-major (its
// transpose bits exist only for 16-bit types), and w (K, N) row-major is
// N-major. Nothing is cached across calls.
//
// `w8a8_wgmma_kernel`: 128 x 256 output tiles (the W8A16 bf16 shape),
// taken in groups of 16 M tiles that walk N together. A producer warp
// keeps a four-stage TMA ring of (a, wT) k tiles in flight, 128 bytes of k
// per stage, both 128-byte swizzled; two consumer warpgroups each run
// `wgmma.m64n256k32.s32.s8.s8` on their 64 rows, four k32 steps per stage,
// with one stage's products left in flight while the next stage's arrive;
// int32 accumulators, exact. Ragged M and N edges read TMA's zero fill and
// are masked at the store.
//
// `w8a8_kernel` (K % 16 != 0, where TMA cannot read a row): 8 warps as 2
// (m) x 4 (n), each warp 64 x 32 outputs, as 4 x 4 `mma.sync.m16n8k32`
// int8 tensor-core products per 32-deep k step. Tiles are staged in
// shared memory, the next tile's global loads issued into registers
// before the current tile is consumed. A is staged row-major with 80-byte
// rows, so the 32 lanes' fragment loads hit 32 banks; w arrives k-major
// from device memory and is transposed in 4 x 4-byte blocks with byte
// permutes into words of four consecutive k of one column, the layout the
// B fragment reads.
//
// Both kernels end in the same epilogue, bit for bit: one `__fmaf_rn`,
// two `__fmul_rn`, then the cast.
//
// W8A16 (`w16::w8a16_wgmma_kernel`): the bf16 tensor cores, exactly. Every
// int8 is exact in bf16 and a product of two bf16 is exact in float32, so
// bf16 x runs as one `wgmma` per k16 step. float32 x is split into three
// bf16 pieces, x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2),
// whose sum is x for 0 and every |x| from 2^-110 up to the largest bf16
// (bf16 has float32's exponent range; 3 x 8 significant bits hold 24;
// below 2^-110 the last piece would need bf16 subnormals finer than
// 2^-133, and its share of x is under 2^-16 there): three
// wgmmas against the same converted w tile, every product exact. Only the
// order of the float32 sum differs from a float32 FMA loop. A producer
// thread keeps a TMA ring of (x, w) k tiles in flight (bf16 x through a
// 128-byte-swizzled box the wgmmas read in place, float32 x in 8-column
// boxes; w as int8 rows); the two consumer warpgroups convert w to bf16
// (and float32 x to its pieces) for the next k tile while
// the tensor cores run this one. A ragged w (N % 16 != 0) or x (a row
// that is no multiple of 16 bytes) is read with per-thread loads in the
// same kernel.
//
// Bound on the card, at the full-width shape M 8192 (4 x 2048 tokens),
// K 4096, N 11008: W8A8 does 2 M N K = 7.39e11 int8 operations, 0.373 ms at
// the 1,979 TOPS dense int8 peak, above the 0.131 ms its bytes take (the
// pre-pass adds 2 K N = 90 MB, 0.027 ms, counted inside the W8A8 time).
// The wgmma kernel's tile loads hold it near 0.70 ms: with its products
// removed it took about as long. Two-block clusters that multicast each
// wT tile (half the L2 reads of w) and a persistent grid were no faster.
// W8A16 does the same count of multiply-adds
// on the bf16 tensor cores: 0.747 ms at 989 TFLOP/s dense with bf16 x,
// three times that with float32 x. Each k tile's loads (x and w, L2 to
// the SM) and the w conversion sit beside the products: at 128 x 128
// tiles, bf16 x ran no faster than its loads alone, so bf16 x takes
// 128 x 256 tiles (float32 x stays at 128 x 128 to fit its pieces).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// 4 k rows x 4 columns of w (r[q] holds k row q, columns 0..3) -> word j
// = column j, k rows 0..3 (four consecutive k of one column)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&d)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  d[0] = __byte_perm(t0, t2, 0x5410);
  d[1] = __byte_perm(t0, t2, 0x7632);
  d[2] = __byte_perm(t1, t3, 0x5410);
  d[3] = __byte_perm(t1, t3, 0x7632);
}

constexpr int PREP_K = 64, PREP_N = 128, PREP_KSPLIT = 512;

// colsum[n] += sum over this block's k of w[k, n] (colsum zeroed first) and,
// when wT is given, wT[n, k] = w[k, n]. Block (PREP_N columns, PREP_KSPLIT
// k rows) in 64 x 128 tiles: each thread reads two 4 x 4-byte blocks of a
// tile, transposes them with byte permutes, and the block writes wT rows
// as 16-byte chunks from shared memory. wT needs K % 16 == 0.
__global__ void __launch_bounds__(256)
w8a8_prep_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wT, int* __restrict__ colsum,
                 int K, int N, bool w_vec) {
  __shared__ uint32_t sT[PREP_N][PREP_K / 4 + 1];  // [column][k quad], one word of pad
  __shared__ int sCol[PREP_N];
  const int tid = threadIdx.x, nq = tid & 31;
  const int n0 = blockIdx.x * PREP_N, kb = blockIdx.y * PREP_KSPLIT;
  const int k_end = min(K, kb + PREP_KSPLIT);
  if (tid < PREP_N) sCol[tid] = 0;
  int cs[4] = {0, 0, 0, 0};
  for (int k0 = kb; k0 < k_end; k0 += PREP_K) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kq = (tid >> 5) + 8 * e;
      const int n = n0 + 4 * nq;
      uint32_t r[4], d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + 4 * kq + q;
        uint32_t v = 0;
        if (k < K && n < N) {
          const int8_t* p = w + (size_t)k * N + n;
          v = (w_vec && n + 4 <= N) ? *reinterpret_cast<const uint32_t*>(p) : pack4(p, N - n);
        }
        r[q] = v;
      }
      transpose4x4(r, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cs[j] = __dp4a((int)d[j], 0x01010101, cs[j]);
        sT[4 * nq + j][kq] = d[j];
      }
    }
    if (wT != nullptr) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // 128 rows of wT x 4 chunks of 16 k
        const int idx = tid + 256 * e, row = idx >> 2, q = idx & 3;
        const int n = n0 + row, k = k0 + 16 * q;
        if (n < N && k < K) {
          const uint32_t* src = &sT[row][4 * q];
          *reinterpret_cast<uint4*>(wT + (size_t)n * K + k) =
              make_uint4(src[0], src[1], src[2], src[3]);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) atomicAdd(&sCol[4 * nq + j], cs[j]);
  __syncthreads();
  if (tid < PREP_N && n0 + tid < N) atomicAdd(colsum + n0 + tid, sCol[tid]);
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
    // st.b[e][q] holds (k q; columns 0..3); word j below holds (column j; k 0..3)
    uint32_t d[4];
    transpose4x4(st.b[e], d);
    uint32_t* dst = sB + kb * LDBW + nb * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = d[j];
  }
}

template <typename TOut> __device__ __forceinline__ TOut from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The W8A8 epilogue, the reference kernel's arithmetic: one FMA for the
// zero-point fold, then the two scales, each rounded to float32.
__device__ __forceinline__ float w8a8_out(int acc, float neg_zp, float cs, float a_scale,
                                          float ws) {
  float v = __fmaf_rn(neg_zp, cs, __int2float_rn(acc));
  v = __fmul_rn(v, a_scale);
  return __fmul_rn(v, ws);
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
          out[(size_t)m * N + n] =
              from_f32<TOut>(w8a8_out(acc[i][j][2 * h + c], neg_zp, cs, a_scale, ws));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- W8A16 --

namespace w16 {

using hopper::LAYOUT_INTERLEAVE;
using hopper::LAYOUT_SW128;
using hopper::make_desc;

constexpr int BM = 128, BK = 64;  // block rows; k per stage
constexpr int THREADS = 384;      // two consumer warpgroups + a producer warpgroup
constexpr int X_TILE = BM * BK * 2;  // bytes of a bf16 x tile (or one piece)
constexpr int CB_SBO = 144;
constexpr int SMEM_LIMIT = 232448;

// Per activation type: bf16 x takes 128 x 256 output tiles and a ring of
// three stages; float32 x (three pieces, 32 KB x stages) 128 x 128 tiles
// and two stages, to fit the shared memory. A wider tile reads fewer
// bytes per product: at 128 x 128, bf16 x ran as fast as its tile loads
// alone (L2 to SM).
template <typename TX>
__host__ __device__ constexpr int pieces() { return sizeof(TX) == 4 ? 3 : 1; }
template <typename TX>
__host__ __device__ constexpr int block_n() { return sizeof(TX) == 4 ? 128 : 256; }
template <typename TX>
__host__ __device__ constexpr int stages() { return sizeof(TX) == 4 ? 2 : 3; }
template <typename TX>
__host__ __device__ constexpr int x_stage_bytes() { return BM * BK * (int)sizeof(TX); }
template <typename TX>
__host__ __device__ constexpr int w_tile_bytes() { return BK * block_n<TX>(); }
// converted w tile, interleaved MN-major: 8-column chunk c of k group q
// at c * CB_SBO + q * cb_lbo. The 16-byte pad after each chunk puts the
// 8 chunks a quarter-warp writes on 8 distinct bank groups.
template <typename TX>
__host__ __device__ constexpr int cb_lbo() { return (block_n<TX>() / 8) * CB_SBO; }
template <typename TX>
__host__ __device__ constexpr int cb_bytes() { return (BK / 8) * cb_lbo<TX>(); }

template <typename TX>
__host__ __device__ constexpr int smem_bytes() {  // + 1024 to align the base, + the barriers
  return 1024 + stages<TX>() * (x_stage_bytes<TX>() + w_tile_bytes<TX>()) +
         2 * pieces<TX>() * X_TILE + 2 * cb_bytes<TX>() + 16 * stages<TX>();
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// eight int8 (one row, eight columns) -> eight bf16, exactly, without the
// slow integer-to-float unit: byte b ^ 0x80 = v + 128 goes into the low
// byte of 2^23 (0x4B000000), so the float32 is 2^23 + 128 + v, and
// subtracting 2^23 + 128 leaves v exactly; a small integer's float32 has
// a zero low half, so its high half is its bf16
__device__ __forceinline__ uint4 int8x8_to_bf16(uint2 raw) {
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u = (h ? raw.y : raw.x) ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
                             8388736.0f);
    o[2 * h] = __byte_perm(f[0], f[1], 0x7632);
    o[2 * h + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  return out;
}

// x[m, k .. k + 7] as float32, zeros past the matrix: the per-thread
// path, taken only where TMA cannot read x (rows that are no multiple of
// 16 bytes, or a base that is not 16-byte aligned)
template <typename TX>
__device__ __forceinline__ void load_x8(float (&v)[8], const TX* __restrict__ x, int m, int k,
                                        int M, int K) {
  const TX* p = x + (size_t)m * K + k;
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (m < M && k + i < K) ? to_f32(p[i]) : 0.f;
}

// The consumer warpgroups' part of w8a16_wgmma_kernel.
template <typename TX, typename TOut>
__device__ __forceinline__ void consume(const TX* __restrict__ x, const int8_t* __restrict__ w,
                                        const float* __restrict__ w_scale,
                                        TOut* __restrict__ out, int M, int K, int N, int x_tma,
                                        int w_tma, uint32_t base, uint8_t* gbase) {
  constexpr int NP = pieces<TX>(), ST = stages<TX>(), XSB = x_stage_bytes<TX>();
  constexpr int BN = block_n<TX>(), W_TILE = w_tile_bytes<TX>();
  constexpr int CB_LBO = cb_lbo<TX>(), CB_BYTES = cb_bytes<TX>();
  constexpr bool F32 = sizeof(TX) == 4;
  const uint32_t xs = base, ws = xs + ST * XSB, xp = ws + ST * W_TILE;
  const uint32_t cb = xp + 2 * NP * X_TILE, bars = cb + 2 * CB_BYTES;
  const bool x_direct = !F32 && x_tma;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  const int wg = warp >> 2;
  // k tile kt into buffer b: w -> bf16; x -> pieces unless the wgmmas read
  // it from its stage. Each thread converts BN / 32 (k row, 8-column)
  // chunks of w and 4 (row, 8-k) chunks of x; x's loads are issued first.
  auto convert = [&](int kt, int b) {
    const int s = kt % ST, k0 = kt * BK;
    float xv[4][8];
    if (!x_direct) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // 128 rows x 8 k chunks
        const int idx = tid + 256 * e, m = idx & 127, kc = idx >> 7;
        if (x_tma) {  // float32 from the stage
          const float4* src = reinterpret_cast<const float4*>(gbase + s * XSB + kc * (BM * 32) +
                                                               m * 32);
          const float4 lo = src[0], hi = src[1];
          xv[e][0] = lo.x; xv[e][1] = lo.y; xv[e][2] = lo.z; xv[e][3] = lo.w;
          xv[e][4] = hi.x; xv[e][5] = hi.y; xv[e][6] = hi.z; xv[e][7] = hi.w;
        } else {
          load_x8<TX>(xv[e], x, m0 + m, k0 + 8 * kc, M, K);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < BN / 32; ++e) {  // 64 k rows x BN / 8 column chunks
      const int idx = tid + 256 * e, k = idx / (BN / 8), c = idx % (BN / 8);
      uint2 rawv;
      if (w_tma) {
        rawv = *reinterpret_cast<const uint2*>(gbase + (ws - base) + s * W_TILE + k * BN + 8 * c);
      } else {
        uint8_t* r8 = reinterpret_cast<uint8_t*>(&rawv);
        const int kg = k0 + k, n = n0 + 8 * c;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          r8[i] = (kg < K && n + i < N) ? (uint8_t)w[(size_t)kg * N + n + i] : 0;
      }
      *reinterpret_cast<uint4*>(gbase + (cb - base) + b * CB_BYTES + c * CB_SBO +
                                (k >> 3) * CB_LBO + (k & 7) * 16) = int8x8_to_bf16(rawv);
    }
    if (!x_direct) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + 256 * e, m = idx & 127, kc = idx >> 7;
        uint8_t* dst = gbase + (xp - base) + b * NP * X_TILE + kc * (BM * 16) + m * 16;
        __nv_bfloat162 pc[NP][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float lo = xv[e][2 * i], hi = xv[e][2 * i + 1];
#pragma unroll
          for (int p = 0; p < NP; ++p) {  // piece p = bf16(what the pieces before left)
            pc[p][i] = __floats2bfloat162_rn(lo, hi);
            const float2 f = __bfloat1622float2(pc[p][i]);
            lo -= f.x;
            hi -= f.y;
          }
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
          *reinterpret_cast<uint4*>(dst + p * X_TILE) = *reinterpret_cast<const uint4*>(pc[p]);
      }
      hopper::mbar_arrive(bars + 8 * (ST + s));  // this thread is done with the stage
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(bars, 0);
  convert(0, 0);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 256);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST, b = kt & 1;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = make_desc(cb + b * CB_BYTES + kk * 2 * CB_LBO, CB_LBO, CB_SBO,
                                    LAYOUT_INTERLEAVE);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint64_t da =
            x_direct ? make_desc(xs + s * XSB + wg * 64 * 128 + kk * 32, 16, 1024, LAYOUT_SW128)
                     : make_desc(xp + (b * NP + p) * X_TILE + wg * 64 * 16 + kk * 2 * (BM * 16),
                                 BM * 16, 128, LAYOUT_INTERLEAVE);
        if constexpr (BN == 256) {
          hopper::wgmma_m64n256_ss_tb(acc, da, db, 1);
        } else {
          hopper::wgmma_m64n128_ss_tb(acc, da, db, 1);
        }
      }
    }
    hopper::wgmma_commit();
    if (kt + 1 < nk) {
      hopper::mbar_wait(bars + 8 * ((kt + 1) % ST), ((kt + 1) / ST) & 1);
      convert(kt + 1, b ^ 1);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (x_direct) hopper::mbar_arrive(bars + 8 * (ST + s));
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, 256);
  }

  // acc[4 j + 2 h + e]: row 16 (warp % 4) + g + 8 h of this warpgroup's
  // 64, column 8 j + 2 t4 + e
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    if (n >= N) continue;
    const float s0 = w_scale[n], s1 = n + 1 < N ? w_scale[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
      if (m >= M) continue;
      const float v0 = __fmul_rn(acc[4 * j + 2 * h], s0);
      const float v1 = __fmul_rn(acc[4 * j + 2 * h + 1], s1);
      TOut* o = out + (size_t)m * N + n;
      if (pairs) {
        if constexpr (sizeof(TOut) == 4) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        }
      } else {
        o[0] = from_f32<TOut>(v0);
        if (n + 1 < N) o[1] = from_f32<TOut>(v1);
      }
    }
  }
}


template <typename TX, typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                   const TX* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, TOut* __restrict__ out, int M, int K,
                   int N, int x_tma, int w_tma) {
  constexpr int NP = pieces<TX>(), ST = stages<TX>(), XSB = x_stage_bytes<TX>();
  constexpr int BN = block_n<TX>(), W_TILE = w_tile_bytes<TX>(), CB_BYTES = cb_bytes<TX>();
  constexpr bool F32 = sizeof(TX) == 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  // from `base`: the TMA stages of x, then of w; the x pieces [2][NP]; the
  // converted w [2]; the barriers full[ST], empty[ST]
  const uint32_t xs = base, ws = xs + ST * XSB;
  const uint32_t bars = ws + ST * W_TILE + 2 * NP * X_TILE + 2 * CB_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (ST + s), 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one thread issues the TMA loads
    // registers go to the consumers (128 x 40 + 256 x 232 <= 65,536)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const uint32_t bytes = (x_tma ? XSB : 0) + (w_tma ? W_TILE : 0);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        const uint32_t full = bars + 8 * s;
        hopper::mbar_wait(bars + 8 * (ST + s), ((kt / ST) & 1) ^ 1);
        if (bytes == 0) {
          hopper::mbar_arrive(full);
          continue;
        }
        hopper::mbar_arrive_expect_tx(full, bytes);
        if (x_tma) {
          if (F32) {  // eight 8-float column chunks: chunk c at c * 4096, row m at m * 32
            for (int c = 0; c < BK / 8; ++c)
              hopper::tma_load_2d(xs + s * XSB + c * (BM * 32), &tmx, kt * BK + 8 * c, m0, full);
          } else {
            hopper::tma_load_2d(xs + s * XSB, &tmx, kt * BK, m0, full);
          }
        }
        if (w_tma) hopper::tma_load_2d(ws + s * W_TILE, &tmw, n0, kt * BK, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<TX, TOut>(x, w, w_scale, out, M, K, N, x_tma, w_tma, base, gbase);
  }
}
}  // namespace w16

// ---------------------------------------------------------- W8A8 wgmma --

namespace w8 {

using hopper::LAYOUT_SW128;
using hopper::make_desc;

constexpr int BM = 128, BN = 256, BK = 128;  // tile rows, columns; k bytes per stage
constexpr int ST = 4;                         // TMA ring stages
constexpr int THREADS = 384;                  // two consumer warpgroups + a producer warpgroup
constexpr int GROUP_M = 16;                   // M tiles per raster group
constexpr int A_TILE = BM * BK, B_TILE = BN * BK;
constexpr int SMEM = 1024 + ST * (A_TILE + B_TILE) + 16 * ST;  // + alignment, barriers

// Output tile t in grouped order: groups of GROUP_M M tiles walk N
// together, so the blocks in flight at once read a compact panel of a and
// wT, which stays in L2 (at 8192 x 4096 x 11008, 0.69 ms against 0.79 ms
// for the row-major order).
__device__ __forceinline__ void tile_origin(int t, int M, int N, int& m0, int& n0) {
  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * num_n, first_m = t / per_group * GROUP_M;
  const int in_group = t % per_group, gm = min(num_m - first_m, GROUP_M);
  m0 = (first_m + in_group % gm) * BM;
  n0 = in_group / gm * BN;
}

// One block per output tile, tile blockIdx.x in grouped order.
template <typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                  const float* __restrict__ a_scale_p, const int* __restrict__ a_zp_p,
                  const float* __restrict__ w_scale, const int* __restrict__ colsum,
                  TOut* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzled tiles start on 1 KB
  // from `base`: the a stages, the wT stages, the barriers full[ST], empty[ST]
  const uint32_t as = base, bs = as + ST * A_TILE, bars = bs + ST * B_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int m0, n0;
  tile_origin(blockIdx.x, M, N, m0, n0);
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (ST + s), 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        const uint32_t full = bars + 8 * s;
        hopper::mbar_wait(bars + 8 * (ST + s), ((kt / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full, A_TILE + B_TILE);
        hopper::tma_load_2d(as + s * A_TILE, &tma, kt * BK, m0, full);
        hopper::tma_load_2d(bs + s * B_TILE, &tmb, kt * BK, n0, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    uint32_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0u;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      hopper::mbar_wait(bars + 8 * s, (kt / ST) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t da = make_desc(as + s * A_TILE + wg * 64 * BK + kk * 32, 16, 1024,
                                      LAYOUT_SW128);
        const uint64_t db = make_desc(bs + s * B_TILE + kk * 32, 16, 1024, LAYOUT_SW128);
        hopper::wgmma_m64n256k32_s8(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the stage before this one has been read
      if (kt > 0 && lane == 0) hopper::mbar_arrive(bars + 8 * (ST + (kt - 1) % ST));
      __syncwarp();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // acc[4 j + 2 h + e]: row 16 (warp % 4) + g + 8 h of this warpgroup's
    // 64, column 8 j + 2 t4 + e
    const float a_scale = *a_scale_p;
    const float neg_zp = -(float)(*a_zp_p);
    const int g = lane >> 2, t4 = lane & 3;
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      if (n >= N) continue;
      const bool two = n + 1 < N;
      const float cs0 = __int2float_rn(colsum[n]), ws0 = w_scale[n];
      const float cs1 = two ? __int2float_rn(colsum[n + 1]) : 0.f;
      const float ws1 = two ? w_scale[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
        if (m >= M) continue;
        const float v0 = w8a8_out((int)acc[4 * j + 2 * h], neg_zp, cs0, a_scale, ws0);
        const float v1 = w8a8_out((int)acc[4 * j + 2 * h + 1], neg_zp, cs1, a_scale, ws1);
        TOut* o = out + (size_t)m * N + n;
        if (pairs) {
          if constexpr (sizeof(TOut) == 4) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          o[0] = from_f32<TOut>(v0);
          if (two) o[1] = from_f32<TOut>(v1);
        }
      }
    }
  }
}

}  // namespace w8

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The W8A8 variant rule: the wgmma kernel where TMA can read a's rows (K %
// 16 == 0, a 16-byte aligned); the mma.sync kernel otherwise.
bool w8a8_wgmma(int K, const void* a) { return K % 16 == 0 && aligned(a, 16); }

// colsum (zeroed here) and, when wT is given, wT = w^T
cudaError_t launch_prep(const void* w, void* wT, void* colsum, int K, int N,
                        cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(colsum, 0, (size_t)N * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + PREP_N - 1) / PREP_N, (K + PREP_KSPLIT - 1) / PREP_KSPLIT);
  w8a8_prep_kernel<<<grid, 256, 0, stream>>>(static_cast<const int8_t*>(w),
                                             static_cast<int8_t*>(wT), static_cast<int*>(colsum),
                                             K, N, N % 4 == 0 && aligned(w, 4));
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_w8a8_mma(const void* a, const void* w, const void* a_scale, const void* a_zp,
                            const void* w_scale, void* colsum, void* out, int M, int K, int N,
                            cudaStream_t stream) {
  cudaError_t err = launch_prep(w, nullptr, colsum, K, N, stream);
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

template <typename TOut>
cudaError_t launch_w8a8_wgmma(const void* a, const void* w, const void* a_scale,
                              const void* a_zp, const void* w_scale, void* colsum, void* wT,
                              void* out, int M, int K, int N, cudaStream_t stream) {
  if (wT == nullptr || !aligned(wT, 16)) return cudaErrorInvalidValue;
  cudaError_t err = launch_prep(w, wT, colsum, K, N, stream);
  if (err != cudaSuccess) return err;
  // a (M, K) and wT (N, K): 128 x 128-byte and 256 x 128-byte boxes,
  // 128-byte swizzled; zeros past K, M and N
  CUtensorMap tma{}, tmb{};
  const cuuint32_t box_a[2] = {(cuuint32_t)w8::BK, (cuuint32_t)w8::BM};
  const cuuint32_t box_b[2] = {(cuuint32_t)w8::BK, (cuuint32_t)w8::BN};
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dims_b[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  err = hopper::encode_map(&tma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, dims_a, stride, box_a,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::encode_map(&tmb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wT, dims_b, stride, box_b,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = w8::w8a8_wgmma_kernel<TOut>;
  static_assert(w8::SMEM <= w16::SMEM_LIMIT, "W8A8 stages exceed a block's shared memory");
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w8::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + w8::BM - 1) / w8::BM) * ((N + w8::BN - 1) / w8::BN);
  kernel<<<tiles, w8::THREADS, w8::SMEM, stream>>>(
      tma, tmb, static_cast<const float*>(a_scale), static_cast<const int*>(a_zp),
      static_cast<const float*>(w_scale), static_cast<const int*>(colsum),
      static_cast<TOut*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename TX, typename TOut>
cudaError_t launch_w8a16(const void* x, const void* w, const void* w_scale, void* out,
                         int M, int K, int N, cudaStream_t stream) {
  // TMA where rows are whole multiples of 16 bytes and the base is 16-byte
  // aligned (bf16 x: K % 8 == 0; w: N % 16 == 0); otherwise the consumers
  // read that operand with per-thread loads inside the same kernel
  CUtensorMap tmx{}, tmw{};
  const bool x_tma = (K * sizeof(TX)) % 16 == 0 && hopper::aligned16(x);
  const bool w_tma = N % 16 == 0 && hopper::aligned16(w);
  constexpr int BN = w16::block_n<TX>();
  if (x_tma) {  // bf16: 64 x 128 boxes, 128-byte swizzled; float32: 8 x 128 boxes
    const bool f32 = sizeof(TX) == 4;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t str[1] = {(cuuint64_t)K * sizeof(TX)};
    const cuuint32_t box[2] = {f32 ? 8u : (cuuint32_t)w16::BK, (cuuint32_t)w16::BM};
    cudaError_t err = hopper::encode_map(
        &tmx, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
        dims, str, box, f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  if (w_tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K}, str[1] = {(cuuint64_t)N};
    const cuuint32_t box[2] = {(cuuint32_t)BN, (cuuint32_t)w16::BK};
    cudaError_t err = hopper::encode_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, str,
                                         box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  auto kernel = w16::w8a16_wgmma_kernel<TX, TOut>;
  constexpr int smem = w16::smem_bytes<TX>();
  static_assert(smem <= w16::SMEM_LIMIT, "W8A16 tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + w16::BM - 1) / w16::BM);
  kernel<<<grid, w16::THREADS, smem, stream>>>(
      tmx, tmw, static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<TOut*>(out), M, K, N, x_tma, w_tma);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535;
}

}  // namespace

extern "C" {

// 1 when quant_matmul_w8a8 runs the wgmma kernel for this K and a.
int quant_matmul_w8a8_variant(int K, const void* a) { return w8a8_wgmma(K, a) ? 1 : 0; }

// a (M, K) int8, w (K, N) int8, a_scale one float32, a_zp one int32 (both
// read on the device), w_scale (N,) float32, colsum (N,) int32 scratch,
// wT (N, K) int8 scratch (needed where quant_matmul_w8a8_variant is 1;
// refused when null there), out (M, N) float32 or, when out_bf16,
// bfloat16; all contiguous. Runs the pre-pass and the kernel the variant
// rule names on `stream` and returns the CUDA error code (0 = launched).
int quant_matmul_w8a8(const void* a, const void* w, const void* a_scale, const void* a_zp,
                      const void* w_scale, void* colsum, void* wT, void* out, int M, int K,
                      int N, int out_bf16, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!w8a8_wgmma(K, a))
    return (int)(out_bf16 ? launch_w8a8_mma<__nv_bfloat16>(a, w, a_scale, a_zp, w_scale, colsum,
                                                           out, M, K, N, s)
                          : launch_w8a8_mma<float>(a, w, a_scale, a_zp, w_scale, colsum, out,
                                                   M, K, N, s));
  return (int)(out_bf16 ? launch_w8a8_wgmma<__nv_bfloat16>(a, w, a_scale, a_zp, w_scale, colsum,
                                                           wT, out, M, K, N, s)
                        : launch_w8a8_wgmma<float>(a, w, a_scale, a_zp, w_scale, colsum, wT,
                                                   out, M, K, N, s));
}

// The same arguments but wT; always the mma.sync kernel (any K).
int quant_matmul_w8a8_mma(const void* a, const void* w, const void* a_scale, const void* a_zp,
                          const void* w_scale, void* colsum, void* out, int M, int K, int N,
                          int out_bf16, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16 ? launch_w8a8_mma<__nv_bfloat16>(a, w, a_scale, a_zp, w_scale, colsum,
                                                         out, M, K, N, s)
                        : launch_w8a8_mma<float>(a, w, a_scale, a_zp, w_scale, colsum, out, M,
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
