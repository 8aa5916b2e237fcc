// Chunked Mamba2 SSD scan for NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssm_scan/kernel.py:40, called at :97). For each
// (batch*head) sequence and each chunk of `ck` steps, in float32:
//
//   cum     = cumsum(dA over the chunk),  total = cum[ck - 1]
//   L[i,j]  = exp(cum[i] - cum[j]) for j <= i, else exp(-inf) = 0
//   y       = ((C B^T) * L) (x * dt) + (C * exp(cum)) h
//   h      <- exp(total) h + (B * exp(total - cum))^T (x * dt)
//
// with the (ds, ph) state h zero at the first chunk. x (BH, S, ph), b and c
// (BG, S, ds) read through the head-group index bh / (BH / BG) (heads that
// share B and C need no broadcast copy), dA and dt (BH, S) float32, y
// (BH, S, ph) in x's type (float32 or bfloat16). Steps past S in the last
// chunk read x = b = c = dA = dt = 0, which is what the reference's zero
// padding gives, and are not written.
//
// Design: the standard SSD decomposition, one C entry launching three
// kernels on the stream.
//   (a) ssd_states_kernel, one block per (bh, chunk) but the last: the
//       chunk's own state s_k = (B * exp(total - cum) * dt)^T x, and
//       exp(total), into float32 scratch the wrapper allocates.
//   (b) ssd_pass_kernel, one thread per 4 state elements of a bh,
//       sequential over chunks: h_k = exp(total_k) h_{k-1} + s_k, one fmaf
//       per element, writing the bf16 pieces of h_{k-1}, the
//       state entering chunk k. The scratch is chunk-major, so each step
//       reads and writes one contiguous block.
//   (c) ssd_output_kernel, one block per (batch row, chunk, group of up to
//       4 heads that share B and C): G = C B^T once per block, then per
//       head y = exp(cum) * (C h_{k-1}) + ((G * L) * dt^T) x.
// 960 + 1,024 blocks at full width: chunks run in parallel, and no block
// holds a state across chunks.
//
// Products on the bf16 tensor cores, exactly. Every product is an
// `mma.sync.m16n8k16` of bf16 pieces with float32 accumulation. An operand
// that is bf16 in memory (bf16 x, B, C) goes whole; one that is float32
// (the rescaled rows, L, exp(...), h, and float32 inputs) is split into
// three bf16 pieces by truncation, v1 = v with its low 16 bits cleared,
// v2 = the same of v - v1, v3 = v - v1 - v2, whose sum is v exactly (AND
// and FADD: no conversion instruction, which runs at a quarter of the ALU
// rate). Each piece product is exact in float32; with two split operands
// the products of pieces p + q >= 3, of an order of 2^-22 relative, are
// left out. Row and column scales go onto the float32 side so the
// bf16-exact operand stays whole: (G * L) (x * dt) = ((G * L) * dt^T) x,
// (C * exp(cum)) h = exp(cum) * (C h), and the state takes (B * exp(total
// - cum) * dt)^T x. L is never factored as exp(cum_i) exp(-cum_j):
// exp(-cum_j) overflows float32 at |cum| ~ 90. So with bf16 inputs each
// product is three piece products against one exact operand (C B^T is one);
// with float32 inputs six.
//
// Why `mma.sync` and not `wgmma`: the tiles are small (ck 128 x ds 64 x
// ph 64) and the left operand of y's intra-chunk product is computed in
// registers from G (times L, times dt, split in three): an m16n8
// accumulator is, packed in pairs, the A fragment of the next m16n8k16
// product, with no trip through shared memory. Each warp owns a 16-row
// band of the chunk, so the causal mask drops whole 16 x 16 tiles (band r
// forms r + 1 of them); bands r and 7 - r share a scheduler. `wgmma` would
// need 64-row warpgroup tiles, which keep more of the masked work at ck 128.
//
// Shared memory holds bf16 pieces, rows padded by 8 elements so that the
// eight 16-byte rows of an `ldmatrix` land on eight bank groups; widths
// pad to multiples of 16 with zeros. Tiles arrive by `cp.async` where they
// need no conversion (bf16 rows of whole 16-byte chunks, h's pieces), and
// through registers, every load of a thread issued before the first
// conversion, where they do. (c) with bf16 inputs keeps G in shared memory
// in fragment order and fits two blocks on an SM (103 KB, at most 128
// registers, where ptxas spills 56 bytes); with float32 inputs G stays in
// registers and one block runs (139 KB at ds 64); ds 128 fits both
// (143 KB / 211 KB).
//
// Bound on the card, one zamba2-1.2b Mamba2 layer (B 4, S 2048, 64 heads of
// ph 64, ds 64, ck 128, bf16): 13.0 G masked flops (C B^T once per batch
// row) times the piece products each needs, 38.8 G at the 989 TFLOP/s
// dense bf16 rate, 0.039 ms; its 140.5 MB take 0.042 ms, the bound. The
// scratch (63 MB of states, 101 MB of h pieces, each written once and read
// once) moves 330 MB more that the bound does not count; the
// state-passing kernel runs near its memory rate, and the other two are
// bound by load latency between their phases (one block's copies wait on
// barriers) more than by their products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;   // 8 warps, 16 chunk rows each
constexpr int CK_MAX = 128;    // chunk rows
constexpr int PH_MAX = 64;     // head dim: 4 n16 column groups
constexpr int HEADS_MAX = 4;   // heads per block of (c)

template <typename T>
__host__ __device__ constexpr int pieces() { return sizeof(T) == 4 ? 3 : 1; }

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------- tensor cores --

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D(16x8, f32) += A(16x16, bf16) B(16x8, bf16). Fragments, lane = 4 g + t:
// A a[0..3] = (row g, k 2t..2t+1), (row g + 8, k 2t..), (row g, k 2t + 8..),
// (row g + 8, k 2t + 8..); B b0 = (k 2t..2t+1, col g), b1 = (k 2t + 8.., col
// g); D d[0..3] = (row g, col 2t, 2t + 1), (row g + 8, col 2t, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix row addresses (each lane names one 16-byte row of one of the
// four 8 x 8 matrices), for bf16 arrays of row stride `ld` elements:
// the A fragment (m16 x k16 at m0, k0) of an [m][k] array
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int ld, int m0, int k0, int lane) {
  return base + 2u * ((m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// ... of a [k][m] array (ldmatrix .trans)
__device__ __forceinline__ uint32_t at_addr(uint32_t base, int ld, int m0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  return base + 2u * ((k0 + r + (q >> 1) * 8) * ld + m0 + (q & 1) * 8);
}
// two B fragments (k16 x n8 at n0 and at n0 + 8; r[0..1], r[2..3]) of an
// [n][k] array
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int ld, int n0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  return base + 2u * ((n0 + r + (q >> 1) * 8) * ld + k0 + (q & 1) * 8);
}
// ... of a [k][n] array (ldmatrix .trans)
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int ld, int n0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  return base + 2u * ((k0 + r + (q & 1) * 8) * ld + n0 + (q >> 1) * 8);
}

// The bf16 pieces of a float32: piece = the value with its low 16 bits
// cleared (a bf16 value, by truncation), then the same of what is left,
// which is exact. Three pieces hold all 24 significant bits, so they sum to
// v exactly, for every finite v, with no conversion instruction (AND and
// FADD run at the full ALU rate, a float-to-bf16 conversion at a quarter).
__device__ __forceinline__ float bf16_head(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffff0000u);
}

// (bf16 lo, bf16 hi) of two bf16-valued floats, in one register
__device__ __forceinline__ uint32_t pack_heads(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// ------------------------------------------------------------ staging --

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x wpad (a multiple of 16) bf16 of src (row stride `width`, a
// multiple of 8, 16-byte aligned) into smem at `dst` (row stride ld), by
// 16-byte asynchronous copies; rows from `live` on, and columns from
// `width` on, are zero-filled
__device__ __forceinline__ void stage_async(uint32_t dst, int ld, const bf16* __restrict__ src,
                                            int width, int wpad, int live, int rows) {
  const int per_row = wpad >> 3;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    const bool ok = r < live && c < width;
    cp_async16(dst + 2u * (r * ld + c), ok ? src + (size_t)r * width + c : src, ok ? 16 : 0);
  }
}

// v[0..7] = row[col .. col + 7] as float32, zeros past `width` or for a row
// that is not live; 16-byte loads where `vec` (width % 8 == 0, base aligned)
template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* __restrict__ row, int col,
                                      int width, bool live, bool vec) {
  if (live && vec && col + 8 <= width) {
    if constexpr (sizeof(T) == 4) {
      const float4 lo = *reinterpret_cast<const float4*>(row + col);
      const float4 hi = *reinterpret_cast<const float4*>(row + col + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + col);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (live && col + i < width) ? to_f32(row[col + i]) : 0.f;
  }
}

// Eight values as NP bf16 pieces (bf16_head), piece p at dst + p * plane.
// One piece (NP 1) is taken only of bf16 values, which it holds exactly.
template <int NP>
__device__ __forceinline__ void put8(bf16* dst, int plane, const float (&v)[8]) {
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = v[i];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[i] = bf16_head(r[i]);
      r[i] -= h[i];
    }
    *reinterpret_cast<uint4*>(dst + p * plane) =
        make_uint4(pack_heads(h[0], h[1]), pack_heads(h[2], h[3]), pack_heads(h[4], h[5]),
                   pack_heads(h[6], h[7]));
  }
}

// Staging through registers, for rows x wpad (a multiple of 16) of src
// (row stride `width`), 8-element chunks first .. first + IT x THREADS - 1
// in row-major order: load_rows issues every load of a thread (zeros past
// `width` and from row `live` on); put_rows scales each row by
// row_scale[r] when it is given and writes NP piece planes of row stride ld.
template <int IT, typename T>
__device__ __forceinline__ void load_rows(float (&v)[IT][8], const T* __restrict__ src, int width,
                                          int wpad, int live, int rows, bool vec, int first = 0) {
  const int per_row = wpad >> 3, total = rows * per_row;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = first + threadIdx.x + it * THREADS;
    if (idx < total) {
      const int r = idx / per_row, c = (idx - r * per_row) * 8;
      load8<T>(v[it], src + (size_t)r * width, c, width, r < live, vec);
    }
  }
}

template <int NP, int IT>
__device__ __forceinline__ void put_rows(bf16* dst, int plane, int ld, float (&v)[IT][8],
                                         int wpad, int rows, const float* row_scale,
                                         int first = 0) {
  const int per_row = wpad >> 3, total = rows * per_row;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = first + threadIdx.x + it * THREADS;
    if (idx < total) {
      const int r = idx / per_row, c = (idx - r * per_row) * 8;
      if (row_scale != nullptr) {
        const float sc = row_scale[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[it][i] *= sc;
      }
      put8<NP>(dst + r * ld + c, plane, v[it]);
    }
  }
}

// A chunk's rows of x, B or C (width w <= 128) into NP planes: bf16 rows
// that are whole 16-byte chunks by asynchronous copies (NP is 1 there),
// the rest through registers
template <int NP, int IT, typename T>
__device__ __forceinline__ void stage_rows(bf16* dst, int plane, int ld, const T* __restrict__ src,
                                           int width, int wpad, int live, int rows, bool vec) {
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      stage_async(smem_u32(dst), ld, reinterpret_cast<const bf16*>(src), width, wpad, live, rows);
      return;
    }
  }
  float v[IT][8];
  load_rows<IT, T>(v, src, width, wpad, live, rows, vec);
  put_rows<NP, IT>(dst, plane, ld, v, wpad, rows, nullptr);
}

// One warp: out[r] = dA[s0] + ... + dA[s0 + r] over the chunk's live steps,
// for all 128 rows (past ck the chunk's total): 4 per lane, then a scan
// over the lanes, summed in float64 and rounded to float32 once, so each
// prefix sum is the correctly rounded one whatever the order. exp(cum_i -
// cum_j) turns an absolute error of cum (up to ~90 in magnitude) into a
// relative error of L: a float32 scan in another order than the plain
// version's uses most of the float32 tolerance at full width.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dA, int s0, int ck,
                                             int S, float* out, int lane) {
  double v[4], run = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = lane * 4 + q, s = s0 + r;
    run += (r < ck && s < S) ? (double)dA[s] : 0.0;
    v[q] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q) out[lane * 4 + q] = (float)(excl + v[q]);
}

// Scratch, chunk-major so that each step of (b) reads and writes one
// contiguous block: states[k][bh] (php x dsp float32, [p][d]) holds s_k
// for k < n - 1; decay[bh][k] = exp(total_k); hp[k][bh] (3 planes of php x
// dsp bf16, [p][d]) the pieces of h_{k-1}, the state entering chunk k.

// ------------------------------------------------- (a) chunk states --

__host__ __device__ constexpr size_t states_smem(int np, int ckp, int php, int dsp) {
  return 2 * ((size_t)np * ckp * (php + 8) + 3 * (size_t)ckp * (dsp + 8)) + 3 * CK_MAX * 4;
}

// states[chunk][bh] = x^T u with u[i][d] = B[i][d] * exp(total - cum[i]) *
// dt[i]; decay[bh][chunk] = exp(total). Flat grid over bh x (n_chunks - 1).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_states_kernel(const T* __restrict__ x, const T* __restrict__ b, const float* __restrict__ dA,
                  const float* __restrict__ dt, float* __restrict__ states,
                  float* __restrict__ decay, int BH, int group, int S, int ph, int ds, int ck,
                  int n_chunks, int vec_x, int vec_b) {
  constexpr int NX = pieces<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int ckp = round16(ck), php = round16(ph), dsp = round16(ds);
  const int ldp = php + 8, ldd = dsp + 8;
  const int plane_x = ckp * ldp, plane_u = ckp * ldd;
  bf16* sX = reinterpret_cast<bf16*>(smem);     // NX x [i][p]
  bf16* sU = sX + NX * plane_x;                 // 3 x [i][d]
  float* sCum = reinterpret_cast<float*>(sU + 3 * plane_u);
  float* sDt = sCum + CK_MAX;
  float* sW = sDt + CK_MAX;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x % (n_chunks - 1), bh = blockIdx.x / (n_chunks - 1);
  const int s0 = chunk * ck, live = min(ck, S - s0);
  const size_t row0 = (size_t)bh * S, brow0 = (size_t)(bh / group) * S;

  // x by asynchronous copies where it can (bf16 rows of whole 16-byte
  // chunks), issued first; B's first loads before the scan they wait on
  const bool x_async = sizeof(T) == 2 && vec_x;
  const T* xs = x + (row0 + s0) * ph;
  const T* bs = b + (brow0 + s0) * ds;
  if (x_async) stage_async(smem_u32(sX), ldp, reinterpret_cast<const bf16*>(xs), ph, php, live, ckp);
  cp_commit();
  float v[4][8];
  load_rows<4, T>(v, bs, ds, dsp, live, ckp, vec_b);
  if (warp == 0) chunk_cumsum(dA + row0, s0, ck, S, sCum, lane);
  if (tid < CK_MAX) sDt[tid] = tid < live ? dt[row0 + s0 + tid] : 0.f;
  __syncthreads();
  const float total = sCum[ck - 1];
  if (tid < CK_MAX) sW[tid] = expf(total - sCum[tid]) * sDt[tid];
  if (tid == 0) decay[(size_t)bh * (n_chunks - 1) + chunk] = expf(total);
  __syncthreads();
  // u = B * w as three pieces, 4 x THREADS chunks of 8 at a time
  for (int first = 0; first < ckp * (dsp / 8); first += 4 * THREADS) {
    if (first > 0) load_rows<4, T>(v, bs, ds, dsp, live, ckp, vec_b, first);
    put_rows<3, 4>(sU, plane_u, ldd, v, dsp, ckp, sW, first);
  }
  if (!x_async) {  // ckp x php / 8 <= 4 x THREADS chunks
    load_rows<4, T>(v, xs, ph, php, live, ckp, vec_x);
    put_rows<NX, 4>(sX, plane_x, ldp, v, php, ckp, nullptr);
  }
  cp_wait<0>();
  __syncthreads();

  const uint32_t ux = smem_u32(sX), uu = smem_u32(sU);
  const int g = lane >> 2, t = lane & 3;
  const int n_m = php / 16, n_g = (dsp + 31) / 32;
  float* out = states + ((size_t)chunk * BH + bh) * php * dsp;
  for (int item = warp; item < n_m * n_g; item += THREADS / 32) {
    const int m0 = (item % n_m) * 16, n0 = (item / n_m) * 32;
    const bool two = n0 + 16 < dsp;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int k0 = 0; k0 < ckp; k0 += 16) {
      uint32_t a[NX][4], bb[3][2][4];
#pragma unroll
      for (int p = 0; p < NX; ++p) ldsm_x4_t(a[p], at_addr(ux + 2u * p * plane_x, ldp, m0, k0, lane));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        ldsm_x4_t(bb[q][0], bt_addr(uu + 2u * q * plane_u, ldd, n0, k0, lane));
        if (two) ldsm_x4_t(bb[q][1], bt_addr(uu + 2u * q * plane_u, ldd, n0 + 16, k0, lane));
      }
#pragma unroll
      for (int p = 0; p < NX; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (p + q >= 3) continue;
          mma(acc[0], a[p], bb[q][0][0], bb[q][0][1]);
          mma(acc[1], a[p], bb[q][0][2], bb[q][0][3]);
          if (two) {
            mma(acc[2], a[p], bb[q][1][0], bb[q][1][1]);
            mma(acc[3], a[p], bb[q][1][2], bb[q][1][3]);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= 2 && !two) continue;
      const int col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + (m0 + g) * dsp + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * dsp + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// ------------------------------------------------- (b) state passing --

// One thread per 4 elements of a bh's state (per = php * dsp / 4 of them),
// chunks in order: hp[k] = pieces of h_{k-1}, then h_k = exp(total_k)
// h_{k-1} + s_k, one fmaf (h_{-1} = 0).
__global__ void __launch_bounds__(256)
ssd_pass_kernel(const float4* __restrict__ states, const float* __restrict__ decay,
                uint2* __restrict__ hp, int n_chunks, int per, int BH) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)BH * per) return;
  const size_t bh = idx / per, e = idx - bh * per;
  const float* dec = decay + bh * (n_chunks - 1);
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < n_chunks; ++k) {
    uint2* out = hp + ((size_t)k * BH + bh) * 3 * per + e;
    float r[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float pc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = bf16_head(r[i]);
        r[i] -= pc[i];
      }
      out[(size_t)p * per] = make_uint2(pack_heads(pc[0], pc[1]), pack_heads(pc[2], pc[3]));
    }
    if (k + 1 < n_chunks) {
      const float4 s = states[((size_t)k * BH + bh) * per + e];
      const float a = dec[k];
      h = make_float4(fmaf(a, h.x, s.x), fmaf(a, h.y, s.y), fmaf(a, h.z, s.z),
                      fmaf(a, h.w, s.w));
    }
  }
}

// ------------------------------------------------------- (c) outputs --

// Bytes of the output kernel's shared memory, laid out as C's pieces, then
// a region that holds B's pieces until G = C B^T is formed and then G (bf16
// inputs only) and the head buffer (this head's x pieces, then the 3
// pieces of h_{k-1}), then every head's cum and dt.
__host__ __device__ constexpr int g_smem(int ckp) {  // G's kept 16 x 8 tiles, 512 bytes each
  return (ckp / 16) * (ckp / 16 + 1) * 512;
}
__host__ __device__ constexpr int head_smem(int np, int ckp, int php, int dsp) {
  return 2 * (np * ckp * (php + 8) + 3 * php * (dsp + 8));
}
__host__ __device__ constexpr int region_smem(int np, int ckp, int php, int dsp) {
  return np * ckp * (dsp + 8) * 2 >
                 (np == 1 ? g_smem(ckp) : 0) + head_smem(np, ckp, php, dsp)
             ? np * ckp * (dsp + 8) * 2
             : (np == 1 ? g_smem(ckp) : 0) + head_smem(np, ckp, php, dsp);
}
__host__ __device__ constexpr size_t outputs_smem(int np, int ckp, int php, int dsp) {
  return (size_t)np * ckp * (dsp + 8) * 2 + region_smem(np, ckp, php, dsp) +
         2 * HEADS_MAX * CK_MAX * 4;
}

// p[0] = a and, when `two`, p[1] = b; one vector store where `vec` (p
// aligned to the pair)
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, bool vec, bool two) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    }
  } else {
    p[0] = from_f32<T>(a);
    if (two) p[1] = from_f32<T>(b);
  }
}

// Flat grid over (batch row bg, chunk, head group), head group fastest so
// neighbouring blocks share B and C in L2. G = C B^T is formed once per
// block. With bf16 inputs it then goes to shared memory in fragment order
// (36 KB at ck 128), so the kernel needs at most 128 registers and 103 KB
// and two blocks share an SM: one's copies run while the other's products
// do. With float32 inputs (three times the shared memory for pieces) G
// stays in 64 registers and one block runs per SM.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                  const float* __restrict__ dA, const float* __restrict__ dt,
                  const bf16* __restrict__ hp, T* __restrict__ y, int BH, int group, int heads,
                  int S, int ph, int ds, int ck, int n_chunks, int vec_x, int vec_b) {
  constexpr int NX = pieces<T>();
  constexpr bool G_SMEM = NX == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ckp = round16(ck), php = round16(ph), dsp = round16(ds);
  const int ldp = php + 8, ldd = dsp + 8;
  const int plane_c = ckp * ldd, plane_x = ckp * ldp, plane_h = php * ldd;
  bf16* sC = reinterpret_cast<bf16*>(smem);                          // NX x [i][d]
  uint8_t* region = smem + 2 * NX * plane_c;
  bf16* sB = reinterpret_cast<bf16*>(region);                        // NX x [j][d]
  float4* sG = reinterpret_cast<float4*>(region);                    // [tile][lane]
  bf16* sX = reinterpret_cast<bf16*>(region + (G_SMEM ? g_smem(ckp) : 0));  // NX x [j][p]
  bf16* sH = sX + NX * plane_x;                                      // 3 x [p][d]
  float* sCum = reinterpret_cast<float*>(region + region_smem(NX, ckp, php, dsp));
  float* sDt = sCum + HEADS_MAX * CK_MAX;                            // HEADS_MAX x 128 each

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_hg = group / heads;
  const int hg = blockIdx.x % n_hg, rest = blockIdx.x / n_hg;
  const int chunk = rest % n_chunks, bg = rest / n_chunks;
  const int bh0 = bg * group + hg * heads;
  const int s0 = chunk * ck, live = min(ck, S - s0);
  const size_t brow0 = (size_t)bg * S;

  stage_rows<NX, 8, T>(sC, plane_c, ldd, c + (brow0 + s0) * ds, ds, dsp, live, ckp, vec_b);
  stage_rows<NX, 8, T>(sB, plane_c, ldd, b + (brow0 + s0) * ds, ds, dsp, live, ckp, vec_b);
  cp_commit();
  if (warp < heads) chunk_cumsum(dA + (size_t)(bh0 + warp) * S, s0, ck, S, sCum + warp * CK_MAX, lane);
  for (int i = tid; i < heads * CK_MAX; i += THREADS) {
    const int hh = i / CK_MAX, r = i - hh * CK_MAX;
    sDt[i] = r < live ? dt[(size_t)(bh0 + hh) * S + s0 + r] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  const uint32_t uc = smem_u32(sC), ub = smem_u32(sB), ux = smem_u32(sX), uh = smem_u32(sH);
  // this warp's 16-row band of the chunk: bands rt and 7 - rt go to warps
  // w and w + 4, which share a scheduler, so each scheduler gets the same
  // count of the 16 x 16 tiles the causal mask keeps
  const int rt = warp < 4 ? warp : 11 - warp;
  const int i0 = rt * 16;
  const bool active = i0 < ckp;
  const int g = lane >> 2, t = lane & 3;
  const int ia = i0 + g, ib = ia + 8;  // this thread's two rows
  const int tile0 = rt * (rt + 1);     // the band's first tile of G in sG

  // G = C B^T on this band's rows, columns j < i0 + 16 (the tiles the
  // causal mask keeps): G[n] is the m16n8 tile of columns 8n .. 8n + 7
  float G[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) G[n][e] = 0.f;
  if (active) {
    for (int kd = 0; kd < dsp; kd += 16) {
      uint32_t a[NX][4];
#pragma unroll
      for (int p = 0; p < NX; ++p) ldsm_x4(a[p], a_addr(uc + 2u * p * plane_c, ldd, i0, kd, lane));
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        if (jp > rt) continue;
        uint32_t bb[NX][4];
#pragma unroll
        for (int q = 0; q < NX; ++q) ldsm_x4(bb[q], b_addr(ub + 2u * q * plane_c, ldd, 16 * jp, kd, lane));
#pragma unroll
        for (int p = 0; p < NX; ++p)
#pragma unroll
          for (int q = 0; q < NX; ++q) {
            if (p + q >= 3) continue;
            mma(G[2 * jp], a[p], bb[q][0], bb[q][1]);
            mma(G[2 * jp + 1], a[p], bb[q][2], bb[q][3]);
          }
      }
    }
  }
  __syncthreads();  // B is consumed: its space takes G (bf16 inputs) and the head buffer
  if constexpr (G_SMEM) {
    if (active) {
#pragma unroll
      for (int n = 0; n < 16; ++n)
        if (n < 2 * (rt + 1)) sG[(tile0 + n) * 32 + lane] = make_float4(G[n][0], G[n][1], G[n][2], G[n][3]);
    }
  }

  for (int hh = 0; hh < heads; ++hh) {
    const size_t bh = bh0 + hh;
    stage_rows<NX, 4, T>(sX, plane_x, ldp, x + (bh * S + s0) * ph, ph, php, live, ckp, vec_x);
    stage_async(uh, ldd, hp + ((size_t)chunk * BH + bh) * 3 * php * dsp, dsp, dsp, 3 * php,
                3 * php);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (active) {
      const float* cum = sCum + hh * CK_MAX;
      const float* dtv = sDt + hh * CK_MAX;
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      // C h_{k-1}
      for (int kd = 0; kd < dsp; kd += 16) {
        uint32_t a[NX][4];
#pragma unroll
        for (int p = 0; p < NX; ++p) ldsm_x4(a[p], a_addr(uc + 2u * p * plane_c, ldd, i0, kd, lane));
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t hb[PH_MAX / 16][4];
#pragma unroll
          for (int np = 0; np < PH_MAX / 16; ++np)
            if (16 * np < php) ldsm_x4(hb[np], b_addr(uh + 2u * q * plane_h, ldd, 16 * np, kd, lane));
#pragma unroll
          for (int p = 0; p < NX; ++p) {
            if (p + q >= 3) continue;
#pragma unroll
            for (int np = 0; np < PH_MAX / 16; ++np) {
              if (16 * np >= php) continue;
              mma(acc[2 * np], a[p], hb[np][0], hb[np][1]);
              mma(acc[2 * np + 1], a[p], hb[np][2], hb[np][3]);
            }
          }
        }
      }
      const float ca = cum[ia], cb = cum[ib];
      const float ea = expf(ca), eb = expf(cb);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= ea;
        acc[n][1] *= ea;
        acc[n][2] *= eb;
        acc[n][3] *= eb;
      }
      // + ((G * L) * dt^T) x for G's tiles gt (columns 16 kk .. 16 kk + 15)
      auto intra = [&](int kk, const float (&gt)[2][4]) {
        uint32_t am[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pc[3][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * kk + 8 * half + 2 * t + (e & 1);
            const int i = e < 2 ? ia : ib;
            float m = j <= i ? gt[half][e] * expf((e < 2 ? ca : cb) - cum[j]) * dtv[j] : 0.f;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              pc[p][e] = bf16_head(m);
              m -= pc[p][e];
            }
          }
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            am[p][2 * half] = pack_heads(pc[p][0], pc[p][1]);
            am[p][2 * half + 1] = pack_heads(pc[p][2], pc[p][3]);
          }
        }
#pragma unroll
        for (int q = 0; q < NX; ++q) {
          uint32_t xb[PH_MAX / 16][4];
#pragma unroll
          for (int np = 0; np < PH_MAX / 16; ++np)
            if (16 * np < php)
              ldsm_x4_t(xb[np], bt_addr(ux + 2u * q * plane_x, ldp, 16 * np, 16 * kk, lane));
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            if (p + q >= 3) continue;
#pragma unroll
            for (int np = 0; np < PH_MAX / 16; ++np) {
              if (16 * np >= php) continue;
              mma(acc[2 * np], am[p], xb[np][0], xb[np][1]);
              mma(acc[2 * np + 1], am[p], xb[np][2], xb[np][3]);
            }
          }
        }
      };
      if constexpr (G_SMEM) {
#pragma unroll 1
        for (int kk = 0; kk <= rt; ++kk) {
          const float4 lo = sG[(tile0 + 2 * kk) * 32 + lane], hi = sG[(tile0 + 2 * kk + 1) * 32 + lane];
          const float gt[2][4] = {{lo.x, lo.y, lo.z, lo.w}, {hi.x, hi.y, hi.z, hi.w}};
          intra(kk, gt);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk > rt) continue;
          const float gt[2][4] = {{G[2 * kk][0], G[2 * kk][1], G[2 * kk][2], G[2 * kk][3]},
                                  {G[2 * kk + 1][0], G[2 * kk + 1][1], G[2 * kk + 1][2],
                                   G[2 * kk + 1][3]}};
          intra(kk, gt);
        }
      }
      T* yb = y + (bh * S + s0) * ph;
      const bool pairs = (ph & 1) == 0;  // then col + 1 < ph too
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= ph) continue;
        const bool two = col + 1 < ph;
        if (ia < live) store2<T>(yb + (size_t)ia * ph + col, acc[n][0], acc[n][1], pairs, two);
        if (ib < live) store2<T>(yb + (size_t)ib * ph + col, acc[n][2], acc[n][3], pairs, two);
      }
    }
    __syncthreads();  // every reader of this head's x and h is done
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch(const void* x, const void* b, const void* c, const void* dA, const void* dt,
                   void* y, void* states, void* decay, void* hp, int BH, int BG, int S, int ph,
                   int ds, int ck, cudaStream_t stream) {
  constexpr int NX = pieces<T>();
  const int n = (S + ck - 1) / ck;
  const int ckp = round16(ck), php = round16(ph), dsp = round16(ds);
  const int group = BH / BG;
  const int heads = group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
  const int vec_x = ph % 8 == 0 && aligned16(x);
  const int vec_b = ds % 8 == 0 && aligned16(b) && aligned16(c);
  const T* xt = static_cast<const T*>(x);
  const float* dAf = static_cast<const float*>(dA);
  const float* dtf = static_cast<const float*>(dt);
  float* st = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  cudaError_t err;
  if (n > 1) {  // (a): every chunk but the last
    const size_t smem = states_smem(NX, ckp, php, dsp);
    if ((err = opt_in(ssd_states_kernel<T>, smem)) != cudaSuccess) return err;
    ssd_states_kernel<T><<<(unsigned)BH * (n - 1), THREADS, smem, stream>>>(
        xt, static_cast<const T*>(b), dAf, dtf, st, dec, BH, group, S, ph, ds, ck, n, vec_x,
        vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int per = php * dsp / 4;  // (b)
  ssd_pass_kernel<<<(unsigned)(((size_t)BH * per + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(st), dec, static_cast<uint2*>(hp), n, per, BH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = outputs_smem(NX, ckp, php, dsp);  // (c)
  if ((err = opt_in(ssd_output_kernel<T>, smem)) != cudaSuccess) return err;
  ssd_output_kernel<T><<<(unsigned)BG * n * (group / heads), THREADS, smem, stream>>>(
      xt, static_cast<const T*>(b), static_cast<const T*>(c), dAf, dtf,
      static_cast<const bf16*>(hp), static_cast<T*>(y), BH, group, heads, S, ph, ds, ck, n,
      vec_x, vec_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (BH, S, ph), b/c (BG, S, ds), y (BH, S, ph): float32, or bfloat16 when
// is_bf16; dA/dt (BH, S) float32; all contiguous. BG divides BH; 1 <= ck <=
// 128, ph <= 64, ds <= 128, as the wrapper in kernels/ssm_scan/kernel.py
// checks. Scratch, with n = ceil(S / ck), php = round16(ph), dsp =
// round16(ds): states, float32 of max(n - 1, 1) x BH x php x dsp; decay,
// float32 of BH x max(n - 1, 1); hp, bfloat16 of n x BH x 3 x php x dsp.
// Launches the three kernels on `stream` and returns the CUDA error code
// (0 = launched).
int ssm_scan_fwd(const void* x, const void* b, const void* c, const void* dA,
                 const void* dt, void* y, void* states, void* decay, void* hp, int BH, int BG,
                 int S, int ph, int ds, int ck, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<bf16>(x, b, c, dA, dt, y, states, decay, hp, BH, BG, S, ph, ds,
                                      ck, s)
                       : launch<float>(x, b, c, dA, dt, y, states, decay, hp, BH, BG, S, ph, ds,
                                       ck, s));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
