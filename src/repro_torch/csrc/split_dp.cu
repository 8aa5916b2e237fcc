// Exact split DP on Hopper (sm_90a): the dense and fused kernels.
//
// Replaces the two Pallas TPU kernels of src/repro/core/pallas_dp.py:
//   dense_dp_kernel <- _dense_kernel (pallas_call at pallas_dp.py:218)
//   fused_dp_tiled_kernel and fused_dp_kernel <- _fused_kernel
//                                              (pallas_call at pallas_dp.py:246)
//
// Recurrence, for scenario s, device step k = 2..N and boundary b:
//   new[b] = min over a = 0..L-2 of dp[a] (+ or max) C[s, k-1, a+1, b]
//   arg[b] = first argmin + 1, or -1 where new[b] is not finite
// A row whose fleet is complete (ns[s] < k) is frozen: its dp carries
// over and its args are -1. The fused kernels build
//   C[s, k-1, a+1, b] = bank[row(s, k), a+1, b] + tx[s, b]
// in T inside the reduction (f32(local) + f32(tx), the reference's fused
// arithmetic), so the (S, N, L, L) tensor never exists; row(s, k) is
// bank_idx[s, k-1], or k-1 when bank_idx is null (one shared stack).
//
// What bounds them on an H100 SXM (3.35 TB/s HBM3; 67 TFLOP/s fp32 off
// the tensor cores counts an FMA as two, so adds and compares issue at
// 33.5 T/s), at N = 5, L = 54 in f32, every row live:
//   dense: reading the part of C the recurrence uses (C[s,0,0,:] and rows
//          1..L-1 of C[s,1:N]), plus the outputs; at S = 65,536 3.14 GB:
//          0.94 ms. The design reads each of those rows once, coalesced
//          along b, and keeps the running dp row in shared memory, so C
//          is the only large device-memory stream.
//   fused: its arithmetic, 3 operations (build add, combine, compare) per
//          candidate (a, b): at S = 65,536, 0.75 G candidates, 0.067 ms,
//          over 143 MB of outputs, tx and row indices (0.043 ms).
//
// The fused kernel has two designs; split_dp_fused_variant names the one
// split_dp_fused runs (its Python twin is _fused_variant in cuda_dp.py):
//
// fused_dp_tiled_kernel, where L - 1 <= 64 and the staged bank fits the
// 227 KB a block may use (every shape sweep() launches):
//   * Tiles of scenarios. A block takes tile_scenarios(L) scenarios and one
//     thread per (scenario, b) pair, the pairs packed across warps, so at
//     L = 54 (4 per tile, 216 pairs on 224 lanes) and L = 52 (3, 156 on
//     160) over 90% of the lanes hold a pair. Blocks are persistent: the
//     grid fills the SMs once and each block walks the tiles; the last
//     tile may be partial. A tile's inputs (tx, ns, the first two rows) are
//     loaded one tile ahead with loads the compiler may not sink, ns two
//     tiles ahead, so device-memory latency hides behind the tile before.
//   * The bank is staged in shared memory once per block, transposed into
//     cost columns (bank[r, a+1, b] at a, padded with +inf to a multiple
//     of 4 and to 16 bytes modulo 32, so 8 neighbouring columns' 16-byte
//     loads hit distinct banks), beside row 0 of every matrix. The tile's
//     dp rows live there too, double-buffered (zeroed once).
//   * A thread keeps its costs c[a] = bank[row, a+1, b] + tx[s, b] (built
//     in T) in registers and builds them again only when the step's row
//     changes: in a homogeneous sweep every step k >= 2 reads the same
//     later-device matrix, so one build (a 16-byte shared load a group)
//     serves all four steps. dp[s, a] is read four at a time as a
//     broadcast (one 16-byte load for every thread of the scenario).
//   * A split first-minimum reduction. Candidates go in groups of 4; a
//     group's minimum is a tree of three min instructions, and two
//     independent running (value, group) minima take the even and the odd
//     groups with a strict `<`. They merge by strict value, then the lower
//     group; the winning group's four candidates are formed again from
//     shared memory (the same two roundings, so the same bits) and the
//     lowest a whose value equals the minimum is the argmin, its value the
//     output. That is the first-minimum argmin torch.min(dim), numpy and
//     jnp.argmin share, and the value the in-order scan keeps. The adds
//     are never reordered: c = bank + tx, then dp + c (tx is not hoisted
//     out of the minimum, which would change the rounding).
//   fused_dp_split_mirror in cuda_dp.py is this reduction in PyTorch.
//   What holds it (PERF.md): 6 of the group loop's 11 instructions per 4
//   candidates are min, compare and select instructions, which run at
//   half the add rate, and 119 registers a thread leave 14 warps an SM to
//   hide their latency.
//
// fused_dp_kernel, the first design, for every other shape (L > 65, or a
// bank past the shared-memory budget, e.g. float64 at large L): one block
// per scenario, threads over b (striding when L > blockDim), the dp row
// double-buffered in shared memory, the k loop inside the block, each
// thread scanning a = 0..L-2 in order with a strict `<`.
// There is no TPU padding: no 128-lane L, no replica rows.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T infinity();

template <>
__device__ __forceinline__ float infinity<float>() {
  return __int_as_float(0x7f800000);
}

template <>
__device__ __forceinline__ double infinity<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// False for +-inf (and NaN, which the inputs never hold).
template <typename T>
__device__ __forceinline__ bool finite(T x) {
  return (x < T(0) ? -x : x) < infinity<T>();
}

// dp[a] (+ or max) c: the recurrence's combine, in this order and rounding.
template <typename T, bool kMax>
__device__ __forceinline__ T combine(T d, T c) {
  return kMax ? (c > d ? c : d) : d + c;
}

// One device step of the block's scenario. `rows` points at row a+1 = 1
// of the step's (L, L) cost matrix, or is null for a frozen row. `cur`
// is the dp row in shared memory; the new row goes to `nxt` and to the
// step's output rows.
template <typename T, bool kMax, bool kFused>
__device__ __forceinline__ void dp_step(const T* __restrict__ cur,
                                        T* __restrict__ nxt,
                                        const T* __restrict__ rows,
                                        const T* __restrict__ txs,
                                        T* __restrict__ dps_row,
                                        int* __restrict__ args_row, int L) {
  for (int b = threadIdx.x; b < L; b += blockDim.x) {
    T best = cur[b];
    int arg = -1;
    if (rows != nullptr) {
      const T tb = kFused ? txs[b] : T(0);
      best = infinity<T>();
      int first = 0;
      for (int a = 0; a < L - 1; ++a) {
        T c = rows[static_cast<long long>(a) * L + b];
        if (kFused) c = c + tb;
        const T v = combine<T, kMax>(cur[a], c);
        if (v < best) {
          best = v;
          first = a;
        }
      }
      arg = finite(best) ? first + 1 : -1;
    }
    nxt[b] = best;
    dps_row[b] = best;
    args_row[b] = arg;
  }
}

template <typename T, bool kMax>
__global__ void dense_dp_kernel(const T* __restrict__ C,
                                const int* __restrict__ ns,
                                T* __restrict__ dp0, T* __restrict__ dps,
                                int* __restrict__ args, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + L;
  const long long s = blockIdx.x;
  const long long LL = static_cast<long long>(L) * L;
  const T* Cs = C + s * N * LL;
  for (int b = threadIdx.x; b < L; b += blockDim.x) {
    const T v = Cs[b];  // C[s, 0, 0, b]: layers 1..b on device 1
    cur[b] = v;
    dp0[s * L + b] = v;
  }
  __syncthreads();
  const int n_s = ns[s];
  for (int k = 2; k <= N; ++k) {
    const T* rows = n_s >= k ? Cs + (k - 1) * LL + L : nullptr;
    const long long out = (s * (N - 1) + (k - 2)) * L;
    dp_step<T, kMax, false>(cur, nxt, rows, nullptr, dps + out, args + out, L);
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T, bool kMax>
__global__ void fused_dp_kernel(const T* __restrict__ bank,
                                const int* __restrict__ bank_idx,
                                const T* __restrict__ tx,
                                const int* __restrict__ ns,
                                T* __restrict__ dp0, T* __restrict__ dps,
                                int* __restrict__ args, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + L;
  const long long s = blockIdx.x;
  const long long LL = static_cast<long long>(L) * L;
  const T* txs = tx + s * L;
  // device k's local-cost matrix; dead slots (k > ns[s]) are never read
  auto stack_row = [&](int k) {
    const int r = bank_idx != nullptr ? bank_idx[s * N + (k - 1)] : k - 1;
    return bank + r * LL;
  };
  const T* first = stack_row(1);
  for (int b = threadIdx.x; b < L; b += blockDim.x) {
    const T v = first[b] + txs[b];  // C[s, 0, 0, b] built in T
    cur[b] = v;
    dp0[s * L + b] = v;
  }
  __syncthreads();
  const int n_s = ns[s];
  for (int k = 2; k <= N; ++k) {
    const T* rows = n_s >= k ? stack_row(k) + L : nullptr;
    const long long out = (s * (N - 1) + (k - 2)) * L;
    dp_step<T, kMax, true>(cur, nxt, rows, txs, dps + out, args + out, L);
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---------------------------------------------------------------------------
// The tiled fused kernel
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;             // candidates per group: one 16-byte load of dp
constexpr int kTiledMaxGroups = 16;   // L - 1 <= 64 costs held in registers
// 224 threads: 2 blocks of up to 128 registers a thread fit an SM (4
// warps of 128 registers on each of its 4 register files)
constexpr int kTiledMaxThreads = 224;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block may opt into on sm_90

// Scenarios per tile: the count in [1, max(1, 224 / L)] whose (scenario, b)
// pairs fill the largest share of the block's warps, the larger on a tie.
int tile_scenarios(int L) {
  const int most = kTiledMaxThreads / L > 1 ? kTiledMaxThreads / L : 1;
  int best = 1;
  long long best_live = 0, best_lanes = 1;
  for (int st = 1; st <= most; ++st) {
    const long long live = static_cast<long long>(st) * L;
    const long long lanes = (live + 31) / 32 * 32;
    if (live * best_lanes >= best_live * lanes) {
      best = st;
      best_live = live;
      best_lanes = lanes;
    }
  }
  return best;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Entries of a staged cost column: the 4 * ceil((L-1)/4) candidates, then
// up to 3 or 7 more, so that a column spans 16 bytes modulo 32: the
// 16-byte loads of 8 threads on neighbouring columns (one shared-memory
// wavefront) then fall on 8 distinct 4-bank groups.
__host__ __device__ __forceinline__ int col_stride(int L, int elt) {
  int w = round4(L - 1);
  while (w * elt % 32 != 16) ++w;
  return w;
}

// Shared memory of a tiled block, in entries: the bank transposed into
// columns (B * L columns of col_stride entries: column (r, b) holds
// bank[r, a+1, b] at a, +inf past a = L-2), row 0 of every matrix, then
// the tile's two dp buffers (rows of round4(L) entries).
size_t tiled_smem_bytes(int B, int L, size_t elt) {
  const size_t cols = static_cast<size_t>(B) * L * col_stride(L, static_cast<int>(elt));
  const size_t row0 = (static_cast<size_t>(B) * L + 3) / 4 * 4;
  return (cols + row0 + 2 * static_cast<size_t>(tile_scenarios(L)) * round4(L)) * elt;
}

// The variant rule: the tiled kernel where its costs fit the registers
// and the staged bank the shared memory.
bool fused_tiled(int B, int L, size_t elt) {
  return B >= 1 && L >= 2 && (L - 1 + kGroup - 1) / kGroup <= kTiledMaxGroups &&
         tiled_smem_bytes(B, L, elt) <= kSmemLimit;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&d)[kGroup]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&d)[kGroup]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<double>(const double* p, double (&d)[kGroup]) {
  const double2 lo = *reinterpret_cast<const double2*>(p);
  const double2 hi = *reinterpret_cast<const double2*>(p + 2);
  d[0] = lo.x;
  d[1] = lo.y;
  d[2] = hi.x;
  d[3] = hi.y;
}

// A global load issued where it stands: the compiler may not sink it to
// its first use, so a load for the next tile overlaps the current one.
__device__ __forceinline__ int load_early(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ float load_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ double load_early(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

// One min instruction: a group's minimum only ranks groups (the output is
// a candidate formed again), so which zero it keeps does not matter.
__device__ __forceinline__ float lesser(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double lesser(double x, double y) { return fmin(x, y); }

// NG groups of 4 candidates cover a = 0..L-2 (NG = ceil((L-1) / 4)). The
// block holds tile_s scenarios, one thread per (scenario, b) pair.
template <typename T, bool kMax, int NG>
__global__ void __launch_bounds__(kTiledMaxThreads)
fused_dp_tiled_kernel(const T* __restrict__ bank,
                      const int* __restrict__ bank_idx,
                      const T* __restrict__ tx, const int* __restrict__ ns,
                      T* __restrict__ dp0, T* __restrict__ dps,
                      int* __restrict__ args, int S, int N, int L, int B,
                      int tile_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LL = L * L;
  const int LP = round4(L);
  const int W = col_stride(L, sizeof(T));
  T* cols = reinterpret_cast<T*>(smem);
  T* row0 = cols + B * L * W;
  T* rows = row0 + round4(B * L);
  // stage the bank once per block: read in its own order (coalesced),
  // written transposed; then the columns' +inf padding
  for (int i = threadIdx.x; i < B * LL; i += blockDim.x) {
    const int r = i / LL, a1 = (i - r * LL) / L, cb = i - r * LL - a1 * L;
    const T v = bank[i];
    if (a1 == 0) {
      row0[r * L + cb] = v;
    } else {
      cols[(r * L + cb) * W + a1 - 1] = v;
    }
  }
  const int pad = W - (L - 1);
  for (int i = threadIdx.x; i < B * L * pad; i += blockDim.x) {
    const int col = i / pad;
    cols[col * W + L - 1 + (i - col * pad)] = infinity<T>();
  }
  for (int i = threadIdx.x; i < 2 * tile_s * LP; i += blockDim.x) rows[i] = T(0);
  __syncthreads();

  const int sl = threadIdx.x / L;  // the thread's scenario in the tile
  const int b = threadIdx.x - sl * L;
  const int n_tiles = (S + tile_s - 1) / tile_s;
  // A tile's inputs (tx[s, b], ns[s], the rows of devices 1 and 2) are
  // loaded one tile ahead, and ns two tiles ahead, so device-memory
  // latency overlaps the tile before; the row of device 2 is loaded only
  // where ns[s] >= 2 (dead slots are never read).
  struct Inputs {
    T tb = T(0);
    int n = 0, r1 = 0, r2 = 0;
  };
  auto scenario = [&](int tile) { return static_cast<long long>(tile) * tile_s + sl; };
  auto in_range = [&](int tile) {
    return tile < n_tiles && sl < tile_s && scenario(tile) < S;
  };
  auto fetch = [&](int tile, int n) {
    Inputs in;
    if (in_range(tile)) {
      const long long sn = scenario(tile);
      in.n = n;
      in.tb = load_early(tx + sn * L + b);
      if (bank_idx != nullptr) {
        in.r1 = load_early(bank_idx + sn * N);
        if (n >= 2) in.r2 = load_early(bank_idx + sn * N + 1);
      } else {
        in.r2 = 1;
      }
    }
    return in;
  };
  const int first_tile = blockIdx.x;
  Inputs ahead = fetch(first_tile, in_range(first_tile) ? ns[scenario(first_tile)] : 0);
  int n_ahead2 = in_range(first_tile + gridDim.x)
                     ? load_early(ns + scenario(first_tile + gridDim.x)) : 0;
  for (int tile = first_tile; tile < n_tiles; tile += gridDim.x) {
    const long long s = scenario(tile);
    const bool live = sl < tile_s && s < S;
    T* cur = rows + sl * LP;
    T* nxt = cur + tile_s * LP;
    const Inputs in = ahead;
    ahead = fetch(tile + gridDim.x, n_ahead2);
    n_ahead2 = in_range(tile + 2 * gridDim.x)
                   ? load_early(ns + scenario(tile + 2 * gridDim.x)) : 0;
    const T tb = in.tb;
    const int n_s = in.n;
    int r_next = in.r2;
    if (live) {
      const T v = row0[in.r1 * L + b] + tb;  // C[s, 0, 0, b] built in T
      cur[b] = v;
      dp0[s * L + b] = v;
    }
    __syncthreads();
    T c[NG * kGroup];  // c[a] = bank[crow, a+1, b] + tb; +inf past a = L-2
    int crow = -1;
    const T* col = cols;  // column (crow, b): bank[crow, a+1, b] at a
    T* dps_s = dps + (s * (N - 1)) * L + b;  // step k's outputs at (k-2) * L
    int* args_s = args + (s * (N - 1)) * L + b;
    for (int k = 2; k <= N; ++k, dps_s += L, args_s += L) {
      if (live) {
        const int r = r_next;  // device k's row; dead slots are never read
        if (k < N && n_s >= k + 1) {
          r_next = bank_idx != nullptr ? load_early(bank_idx + s * N + k) : k;
        }
        T best;
        int arg = -1;
        if (n_s < k) {
          best = cur[b];  // frozen
        } else {
          if (r != crow) {
            col = cols + (r * L + b) * W;
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              T raw[kGroup];
              load4(col + g * kGroup, raw);
#pragma unroll
              for (int j = 0; j < kGroup; ++j) c[g * kGroup + j] = raw[j] + tb;
            }
            crow = r;
          }
          // two running (value, group) minima: even groups, odd groups
          T m0 = infinity<T>(), m1 = infinity<T>();
          int g0 = -1, g1 = -1;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            T v[kGroup];
            load4(cur + g * kGroup, v);  // dp[a], the same for the scenario's threads
#pragma unroll
            for (int j = 0; j < kGroup; ++j) v[j] = combine<T, kMax>(v[j], c[g * kGroup + j]);
            const T m = lesser(lesser(v[0], v[1]), lesser(v[2], v[3]));
            if (g % 2 == 0) {
              if (m < m0) {
                m0 = m;
                g0 = g;
              }
            } else if (m < m1) {
              m1 = m;
              g1 = g;
            }
          }
          const bool odd = m1 < m0 || (m1 == m0 && g1 < g0);
          const T mw = odd ? m1 : m0;
          const int gw = odd ? g1 : g0;  // -1: every candidate is +inf
          // the winning group again, from shared memory: its first
          // candidate equal to the minimum (padding is +inf, never equal)
          const int gr = gw < 0 ? 0 : gw;
          T d[kGroup], raw[kGroup];
          load4(cur + gr * kGroup, d);
          load4(col + gr * kGroup, raw);
          best = infinity<T>();
          int first = 0;
#pragma unroll
          for (int j = kGroup - 1; j >= 0; --j) {
            const T v = combine<T, kMax>(d[j], raw[j] + tb);
            if (gw >= 0 && v == mw) {
              best = v;
              first = gr * kGroup + j;
            }
          }
          arg = finite(best) ? first + 1 : -1;
        }
        nxt[b] = best;
        *dps_s = best;
        *args_s = arg;
      }
      __syncthreads();
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <typename T, bool kMax>
using TiledKernel = void (*)(const T*, const int*, const T*, const int*, T*, T*,
                             int*, int, int, int, int, int);

template <typename T, bool kMax, int NG = 1>
TiledKernel<T, kMax> tiled_kernel(int ng) {
  if constexpr (NG > kTiledMaxGroups) {
    return nullptr;
  } else {
    if (ng == NG) return &fused_dp_tiled_kernel<T, kMax, NG>;
    return tiled_kernel<T, kMax, NG + 1>(ng);
  }
}

int threads_for(int L) {
  const int warps = (L + 31) / 32;
  return warps * 32 < 256 ? warps * 32 : 256;
}

template <typename T, bool kMax>
cudaError_t launch_dense(const void* C, const void* ns, void* dp0, void* dps,
                         void* args, int S, int N, int L,
                         cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(T);
  dense_dp_kernel<T, kMax><<<S, threads_for(L), smem, stream>>>(
      static_cast<const T*>(C), static_cast<const int*>(ns),
      static_cast<T*>(dp0), static_cast<T*>(dps), static_cast<int*>(args), N,
      L);
  return cudaGetLastError();
}

template <typename T, bool kMax>
cudaError_t launch_fused(const void* bank, const void* bank_idx,
                         const void* tx, const void* ns, void* dp0, void* dps,
                         void* args, int S, int N, int L,
                         cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(T);
  fused_dp_kernel<T, kMax><<<S, threads_for(L), smem, stream>>>(
      static_cast<const T*>(bank), static_cast<const int*>(bank_idx),
      static_cast<const T*>(tx), static_cast<const int*>(ns),
      static_cast<T*>(dp0), static_cast<T*>(dps), static_cast<int*>(args), N,
      L);
  return cudaGetLastError();
}

template <typename T, bool kMax>
cudaError_t launch_fused_tiled(const void* bank, const void* bank_idx,
                               const void* tx, const void* ns, void* dp0,
                               void* dps, void* args, int S, int N, int L,
                               int B, cudaStream_t stream) {
  const TiledKernel<T, kMax> fn =
      tiled_kernel<T, kMax>((L - 1 + kGroup - 1) / kGroup);
  if (fn == nullptr) return cudaErrorInvalidValue;  // L - 1 > 64: not a tiled shape
  const int tile_s = tile_scenarios(L);
  const int threads = (tile_s * L + 31) / 32 * 32;
  const size_t smem = tiled_smem_bytes(B, L, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks: fill every SM once, each block walks its tiles
  const long long tiles = (static_cast<long long>(S) + tile_s - 1) / tile_s;
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(tiles < fill ? tiles : fill);
  fn<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(bank), static_cast<const int*>(bank_idx),
      static_cast<const T*>(tx), static_cast<const int*>(ns),
      static_cast<T*>(dp0), static_cast<T*>(dps), static_cast<int*>(args), S, N,
      L, B, tile_s);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer is a device
// pointer; `stream` is the caller's cudaStream_t. Each launcher returns
// cudaGetLastError() right after the launch (0 = launched).
extern "C" {

int split_dp_dense(const void* C, const void* ns, void* dp0, void* dps,
                   void* args, int S, int N, int L, int is_f64, int is_max,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return is_max ? launch_dense<double, true>(C, ns, dp0, dps, args, S, N, L, st)
                  : launch_dense<double, false>(C, ns, dp0, dps, args, S, N, L, st);
  }
  return is_max ? launch_dense<float, true>(C, ns, dp0, dps, args, S, N, L, st)
                : launch_dense<float, false>(C, ns, dp0, dps, args, S, N, L, st);
}

// The fused kernels' arguments: bank (B, L, L), bank_idx (S, N) or null
// (then B == N: the shared stack), tx (S, L), ns (S,); outputs dp0 (S, L),
// dps and args (S, N-1, L).
#define FUSED_ARGS bank, bank_idx, tx, ns, dp0, dps, args, S, N, L

// 1 when split_dp_fused runs the tiled kernel for a bank of B (L, L)
// matrices of float64 (is_f64) or float32; 0 for the first kernel.
int split_dp_fused_variant(int B, int L, int is_f64) {
  return fused_tiled(B, L, is_f64 ? sizeof(double) : sizeof(float)) ? 1 : 0;
}

// The same arguments as split_dp_fused; always the first kernel (one
// block per scenario).
int split_dp_fused_per_scenario(const void* bank, const void* bank_idx,
                                const void* tx, const void* ns, void* dp0,
                                void* dps, void* args, int S, int N, int L,
                                int B, int is_f64, int is_max, void* stream) {
  (void)B;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return is_max ? launch_fused<double, true>(FUSED_ARGS, st)
                  : launch_fused<double, false>(FUSED_ARGS, st);
  }
  return is_max ? launch_fused<float, true>(FUSED_ARGS, st)
                : launch_fused<float, false>(FUSED_ARGS, st);
}

// The kernel split_dp_fused_variant names.
int split_dp_fused(const void* bank, const void* bank_idx, const void* tx,
                   const void* ns, void* dp0, void* dps, void* args, int S,
                   int N, int L, int B, int is_f64, int is_max, void* stream) {
  if (!split_dp_fused_variant(B, L, is_f64)) {
    return split_dp_fused_per_scenario(FUSED_ARGS, B, is_f64, is_max, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return is_max ? launch_fused_tiled<double, true>(FUSED_ARGS, B, st)
                  : launch_fused_tiled<double, false>(FUSED_ARGS, B, st);
  }
  return is_max ? launch_fused_tiled<float, true>(FUSED_ARGS, B, st)
                : launch_fused_tiled<float, false>(FUSED_ARGS, B, st);
}

#undef FUSED_ARGS

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
