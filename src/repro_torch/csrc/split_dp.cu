// Exact split DP on Hopper (sm_90a): the dense and fused kernels.
//
// Replaces the two Pallas TPU kernels of src/repro/core/pallas_dp.py:
//   dense_dp_kernel <- _dense_kernel (pallas_call at pallas_dp.py:218)
//   fused_dp_kernel <- _fused_kernel (pallas_call at pallas_dp.py:246)
//
// Recurrence, for scenario s, device step k = 2..N and boundary b:
//   new[b] = min over a = 0..L-2 of dp[a] (+ or max) C[s, k-1, a+1, b]
//   arg[b] = first argmin + 1, or -1 where new[b] is not finite
// A row whose fleet is complete (ns[s] < k) is frozen: its dp carries
// over and its args are -1. The fused kernel builds
//   C[s, k-1, a+1, b] = bank[row(s, k), a+1, b] + tx[s, b]
// in T inside the reduction (f32(local) + f32(tx), the reference's fused
// arithmetic), so the (S, N, L, L) tensor never exists; row(s, k) is
// bank_idx[s, k-1], or k-1 when bank_idx is null (one shared stack).
//
// What bounds them on an H100 SXM (3.35 TB/s HBM3; 67 TFLOP/s fp32 off
// the tensor cores counts an FMA as two, so adds and compares issue at
// 33.5 T/s), at S = 16,384, N = 5, L = 54 in f32, every row live:
//   dense: reading the part of C the recurrence uses (C[s,0,0,:] and rows
//          1..L-1 of C[s,1:N]), 754 MB of its 955 MB, plus 32 MB of
//          outputs: ~0.23 ms. The design reads each of those rows once,
//          coalesced along b (neighbouring threads on neighbouring
//          addresses), and keeps the running dp row in shared memory, so
//          C is the only large device-memory stream.
//   fused: its arithmetic, ~0.19 G candidates of add, add, compare
//          (~17 us), over writing dp0/dps/args and reading tx, ~36 MB
//          (~11 us). The bank (a few (L, L) matrices, 12 KB each) stays
//          in L1/L2, so device memory sees tx once and the outputs once.
// Design, simple first: one block per scenario, threads over b (striding
// when L > blockDim), the dp row double-buffered in shared memory, the
// k loop inside the block. Each thread scans a = 0..L-2 in order with a
// strict `<`: the first-minimum argmin that torch.min(dim), numpy and
// jnp.argmin share. A later version that splits the a-reduction across
// threads must compare (value, index) pairs to keep it.
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
        const T d = cur[a];
        const T v = kMax ? (c > d ? c : d) : d + c;
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

int split_dp_fused(const void* bank, const void* bank_idx, const void* tx,
                   const void* ns, void* dp0, void* dps, void* args, int S,
                   int N, int L, int is_f64, int is_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return is_max ? launch_fused<double, true>(bank, bank_idx, tx, ns, dp0, dps, args, S, N, L, st)
                  : launch_fused<double, false>(bank, bank_idx, tx, ns, dp0, dps, args, S, N, L, st);
  }
  return is_max ? launch_fused<float, true>(bank, bank_idx, tx, ns, dp0, dps, args, S, N, L, st)
                : launch_fused<float, false>(bank, bank_idx, tx, ns, dp0, dps, args, S, N, L, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
