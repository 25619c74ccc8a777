// Window boundary extract for irregular series, on Hopper (sm_90a).
//
// Replaces the Pallas kernel filodb_tpu/query/pallas_kernels.py
// window_extract (body _extract_kernel). Same contract:
//   tr  [S, N] i32 sorted sample times relative to the first window start
//       (pad = INT32_MAX), pay [S, C, N] f32 payload channels;
//   windows wstart_t = t*step, wend_t = wstart_t + window, t < T;
//   -> cnt, t_lo, t_hi [S, T] i32 and pay_lo, pay_hi [S, C, T] f32: the
//      in-window sample count, the first and last in-window timestamps and
//      the payload at those two samples; zeros where the window is empty.
//
// The TPU kernel builds [rows, windows, N] comparison masks (O(S*T*N) work)
// because a search serialises there. Here each thread binary-searches its
// window: lo = first index with tr >= wstart, hi = last index with
// tr <= wend, cnt = max(hi - lo + 1, 0). With duplicate timestamps that is
// the first duplicate for lo and the last for hi, as the mask form gives.
// Payloads gain +0.0f so a -0.0 sample reads back as the mask sum's +0.0.
//
// What bounds it on this card: device-memory bytes (each row's timestamps
// once, the boundary payloads, and the S*T*(3*4 + 2*C*4) bytes of output);
// the search itself is log2(N) shared-memory reads per window.
//
// What the design does about it: one block per series row stages the row's
// timestamps in shared memory with coalesced loads (rows too long for 48 KB
// are searched in place, through L1); threads take consecutive windows, so
// every output row is written as one coalesced run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemRowMax = 12288;   // 48 KB of i32 timestamps

__device__ __forceinline__ int lower_bound(const int32_t* row, int n,
                                           long long x) {
  int l = 0, h = n;
  while (l < h) {
    const int m = (l + h) >> 1;
    if (static_cast<long long>(row[m]) < x) l = m + 1; else h = m;
  }
  return l;
}

__device__ __forceinline__ int upper_bound(const int32_t* row, int n,
                                           long long x) {
  int l = 0, h = n;
  while (l < h) {
    const int m = (l + h) >> 1;
    if (static_cast<long long>(row[m]) <= x) l = m + 1; else h = m;
  }
  return l;
}

__global__ void window_extract_kernel(
    const int32_t* __restrict__ tr, const float* __restrict__ pay,
    int32_t* __restrict__ cnt, int32_t* __restrict__ tlo,
    int32_t* __restrict__ thi, float* __restrict__ plo,
    float* __restrict__ phi, int N, int C, int T, long long step,
    long long window) {
  extern __shared__ int32_t sh_row[];
  const int s = blockIdx.x;
  const int32_t* row = tr + static_cast<size_t>(s) * N;
  if (N <= kSmemRowMax) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) sh_row[i] = row[i];
    __syncthreads();
    row = sh_row;
  }
  const float* prow = pay + static_cast<size_t>(s) * C * N;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const long long ws = static_cast<long long>(t) * step;
    const long long we = ws + window;
    const int lo = lower_bound(row, N, ws);
    const int hi = upper_bound(row, N, we) - 1;
    const int c = hi >= lo ? hi - lo + 1 : 0;
    const size_t o = static_cast<size_t>(s) * T + t;
    cnt[o] = c;
    tlo[o] = c ? row[lo] : 0;
    thi[o] = c ? row[hi] : 0;
    for (int ch = 0; ch < C; ++ch) {
      const size_t po = (static_cast<size_t>(s) * C + ch) * T + t;
      const float* pc = prow + static_cast<size_t>(ch) * N;
      plo[po] = c ? pc[lo] + 0.0f : 0.0f;
      phi[po] = c ? pc[hi] + 0.0f : 0.0f;
    }
  }
}

constexpr int kThreadsMax = 256;

// One launch: a block per row, a thread per window (whole warps, at most
// kThreadsMax), the row's timestamps in shared memory when they fit.
struct Geometry {
  int threads;
  size_t smem;
};

Geometry plan_launch(int N, int T) {
  Geometry g;
  g.threads = ((T + 31) / 32) * 32;
  if (g.threads > kThreadsMax) g.threads = kThreadsMax;
  if (g.threads < 32) g.threads = 32;
  g.smem = N <= kSmemRowMax ? static_cast<size_t>(N) * 4 : 0;
  return g;
}

}  // namespace

extern "C" int window_extract_launch(const int32_t* tr, const float* pay,
                                     int32_t* cnt, int32_t* tlo,
                                     int32_t* thi, float* plo, float* phi,
                                     int S, int N, int C, int T,
                                     long long step, long long window,
                                     void* stream) {
  const Geometry g = plan_launch(N, T);
  window_extract_kernel<<<S, g.threads, g.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      tr, pay, cnt, tlo, thi, plo, phi, N, C, T, step, window);
  return static_cast<int>(cudaGetLastError());
}

// What window_extract_launch launches for these shapes, without
// launching: out = {grid x, y, z, threads, dynamic shared bytes}.
extern "C" int window_extract_geometry(int S, int N, int T, int* out) {
  const Geometry g = plan_launch(N, T);
  out[0] = S;
  out[1] = 1;
  out[2] = 1;
  out[3] = g.threads;
  out[4] = static_cast<int>(g.smem);
  return 0;
}

// The kernel as the card loaded it (cudaFuncGetAttributes): its name, and
// out = {registers, static shared bytes, the most threads a block may
// take}. -1 past the one instance, else a cudaError_t.
extern "C" int window_extract_attrs(int i, const char** name, int* out) {
  if (i != 0) return -1;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, reinterpret_cast<const void*>(window_extract_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *name = "window_extract_kernel";
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  return 0;
}
