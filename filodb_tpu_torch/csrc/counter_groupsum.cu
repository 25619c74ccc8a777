// Fused counter group-sum: `sum/count by (g) (rate|increase|delta(c[w]))`
// over stride-permuted dense tiles, on Hopper (sm_90a).
//
// Replaces the Pallas kernel filodb_tpu/query/pallas_kernels.py
// counter_groupsum (body _groupsum_kernel). Same input and output contract:
//   v_p    [n_s, st, G_perm, 3*512] i32: plane 0 = relative timestamps (ms),
//          planes 1-2 = the per-series fixed-point hi/lo value split; row k
//          of series j of s-tile si sits at v_p[si, k % st, k / st, p*512+j]
//   base   [n_s, 8, 512] f32: row 0 = rebase midpoint, 1 = 2^(31-s), 2 = 2^-s
//   onehot [n_s*512, G] f32 group weights (zero rows for pad series)
//   -> sums, counts [T, G] f32.
//
// What bounds it on this card: device-memory bytes. Each step needs two or
// more boundary rows of 512 series x 12 B per s-tile and does a few dozen
// flops per element, far below the card's flop-per-byte balance.
//
// What the design does about it:
//   * neighbouring threads take neighbouring series, so every boundary row
//     is read as coalesced 2 KB runs per plane;
//   * a block owns one (s-tile, step-tile) pair and reads only the rows of
//     its own steps, once; the jitter fallback rows (kc0-1 / kl0+1) are read
//     only when the grid phase needs them (hi_mode / lo_mode);
//   * the per-series rates stay in shared memory: only [n_s, T, G] partial
//     group sums reach device memory, and a second, tiny pass sums them over
//     s-tiles in a fixed order, so reruns are bit-identical (no atomics).
// The group product is a plain f32 multiply-add loop (no tensor cores, no
// TF32). Built with --fmad=false so every product and sum rounds on its own,
// as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSS = 512;        // series per s-tile (the layout's lane tile)
constexpr int kTT = 8;          // query steps per block
constexpr int kThreads = 256;   // each thread owns two series of the s-tile

// boundary modes (1 = the nominal slot is always inside the window: no
// fallback row is read)
constexpr int kBoth = 0;        // jitter straddles the phase: select per element
constexpr int kAlt = 2;         // nominal slot always outside: use the neighbour

// funcs (1 = increase: a counter without the per-second scaling)
constexpr int kRate = 0;
constexpr int kDelta = 2;

struct Params {
  int n_s, st, g_perm, G, T;
  int dspan, hi_mode, lo_mode, func, exact_branch;
  int kl0, w0e_rel, window, step;
};

struct Row {
  int ts, hi, lo;
};

__device__ __forceinline__ Row load_row(const int32_t* __restrict__ v_p,
                                        const Params& p, int si, int k,
                                        int j) {
  const int r = k % p.st;
  const int g = k / p.st;
  const int32_t* row =
      v_p + ((static_cast<size_t>(si) * p.st + r) * p.g_perm + g) * (3 * kSS);
  Row out;
  out.ts = row[j];
  out.hi = row[kSS + j];
  out.lo = row[2 * kSS + j];
  return out;
}

// One (series, step) element of the f32 extrapolation epilogue; returns the
// rate (or NaN-free zero) and whether it counts.
__device__ __forceinline__ float element(const int32_t* __restrict__ v_p,
                                         const Params& p, int si, int j,
                                         int t, float b0, float c1, float c2,
                                         float* okf) {
  const int kc = p.kl0 + p.dspan * p.st + t * p.st;
  const int kl = p.kl0 + t * p.st;
  const Row rc = load_row(v_p, p, si, kc, j);
  const Row rl = load_row(v_p, p, si, kl, j);
  const int wend_r = p.w0e_rel + t * p.step;
  const int wstart_r = wend_r - p.window;

  Row r2 = rc;
  int overc = 0;
  if (p.hi_mode == kBoth) {
    const Row rp = load_row(v_p, p, si, kc - 1, j);
    const bool over = rc.ts > wend_r;
    overc = over ? 1 : 0;
    if (over) r2 = rp;
  } else if (p.hi_mode == kAlt) {
    overc = 1;
    r2 = load_row(v_p, p, si, kc - 1, j);
  }
  Row r1 = rl;
  int underc = 0;
  if (p.lo_mode == kBoth) {
    const Row rn = load_row(v_p, p, si, kl + 1, j);
    const bool under = rl.ts < wstart_r;
    underc = under ? 1 : 0;
    if (under) r1 = rn;
  } else if (p.lo_mode == kAlt) {
    underc = 1;
    r1 = load_row(v_p, p, si, kl + 1, j);
  }

  const int counts = (p.dspan * p.st + 1) - overc - underc;
  // exact integer boundary deltas; the f32 recombine rounds relative to
  // the delta
  const float dh = static_cast<float>(r2.hi - r1.hi);
  const float dl = static_cast<float>(r2.lo - r1.lo);
  const float delta = dh * c1 + dl * c2;
  const int sampled_i = r2.ts - r1.ts;
  const int dstart_i = r1.ts - wstart_r;
  const int dend_i = wend_r - r2.ts;
  const float sampled = static_cast<float>(sampled_i) * 1e-3f;
  float dstart = static_cast<float>(dstart_i) * 1e-3f;
  const float dend = static_cast<float>(dend_i) * 1e-3f;
  const float counts_f = static_cast<float>(counts);
  const float avg = sampled / (counts_f - 1.0f);
  const float th = avg * 1.1f;
  bool use_ds, use_de;
  if (p.exact_branch) {
    // every input is integer ms: decide "gap < 1.1 * avg interval" exactly
    // as 10*(cnt-1)*gap <= 11*sampled (the caller proved no i32 overflow)
    const int cm1 = counts - 1;
    const int s11 = 11 * sampled_i;
    use_ds = (10 * cm1) * dstart_i <= s11;
    use_de = (10 * cm1) * dend_i <= s11;
  } else {
    use_ds = dstart < th;
    use_de = dend < th;
  }
  if (p.func != kDelta) {
    // counter-zero limiter
    const float v1f =
        (static_cast<float>(r1.hi) * c1 + static_cast<float>(r1.lo) * c2) + b0;
    const float den = (delta == 0.0f) ? NAN : delta;
    const float dzero =
        (delta > 0.0f && v1f >= 0.0f) ? sampled * (v1f / den) : INFINITY;
    const bool zlt = dzero < dstart;
    dstart = zlt ? dzero : dstart;
    use_ds = (zlt && (dzero < th)) || (!zlt && use_ds);
  }
  const float extrap = sampled + (use_ds ? dstart : avg * 0.5f) +
                       (use_de ? dend : avg * 0.5f);
  float factor = extrap / sampled;
  if (p.func == kRate) factor = factor / (static_cast<float>(p.window) * 1e-3f);
  const float out = delta * factor;
  const bool ok = counts >= 2 && !isnan(out);
  *okf = ok ? 1.0f : 0.0f;
  return ok ? out : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    groupsum_partial_kernel(const int32_t* __restrict__ v_p,
                            const float* __restrict__ base,
                            const float* __restrict__ onehot,
                            float* __restrict__ part_sum,
                            float* __restrict__ part_cnt, Params p) {
  __shared__ float sh_loc[kTT][kSS];
  __shared__ float sh_ok[kTT][kSS];
  const int si = blockIdx.y;
  const int t0 = blockIdx.x * kTT;
  const float* brow = base + static_cast<size_t>(si) * 8 * kSS;

  for (int j = threadIdx.x; j < kSS; j += blockDim.x) {
    const float b0 = brow[j];
    const float c1 = brow[kSS + j];
    const float c2 = brow[2 * kSS + j];
    for (int tt = 0; tt < kTT; ++tt) {
      const int t = t0 + tt;
      float loc = 0.0f, okf = 0.0f;
      if (t < p.T) loc = element(v_p, p, si, j, t, b0, c1, c2, &okf);
      sh_loc[tt][j] = loc;
      sh_ok[tt][j] = okf;
    }
  }
  __syncthreads();

  // group product in true f32, series in a fixed order
  const float* oh = onehot + static_cast<size_t>(si) * kSS * p.G;
  for (int o = threadIdx.x; o < kTT * p.G; o += blockDim.x) {
    const int tt = o / p.G;
    const int g = o - tt * p.G;
    const int t = t0 + tt;
    if (t >= p.T) continue;
    float s = 0.0f, c = 0.0f;
    for (int j = 0; j < kSS; ++j) {
      const float w = oh[static_cast<size_t>(j) * p.G + g];
      s = s + sh_loc[tt][j] * w;
      c = c + sh_ok[tt][j] * w;
    }
    const size_t off = (static_cast<size_t>(si) * p.T + t) * p.G + g;
    part_sum[off] = s;
    part_cnt[off] = c;
  }
}

// Second pass: [n_s, T*G] partials -> [T*G], summed over s-tiles in order.
__global__ void groupsum_reduce_kernel(const float* __restrict__ part_sum,
                                       const float* __restrict__ part_cnt,
                                       float* __restrict__ sums,
                                       float* __restrict__ cnts, int n_s,
                                       int tg) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= tg) return;
  float s = 0.0f, c = 0.0f;
  for (int si = 0; si < n_s; ++si) {
    s = s + part_sum[static_cast<size_t>(si) * tg + o];
    c = c + part_cnt[static_cast<size_t>(si) * tg + o];
  }
  sums[o] = s;
  cnts[o] = c;
}

}  // namespace

extern "C" int counter_groupsum_launch(
    const int32_t* v_p, const float* base, const float* onehot,
    float* part_sum, float* part_cnt, float* sums, float* cnts, int n_s,
    int st, int g_perm, int G, int T, int dspan, int hi_mode, int lo_mode,
    int func, int exact_branch, int kl0, int w0e_rel, int window, int step,
    void* stream) {
  Params p;
  p.n_s = n_s;
  p.st = st;
  p.g_perm = g_perm;
  p.G = G;
  p.T = T;
  p.dspan = dspan;
  p.hi_mode = hi_mode;
  p.lo_mode = lo_mode;
  p.func = func;
  p.exact_branch = exact_branch;
  p.kl0 = kl0;
  p.w0e_rel = w0e_rel;
  p.window = window;
  p.step = step;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + kTT - 1) / kTT, n_s);
  groupsum_partial_kernel<<<grid, kThreads, 0, s>>>(v_p, base, onehot,
                                                    part_sum, part_cnt, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tg = T * G;
  groupsum_reduce_kernel<<<(tg + 255) / 256, 256, 0, s>>>(
      part_sum, part_cnt, sums, cnts, n_s, tg);
  return static_cast<int>(cudaGetLastError());
}
