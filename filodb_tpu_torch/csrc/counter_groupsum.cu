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
// What bounds it on this card: device-memory bytes. Each step needs two to
// four boundary rows of 512 series x 12 B (6 KB) per s-tile; an element
// costs about 150 instructions and the group product 4*G flops a series,
// below the card's flop-per-byte balance but not by much: at G = 16 the
// consumer warps are busy for most of the time the rows take to arrive.
//
// What the design does about it:
//   * a block owns one s-tile and a chunk of consecutive steps (the chunk
//     length is the wrapper's rule, groupsum_launch_plan: the fewest chunks
//     per s-tile that fill the SMs' last wave to 90 %); one block per SM;
//   * one producer thread streams each step's rows (kc, kl, and kc-1 / kl+1
//     only when hi_mode / lo_mode reads them) with 1-D bulk copies
//     (cp.async.bulk, 6 KB a row) into a ring of up to 8 stages in shared
//     memory, each stage completing on an mbarrier. Row k + st follows row
//     k in its residue plane, so each family's source just advances a row a
//     step. The 16 consumer warps (one thread per series) wait only on those
//     barriers, copy the step's samples to registers and hand the stage
//     back at once (a second mbarrier), so later steps' rows stay in flight
//     while earlier steps compute, the group product included;
//   * kc and kl rows share one run of the residue plane (step t's kc row is
//     step t+dspan's kl row). Holding dspan+1+stages rows of that run does
//     not fit at GS_DSPAN_MAX = 48 (6 KB x 57 > 227 KB), so kl is streamed
//     as a second run: its rows were fetched as kc rows dspan steps before,
//     and L2 can serve them while dspan steps of every SM's rows fit in its
//     50 MB (132 SMs x 18 KB a step: up to dspan ~ 20 by that count, not
//     measured); at larger dspan kl comes from device memory again, up to a
//     third more bytes;
//   * each thread computes two steps' elements at once, and the kernel is
//     compiled per func and extrapolation-branch rule, so that the two
//     independent epilogues interleave;
//   * the group product of a batch of 8 steps is a [16 x 512] x [512 x G]
//     f32 product (8 rate rows, 8 ok rows) on CUDA cores: each warp takes
//     the 32 series it computed, from a private shared-memory tile, with
//     register tiles of 2 rows x up to 4 groups a lane; the 16 warp
//     partials are then added in shared memory. The s-tile's weights are
//     staged in shared memory once per block when G <= 16, and batches
//     alternate between two partial-product buffers (one barrier a batch).
//     A larger G re-stages 16 groups at a time for every batch: 32 KB a
//     chunk from L2 or device memory;
//   * the per-series rates stay on chip: only [n_s, T, G] partial group
//     sums reach device memory (2 x n_s x T x G x 4 B written and read
//     again: 7.7 MB at n_s = 128, T = 470, G = 16), and a second, tiny pass
//     sums them over s-tiles in a fixed order (no atomics).
//
// Numbers: each element's rate and ok flag is computed op for op as in the
// plain version, built with --fmad=false so every product and sum rounds on
// its own. The group product runs in f32 (no TF32, no tensor cores), in
// this order: for each (step, group) of an s-tile, warp w sums the products
// of series 32w .. 32w+31 in ascending order; the 16 warp sums are added in
// ascending w; the second pass adds the s-tiles' sums in ascending order.
// Every order is fixed, so reruns are bit-identical.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSS = 512;                    // series per s-tile
constexpr int kRowWords = 3 * kSS;          // one boundary row: ts, hi, lo
constexpr int kRowBytes = kRowWords * 4;    // 6,144
constexpr int kTT = 8;                      // steps per group-product batch
constexpr int kGC = 16;                     // groups staged at a time
constexpr int kConsumerWarps = kSS / 32;    // one consumer thread per series
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kStagesMax = 8;
constexpr int kSmemMax = 232448;            // a block's shared memory on sm_90

// boundary modes: the jitter straddles the phase (select per element), the
// nominal slot is always inside the window, or always outside (neighbour)
constexpr int kBoth = 0;
constexpr int kCur = 1;
constexpr int kAlt = 2;

// funcs (1 = increase: a counter without the per-second scaling)
constexpr int kRate = 0;
constexpr int kDelta = 2;

struct Params {
  int st, g_perm, G, T;
  int dspan, hi_mode, lo_mode;
  int kl0, w0e_rel, window, step;
  int chunk, stages, fams, cw, nbuf;
};

struct Row {
  int ts, hi, lo;
};

// The group product of one batch is a [kM, 512] x [512, gw] f32 product:
// rows 0-7 are the batch's rates, rows 8-15 its ok flags, and each warp
// takes the k = 32 series it computed. A warp keeps its slice in a private
// [32][kAS] tile (stride 18: the stores hit each bank at most twice, the
// row-pair loads are 8-byte aligned broadcasts).
constexpr int kM = 2 * kTT;
constexpr int kAS = kM + 2;
constexpr int kAWarp = 32 * kAS;

// Dynamic shared memory: the ring [stages][fams][3*512] i32, the warps'
// tiles [16][32][kAS] f32, nbuf buffers of their partial products
// [16][kM][gw] f32 (two when all groups fit one staged chunk: batch b+1's
// products go to the other buffer while batch b's are summed), the staged
// weights [512][gw] f32 (gw = 4*cw groups, zero-padded), then the full and
// empty mbarriers.
struct Layout {
  int a, part, w, bar, total;
};

__host__ __device__ inline Layout layout(int stages, int fams, int cw,
                                         int nbuf) {
  Layout l;
  const int gw = 4 * cw;
  l.a = stages * fams * kRowBytes;
  l.part = l.a + kConsumerWarps * kAWarp * 4;
  l.w = l.part + nbuf * kConsumerWarps * kM * gw * 4;
  l.bar = l.w + kSS * gw * 4;
  l.total = l.bar + 2 * stages * 8;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one 6 KB boundary row, device memory -> shared memory, completing on bar
__device__ __forceinline__ void bulk_row(int32_t* dst, const int32_t* src,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(kRowBytes), "r"(smem_addr(bar))
      : "memory");
}

// barrier of the consumer warps only (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ const int32_t* row_ptr(
    const int32_t* __restrict__ v_p, const Params& p, int si, int k) {
  const int r = k % p.st;
  const int g = k / p.st;
  return v_p + ((static_cast<size_t>(si) * p.st + r) * p.g_perm + g) *
                   kRowWords;
}

__device__ __forceinline__ Row read_row(const int32_t* row, int j) {
  Row out;
  out.ts = row[j];
  out.hi = row[kSS + j];
  out.lo = row[2 * kSS + j];
  return out;
}

// Series j's boundary samples of one step, read from the step's staged rows
// [kc, kl, kc-1 (hi_mode != CUR), kl+1 (lo_mode != CUR)].
struct Rows {
  Row c, l, p, n;
};

__device__ __forceinline__ Rows load_rows(const int32_t* slot,
                                          const Params& p, int j) {
  Rows r;
  r.c = read_row(slot, j);
  r.l = read_row(slot + kRowWords, j);
  const int32_t* next = slot + 2 * kRowWords;
  if (p.hi_mode != kCur) {
    r.p = read_row(next, j);
    next += kRowWords;
  }
  if (p.lo_mode != kCur) r.n = read_row(next, j);
  return r;
}

// One (series, step) element of the f32 extrapolation epilogue; returns the
// rate (or zero) and whether it counts. FUNC and EXACT (the integer
// extrapolation-branch rule) are compile-time, so that the two elements a
// thread computes at once interleave.
template <int FUNC, bool EXACT>
__device__ __forceinline__ float element(const Rows& rows, const Params& p,
                                         int t, float b0, float c1, float c2,
                                         float* okf) {
  const Row rc = rows.c;
  const Row rl = rows.l;
  const int wend_r = p.w0e_rel + t * p.step;
  const int wstart_r = wend_r - p.window;

  Row r2 = rc;
  int overc = 0;
  if (p.hi_mode == kBoth) {
    const Row rp = rows.p;
    const bool over = rc.ts > wend_r;
    overc = over ? 1 : 0;
    if (over) r2 = rp;
  } else if (p.hi_mode == kAlt) {
    overc = 1;
    r2 = rows.p;
  }
  Row r1 = rl;
  int underc = 0;
  if (p.lo_mode == kBoth) {
    const Row rn = rows.n;
    const bool under = rl.ts < wstart_r;
    underc = under ? 1 : 0;
    if (under) r1 = rn;
  } else if (p.lo_mode == kAlt) {
    underc = 1;
    r1 = rows.n;
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
  if (EXACT) {
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
  if (FUNC != kDelta) {
    // counter-zero limiter
    const float v1f =
        (static_cast<float>(r1.hi) * c1 + static_cast<float>(r1.lo) * c2) + b0;
    const float den = (delta == 0.0f) ? NAN : delta;
    const float dq = sampled * (v1f / den);
    const float dzero = (delta > 0.0f && v1f >= 0.0f) ? dq : INFINITY;
    const bool zlt = dzero < dstart;
    dstart = zlt ? dzero : dstart;
    use_ds = (zlt && (dzero < th)) || (!zlt && use_ds);
  }
  const float extrap = sampled + (use_ds ? dstart : avg * 0.5f) +
                       (use_de ? dend : avg * 0.5f);
  float factor = extrap / sampled;
  if (FUNC == kRate) factor = factor / (static_cast<float>(p.window) * 1e-3f);
  const float out = delta * factor;
  const bool ok = counts >= 2 && !isnan(out);
  *okf = ok ? 1.0f : 0.0f;
  return ok ? out : 0.0f;
}

// weights of groups [g0, g0+gc) of the s-tile -> wsh[j*gw + g], zero for
// g >= gc
__device__ __forceinline__ void stage_weights(float* wsh,
                                              const float* __restrict__ oh,
                                              const Params& p, int g0,
                                              int gc) {
  const int gw = 4 * p.cw;
  for (int e = threadIdx.x; e < kSS * gw; e += kConsumers) {
    const int j = e / gw;
    const int g = e - j * gw;
    wsh[e] = g < gc ? oh[static_cast<size_t>(j) * p.G + g0 + g] : 0.0f;
  }
}

// This warp's [kM, gw] partial product over its 32 series (see the order
// above): lane (mi, gq) holds rows 2mi, 2mi+1 and groups gq*CW .. +CW-1.
template <int CW>
__device__ __forceinline__ void warp_product(const float* aw,
                                             const float* wsh, float* pw,
                                             int warp, int lane) {
  constexpr int gw = 4 * CW;
  const int mi = lane >> 2;
  const int gq = lane & 3;
  float acc[2][CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    acc[0][c] = 0.0f;
    acc[1][c] = 0.0f;
  }
  const float* wrow = wsh + (warp * 32) * gw + gq * CW;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const float2 a = *reinterpret_cast<const float2*>(aw + k * kAS + 2 * mi);
    float w[CW];
    if constexpr (CW >= 4) {
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(wrow + k * gw)[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    } else if constexpr (CW == 2) {
      const float2 v = *reinterpret_cast<const float2*>(wrow + k * gw);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = wrow[k * gw];
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      acc[0][c] = acc[0][c] + a.x * w[c];
      acc[1][c] = acc[1][c] + a.y * w[c];
    }
  }
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    pw[(2 * mi) * gw + gq * CW + c] = acc[0][c];
    pw[(2 * mi + 1) * gw + gq * CW + c] = acc[1][c];
  }
}

// The batch's group sums for groups [g0, g0+gc): every warp's partial
// product, then the 16 warp partials added in ascending warp order.
__device__ __forceinline__ void group_product(
    const float* abuf, const float* wsh, float* part, const Params& p,
    int si, int tb, int nt, int g0, int gc, int warp, int lane,
    float* __restrict__ part_sum, float* __restrict__ part_cnt) {
  const int gw = 4 * p.cw;
  const float* aw = abuf + warp * kAWarp;
  float* pw = part + warp * kM * gw;
  switch (p.cw) {
    case 1: warp_product<1>(aw, wsh, pw, warp, lane); break;
    case 2: warp_product<2>(aw, wsh, pw, warp, lane); break;
    case 4: warp_product<4>(aw, wsh, pw, warp, lane); break;
    default: warp_product<8>(aw, wsh, pw, warp, lane); break;
  }
  consumer_sync();
  for (int o = threadIdx.x; o < kM * gc; o += kConsumers) {
    const int r = o / gc;
    const int g = o - r * gc;
    float s = 0.0f;
    for (int w = 0; w < kConsumerWarps; ++w)
      s = s + part[(w * kM + r) * gw + g];
    const int tt = r < kTT ? r : r - kTT;
    if (tt < nt) {
      float* out = r < kTT ? part_sum : part_cnt;
      out[(static_cast<size_t>(si) * p.T + tb + tt) * p.G + g0 + g] = s;
    }
  }
}

template <int FUNC, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    groupsum_partial_kernel(const int32_t* __restrict__ v_p,
                            const float* __restrict__ base,
                            const float* __restrict__ onehot,
                            float* __restrict__ part_sum,
                            float* __restrict__ part_cnt, Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.stages, p.fams, p.cw, p.nbuf);
  int32_t* ring = reinterpret_cast<int32_t*>(smem);
  float* abuf = reinterpret_cast<float*>(smem + L.a);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* wsh = reinterpret_cast<float*>(smem + L.w);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + p.stages;

  const int si = blockIdx.y;
  const int t0 = blockIdx.x * p.chunk;
  const int n = min(p.T - t0, p.chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot_words = p.fams * kRowWords;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread keeps up to `stages` steps' rows in flight. Row
    // k + st lies right after row k in its residue plane, so each family's
    // source advances by one row a step.
    if (lane == 0) {
      const int kc = p.kl0 + p.dspan * p.st + t0 * p.st;
      const int kl = p.kl0 + t0 * p.st;
      const int32_t* next = row_ptr(v_p, p, si, kl + 1);
      const int32_t* src[4] = {
          row_ptr(v_p, p, si, kc), row_ptr(v_p, p, si, kl),
          p.hi_mode != kCur ? row_ptr(v_p, p, si, kc - 1) : next, next};
      int s = 0, phase = 0;
      for (int i = 0; i < n; ++i) {
        if (i >= p.stages) mbar_wait(&empty[s], phase ^ 1);
        int32_t* dst = ring + s * slot_words;
        mbar_expect_tx(&full[s], p.fams * kRowBytes);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < p.fams) {
            bulk_row(dst + q * kRowWords, src[q], &full[s]);
            src[q] += kRowWords;
          }
        }
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: thread j owns series j of the s-tile
  const int j = threadIdx.x;
  const float* brow = base + static_cast<size_t>(si) * 8 * kSS;
  const float b0 = brow[j];
  const float c1 = brow[kSS + j];
  const float c2 = brow[2 * kSS + j];
  const float* oh = onehot + static_cast<size_t>(si) * kSS * p.G;
  const int n_gc = (p.G + kGC - 1) / kGC;
  if (n_gc == 1) stage_weights(wsh, oh, p, 0, p.G);
  float* aw = abuf + warp * kAWarp;
  int cs = 0, cphase = 0;    // the ring stage of the next step, its phase

  for (int bt = 0; bt < n; bt += kTT) {
    const int nt = min(kTT, n - bt);
    // two steps at a time: both steps' samples go to registers and their
    // stages back to the producer before the two (independent) epilogues
#pragma unroll 1
    for (int tt = 0; tt < kTT; tt += 2) {
      Rows r[2];
      int s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u] = cs;
        if (tt + u < nt) {
          mbar_wait(&full[cs], cphase);
          r[u] = load_rows(ring + cs * slot_words, p, j);
          if (++cs == p.stages) {
            cs = 0;
            cphase ^= 1;
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (lane == 0 && tt + u < nt) mbar_arrive(&empty[s[u]]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float loc = 0.0f, okf = 0.0f;
        if (tt + u < nt)
          loc = element<FUNC, EXACT>(r[u], p, t0 + bt + tt + u, b0, c1, c2,
                                     &okf);
        aw[lane * kAS + tt + u] = loc;
        aw[lane * kAS + kTT + tt + u] = okf;
      }
    }
    // the weights and the partial products are shared. With one chunk of
    // groups, the weights are staged once and batches alternate between two
    // partial-product buffers: the barrier inside group_product also tells
    // that the last batch's sums are done. Chunks of groups re-stage the
    // weights and wait for every consumer before each reuse.
    float* pb = part + (p.nbuf == 2 ? (bt / kTT) & 1 : 0) *
                           (kConsumerWarps * kM * 4 * p.cw);
    for (int c = 0; c < n_gc; ++c) {
      const int g0 = c * kGC;
      const int gc = min(kGC, p.G - g0);
      if (n_gc > 1) {
        stage_weights(wsh, oh, p, g0, gc);
        consumer_sync();
      } else {
        __syncwarp();
        if (bt == 0) consumer_sync();
      }
      group_product(abuf, wsh, pb, p, si, t0 + bt, nt, g0, gc, warp, lane,
                    part_sum, part_cnt);
      if (n_gc > 1) consumer_sync();
    }
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

template <int FUNC, bool EXACT>
cudaError_t launch_partial(dim3 grid, int smem, cudaStream_t s,
                           const int32_t* v_p, const float* base,
                           const float* onehot, float* part_sum,
                           float* part_cnt, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      groupsum_partial_kernel<FUNC, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  groupsum_partial_kernel<FUNC, EXACT><<<grid, kThreads, smem, s>>>(
      v_p, base, onehot, part_sum, part_cnt, p);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(dim3, int, cudaStream_t, const int32_t*,
                                 const float*, const float*, float*, float*,
                                 const Params&);
constexpr LaunchFn kLaunch[3][2] = {
    {launch_partial<0, false>, launch_partial<0, true>},
    {launch_partial<1, false>, launch_partial<1, true>},
    {launch_partial<2, false>, launch_partial<2, true>}};

constexpr int kReduceThreads = 256;

// The two launches of one call.
struct Geometry {
  dim3 part_grid;
  int part_smem;
  dim3 reduce_grid;
};

// Sets the fields of p that follow from G, the modes, chunk and stages,
// and the call's launches: the partial kernel over (ceil(T / chunk), n_s)
// blocks of kThreads with layout().total dynamic shared bytes, then the
// reduction over the T*G outputs. false when the plan lies outside the
// kernel's range.
bool plan_launches(int n_s, int G, int T, int hi_mode, int lo_mode,
                   int chunk, int stages, Params& p, Geometry& g) {
  p.G = G;
  p.T = T;
  p.hi_mode = hi_mode;
  p.lo_mode = lo_mode;
  p.chunk = chunk;
  p.stages = stages;
  p.fams = 2 + (hi_mode != kCur) + (lo_mode != kCur);
  p.cw = 1;
  while (4 * p.cw < (G < kGC ? G : kGC)) p.cw *= 2;
  p.nbuf = G <= kGC ? 2 : 1;
  const Layout L = layout(stages, p.fams, p.cw, p.nbuf);
  g.part_grid = chunk >= 1 ? dim3((T + chunk - 1) / chunk, n_s) : dim3(0);
  g.part_smem = L.total;
  g.reduce_grid = dim3((T * G + kReduceThreads - 1) / kReduceThreads);
  return chunk >= 1 && stages >= 1 && stages <= kStagesMax &&
         L.total <= kSmemMax;
}

}  // namespace

// chunk and stages come from the wrapper's groupsum_launch_plan; the
// launches are plan_launches'.
extern "C" int counter_groupsum_launch(
    const int32_t* v_p, const float* base, const float* onehot,
    float* part_sum, float* part_cnt, float* sums, float* cnts, int n_s,
    int st, int g_perm, int G, int T, int dspan, int hi_mode, int lo_mode,
    int func, int exact_branch, int kl0, int w0e_rel, int window, int step,
    int chunk, int stages, void* stream) {
  Params p;
  p.st = st;
  p.g_perm = g_perm;
  p.dspan = dspan;
  p.kl0 = kl0;
  p.w0e_rel = w0e_rel;
  p.window = window;
  p.step = step;
  Geometry g;
  if (!plan_launches(n_s, G, T, hi_mode, lo_mode, chunk, stages, p, g) ||
      func < 0 || func > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = kLaunch[func][exact_branch ? 1 : 0](
      g.part_grid, g.part_smem, s, v_p, base, onehot, part_sum, part_cnt,
      p);
  if (err != cudaSuccess) return static_cast<int>(err);
  groupsum_reduce_kernel<<<g.reduce_grid, kReduceThreads, 0, s>>>(
      part_sum, part_cnt, sums, cnts, n_s, T * G);
  return static_cast<int>(cudaGetLastError());
}

// What counter_groupsum_launch launches for these arguments, without
// launching: out = {grid x, y, z, threads, dynamic shared bytes} of the
// partial kernel, then of the reduction. cudaErrorInvalidValue where the
// launcher refuses the plan.
extern "C" int counter_groupsum_geometry(int n_s, int G, int T,
                                         int hi_mode, int lo_mode,
                                         int chunk, int stages, int* out) {
  Params p;
  Geometry g;
  if (!plan_launches(n_s, G, T, hi_mode, lo_mode, chunk, stages, p, g))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v[10] = {static_cast<int>(g.part_grid.x),
                     static_cast<int>(g.part_grid.y),
                     static_cast<int>(g.part_grid.z), kThreads,
                     g.part_smem,
                     static_cast<int>(g.reduce_grid.x),
                     static_cast<int>(g.reduce_grid.y),
                     static_cast<int>(g.reduce_grid.z), kReduceThreads, 0};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The i-th __global__ instance as the card loaded it
// (cudaFuncGetAttributes): its name, and out = {registers, static shared
// bytes, the most threads a block may take}. The six partial-kernel
// instances (func x exact branch), then the reduction. -1 past the last,
// else a cudaError_t.
extern "C" int counter_groupsum_attrs(int i, const char** name, int* out) {
  const void* fns[7] = {
      reinterpret_cast<const void*>(groupsum_partial_kernel<0, false>),
      reinterpret_cast<const void*>(groupsum_partial_kernel<0, true>),
      reinterpret_cast<const void*>(groupsum_partial_kernel<1, false>),
      reinterpret_cast<const void*>(groupsum_partial_kernel<1, true>),
      reinterpret_cast<const void*>(groupsum_partial_kernel<2, false>),
      reinterpret_cast<const void*>(groupsum_partial_kernel<2, true>),
      reinterpret_cast<const void*>(groupsum_reduce_kernel)};
  if (i < 0 || i >= 7) return -1;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *name = i < 6 ? "groupsum_partial_kernel" : "groupsum_reduce_kernel";
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  return 0;
}
