// Masked Parzen-mixture log-density for the TPE sampler, and the whole
// TPE acquisition score of a proposal round, in one launch.
//
// Replaces the TPU kernel src/repro/core/kernels/parzen.py
// (_parzen_kernel, launched by _parzen_pallas): the same function, a
// masked logsumexp over the observations of
//
//     s[c, n] = xs_c . os_n - (0.5|os_n|^2 + sum_d log(bw_d sqrt(2 pi))),
//     xs = x / bw, os = obs / bw,
//     logk[c] = logsumexp_{n valid} s[c, n] - 0.5|xs_c|^2,
//
// but read from the raw operands (x, obs, mask, bw): the scaling, the
// per-row term and the masking happen here, not in PyTorch ops around
// the launch.  With a second mixture the kernel also folds in the TPE
// epilogue of each mixture (the uniform prior and the 1/(n + 1) weight)
// and writes
//
//     out[c] = side_good[c] - side_bad[c],
//     side = logaddexp(logk, logp) - log(max(sum(mask), 1) + 1),
//     logp[c] = sum_d (-0.5 (x_cd - 0.5)^2 - log sqrt(2 pi)),
//
// the score _tpe_score returns; without one it writes logk.
//
// What bounds it on an H100: latency.  At the service's main shape (C =
// 64 candidates, 32 good and 8192 bad rows, D = 5) it reads ~200 KB and
// does ~3.2e5 exponentials and ~4.5e6 fp32 operations, well under a
// microsecond of any unit; the old kernel took 15.7 us a mixture because
// it ran one block per candidate (64 blocks on 132 SMs), walked 24-byte
// rows per thread and merged with an expf in each step of a shared tree.
// Here a launch is a chain of short dependent phases: two global round
// trips to start, one row pass of ~4 rows a thread, the merges and one
// cluster barrier.
//
// Design:
// - Grid (8, ceil(C / CB)): a thread block cluster of 8 blocks per tile of
//   CB candidates (CB = 1..16, chosen on the host so that ~16 clusters,
//   128 blocks, cover the card).  The concatenated rows [good; bad] are
//   cut into 8 slices of `slice` rows, one per cluster rank.
// - Each block copies its slice, `tile` rows at a time, into shared
//   memory with 4-byte cp.async (coalesced; the first tile's copies are
//   issued while the candidates' loads are in flight), and
//   each thread takes whole rows: it scales the row by the reciprocal
//   bandwidths, forms its per-row term once and scores it against the CB
//   candidates held in registers (fp32 FMAs; no tensor cores: K = D + 1
//   is small and TF32 would ruin the cancellation of the expanded
//   square).  Masked rows are skipped, so a fully masked mixture gives
//   -inf, as the plain version does.
// - Each thread keeps an online (max m, sum l) per candidate and mixture,
//   branch-free, with one ex2.approx per element, of -|s - m| * log2(e):
//   the difference is taken in natural units first, so that no rounding
//   of a large s scaled by log2(e) enters the result.
// - Warps merge their pairs with shuffles (branch-free merges), the block
//   through shared memory; then each block pushes its pair of candidate j
//   into the shared memory of cluster rank j % 8 (distributed shared
//   memory stores), and one cluster barrier later rank r finishes
//   candidates r, r + 8, ... from its own shared memory: the 8 pairs and
//   mask sums, the prior and the logaddexp.  No global scratch, no
//   atomics, no second launch: concurrent launches share no state.
// - A merge with an empty side, (-inf, 0), keeps the other side, so a
//   slice made only of padding never forms inf - inf.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kMaxCB = 16;
// dynamic shared memory a launch may take without opting in: 48 KB less
// room for the static arrays (4.4 KB at CB = 16)
constexpr size_t kDefaultSmem = 43 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kLogSqrt2Pi = 0.91893853320467274f;

struct Mixture {
  const float* obs;   // (n, d)
  const float* mask;  // (n,)
  const float* bw;    // (d,)
  int n;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m, l) <- (m, l) merged with (m2, l2); an empty side is (-inf, 0).
// Branch-free, so the lanes of a warp never diverge: the larger side's
// factor is ex2(0) = 1 exactly, an empty side's is ex2(-inf) = 0, and two
// empty sides stay (-inf, 0) instead of forming inf - inf.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  const float a = ex2((m - mn) * kLog2e);
  const float b = ex2((m2 - mn) * kLog2e);
  l = mn == -INFINITY ? 0.f : fmaf(l2, b, l * a);
  m = mn;
}

// torch.logaddexp
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float mx = fmaxf(a, b);
  return mx + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies rows [g0, g0 + rows) of [obs0; obs1] and of [mask0; mask1] into
// tobs and tmask: one 4-byte cp.async a float, neighbouring threads on
// neighbouring floats; nothing waits here.
__device__ __forceinline__ void stage(const Mixture& m0, const Mixture& m1,
                                      int d, int g0, int rows, float* tobs,
                                      float* tmask) {
  const int split = min(max(m0.n - g0, 0), rows);   // rows from mixture 0
  for (int e = threadIdx.x; e < split * d; e += kThreads) {
    cp_async4(tobs + e, m0.obs + static_cast<size_t>(g0) * d + e);
  }
  const int g1 = g0 + split - m0.n;                  // first row of mix 1
  for (int e = threadIdx.x; e < (rows - split) * d; e += kThreads) {
    cp_async4(tobs + split * d + e, m1.obs + static_cast<size_t>(g1) * d + e);
  }
  for (int e = threadIdx.x; e < rows; e += kThreads) {
    cp_async4(tmask + e, e < split ? m0.mask + g0 + e : m1.mask + g1 + e - split);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One valid row against the CB candidates: the row scaled by the
// reciprocal bandwidths (a multiply where the plain version divides: the
// rounding differs by an ulp of os, which moves s by (xs - os) times it,
// small where the terms that matter are), its per-row term once, then an
// online (max, sum) update per candidate with one ex2 an element.
template <int CB>
__device__ __forceinline__ void score_row(const float* row, const float* xm,
                                          const float* rbw, float log_norm,
                                          int d, float (&m)[CB],
                                          float (&l)[CB]) {
  float acc[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) acc[j] = 0.f;
  float so = 0.f;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    const float o = row[k] * rbw[k];
    so += o * o;
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[j] = fmaf(xm[j * d + k], o, acc[j]);
  }
  so = 0.5f * so + log_norm;
  // branch-free: ex2(-|s - m|) rescales the old sum when s is the new
  // maximum and is the new term otherwise (m = -inf gives 0, then 1)
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const float s = acc[j] - so;
    const float e = ex2(-fabsf(s - m[j]) * kLog2e);
    const bool grow = s > m[j];
    l[j] = grow ? fmaf(l[j], e, 1.f) : l[j] + e;
    m[j] = grow ? s : m[j];
  }
}

// Merges the per-thread pairs and mask sums of both mixtures over the
// block (warp shuffles, then the warps in order) and pushes the block's
// pair of each candidate j into the shared memory of cluster rank j % 8,
// and its mask sums into every rank's: gath_m/gath_l[mi][rank][j],
// gath_n[mi][rank].
template <int CB>
__device__ __forceinline__ void block_merge(
    cg::cluster_group& cluster, int nmix, float (&m0)[CB], float (&l0)[CB],
    float (&m1)[CB], float (&l1)[CB], float nsum0, float nsum1,
    float (*red_m)[kWarps][CB], float (*red_l)[kWarps][CB],
    float (*red_n)[kWarps], float (*gath_m)[kCluster][CB],
    float (*gath_l)[kCluster][CB], float (*gath_n)[kCluster]) {
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const unsigned rank = cluster.block_rank();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      merge(m0[j], l0[j], __shfl_xor_sync(0xffffffffu, m0[j], off),
            __shfl_xor_sync(0xffffffffu, l0[j], off));
      if (nmix == 2) {
        merge(m1[j], l1[j], __shfl_xor_sync(0xffffffffu, m1[j], off),
              __shfl_xor_sync(0xffffffffu, l1[j], off));
      }
    }
    nsum0 += __shfl_xor_sync(0xffffffffu, nsum0, off);
    nsum1 += __shfl_xor_sync(0xffffffffu, nsum1, off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      red_m[0][w][j] = m0[j];
      red_l[0][w][j] = l0[j];
      red_m[1][w][j] = m1[j];
      red_l[1][w][j] = l1[j];
    }
    red_n[0][w] = nsum0;
    red_n[1][w] = nsum1;
  }
  __syncthreads();
  if (tid < nmix * CB) {
    const int mi = tid / CB;
    const int j = tid % CB;
    float mm = -INFINITY, ll = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) merge(mm, ll, red_m[mi][v][j], red_l[mi][v][j]);
    const unsigned owner = j % kCluster;
    *cluster.map_shared_rank(&gath_m[mi][rank][j], owner) = mm;
    *cluster.map_shared_rank(&gath_l[mi][rank][j], owner) = ll;
  } else if (tid >= 32 && tid < 32 + nmix * kCluster) {
    const int mi = (tid - 32) / kCluster;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red_n[mi][v];
    *cluster.map_shared_rank(&gath_n[mi][rank], (tid - 32) % kCluster) = s;
  }
}

template <int CB>
__global__ void __launch_bounds__(kThreads)
    parzen_cluster_kernel(const float* __restrict__ x, int c_total, int d,
                          Mixture mix0, Mixture mix1, int fused, int slice,
                          int tile, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nmix = fused ? 2 : 1;
  float* xs = smem;                       // [nmix][CB][d]
  float* rbws = xs + 2 * CB * d;          // [nmix][d], 1 / bw
  float* tobs = rbws + 2 * d;             // [tile][d]
  float* tmask = tobs + tile * d;         // [tile]
  __shared__ float red_m[2][kWarps][CB], red_l[2][kWarps][CB];
  __shared__ float red_n[2][kWarps];
  __shared__ float sx[2][CB], logp[CB], lnorm[2];
  // written by the other ranks of the cluster
  __shared__ float gath_m[2][kCluster][CB], gath_l[2][kCluster][CB];
  __shared__ float gath_n[2][kCluster];

  cg::cluster_group cluster = cg::this_cluster();
  // the other ranks may write here only once every rank has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * CB;
  const int nc = min(CB, c_total - c0);
  if (!fused) mix1.n = 0;
  const int n0 = mix0.n;
  const int n_rows = n0 + mix1.n;
  const int r_lo = min(n_rows, rank * slice);
  const int r_hi = min(n_rows, r_lo + slice);

  // the candidates' first loads are issued, then the first tile's
  // copies, so that the two latencies overlap
  const int n_xs = nmix * CB * d;
  auto load = [&](int e, float& xv, float& bv) {
    const int j = (e / d) % CB;
    const int k = e % d;
    bv = (e < CB * d ? mix0.bw : mix1.bw)[k];
    xv = j < nc ? x[static_cast<size_t>(c0 + j) * d + k] : 0.f;
  };
  float xv = 0.f, bv = 1.f;
  if (tid < n_xs) load(tid, xv, bv);
  if (r_lo < r_hi) stage(mix0, mix1, d, r_lo, min(tile, r_hi - r_lo), tobs, tmask);
  for (int e = tid; e < n_xs; e += kThreads) {
    if (e != tid) load(e, xv, bv);
    xs[e] = xv / bv;
    if ((e / d) % CB == 0) rbws[(e / (CB * d)) * d + e % d] = 1.f / bv;
  }
  __syncthreads();
  if (tid < nmix * CB) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float v = xs[tid * d + k];
      s += v * v;
    }
    sx[tid / CB][tid % CB] = 0.5f * s;
  } else if (tid >= 64 && tid < 64 + nmix) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      s += logf((tid == 64 ? mix0.bw : mix1.bw)[k] * kSqrt2Pi);
    }
    lnorm[tid - 64] = s;
  } else if (fused && tid >= 96 && tid < 96 + nc) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float zp = x[static_cast<size_t>(c0 + tid - 96) * d + k] - 0.5f;
      s += -0.5f * zp * zp - kLogSqrt2Pi;
    }
    logp[tid - 96] = s;
  }

  float m0[CB], l0[CB], m1[CB], l1[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    m0[j] = m1[j] = -INFINITY;
    l0[j] = l1[j] = 0.f;
  }
  float nsum0 = 0.f, nsum1 = 0.f;
  for (int t0 = r_lo; t0 < r_hi; t0 += tile) {
    const int rows = min(tile, r_hi - t0);
    if (t0 != r_lo) {
      __syncthreads();                   // the previous tile is consumed
      stage(mix0, mix1, d, t0, rows, tobs, tmask);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < rows; i += kThreads) {
      const float valid = tmask[i];
      const bool second = t0 + i >= n0;
      if (second) {
        nsum1 += valid;
      } else {
        nsum0 += valid;
      }
      if (!(valid > 0.f)) continue;
      if (second) {
        score_row<CB>(tobs + i * d, xs + CB * d, rbws + d, lnorm[1], d, m1,
                      l1);
      } else {
        score_row<CB>(tobs + i * d, xs, rbws, lnorm[0], d, m0, l0);
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  block_merge<CB>(cluster, nmix, m0, l0, m1, l1, nsum0, nsum1, red_m, red_l,
                  red_n, gath_m, gath_l, gath_n);
  cluster.sync();                        // every rank's pairs have arrived

  // rank r finishes candidates r, r + 8, ... of the tile from its own
  // shared memory; no rank reads another's after the barrier
  const int j = rank + kCluster * tid;
  if (j < nc) {
    float side[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi == nmix) break;
      float mm = -INFINITY, ll = 0.f, nn = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        merge(mm, ll, gath_m[mi][q][j], gath_l[mi][q][j]);
        nn += gath_n[mi][q];
      }
      const float logk =
          (mm == -INFINITY ? -INFINITY : mm + logf(ll)) - sx[mi][j];
      side[mi] = fused ? logaddexp(logk, logp[j]) - logf(fmaxf(nn, 1.f) + 1.f)
                       : logk;
    }
    out[c0 + j] = fused ? side[0] - side[1] : side[0];
  }
}

template <int CB>
cudaError_t launch(const float* x, int c, int d, Mixture m0, Mixture m1,
                   int fused, int slice, int tile, float* out,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * CB * d + 2 * d + tile * (d + 1));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        parzen_cluster_kernel<CB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, (c + CB - 1) / CB, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, parzen_cluster_kernel<CB>, x, c, d, m0,
                            m1, fused, slice, tile, out);
}

}  // namespace

// One mixture (obs1 == nullptr): out = logk.  Two: out = the TPE score.
// cb (1, 2, 4, 8 or 16), slice and tile come from the wrapper's plan.
extern "C" int parzen(const void* x, int c, int d, const void* obs0,
                      const void* mask0, const void* bw0, int n0,
                      const void* obs1, const void* mask1, const void* bw1,
                      int n1, int cb, int slice, int tile, void* out,
                      void* stream) {
  if (c <= 0) return static_cast<int>(cudaGetLastError());
  const Mixture m0{static_cast<const float*>(obs0),
                   static_cast<const float*>(mask0),
                   static_cast<const float*>(bw0), n0};
  const Mixture m1{static_cast<const float*>(obs1),
                   static_cast<const float*>(mask1),
                   static_cast<const float*>(bw1), n1};
  const int fused = obs1 != nullptr;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cb) {
    case 1: err = launch<1>(xp, c, d, m0, m1, fused, slice, tile, op, s); break;
    case 2: err = launch<2>(xp, c, d, m0, m1, fused, slice, tile, op, s); break;
    case 4: err = launch<4>(xp, c, d, m0, m1, fused, slice, tile, op, s); break;
    case 8: err = launch<8>(xp, c, d, m0, m1, fused, slice, tile, op, s); break;
    case kMaxCB:
      err = launch<kMaxCB>(xp, c, d, m0, m1, fused, slice, tile, op, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}
