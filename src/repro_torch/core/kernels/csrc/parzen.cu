// Masked Parzen-mixture log-density for the TPE sampler.
//
// Replaces the TPU kernel src/repro/core/kernels/parzen.py
// (_parzen_kernel, launched by _parzen_pallas).  Same augmented form:
// xa = [x/bw, -1] (C, K) and oa = [obs/bw, so] (N, K), K = D + 1, with
// so = 0.5|obs/bw|^2 + log-normaliser for valid rows and +1e30 for
// padding rows, so that s[c, n] = xa[c] . oa[n] and
//
//     out[c] = log(max(sum_n exp(s[c, n] - m_c), 1e-37)) + m_c,
//     m_c = max_n s[c, n].
//
// The caller subtracts 0.5|x/bw|^2 afterwards.
//
// What bounds it on an H100: nothing but launch latency at the service's
// shapes.  At C = 64, N = 8192, D = 5 it reads ~200 KB (about 0.06 us at
// 3.35 TB/s) and does ~6 MFLOP of fp32 FMAs plus C*N expf.
//
// Design: one block per candidate row.  The TPU kernel walks the
// observation tiles as a sequential grid axis, carrying (max, sumexp) in
// VMEM scratch; here that axis becomes a loop inside the block: each
// thread strides over N keeping its own running (m, l), and a shared
// memory tree reduction merges the pairs with m = max(m1, m2),
// l = l1 e^(m1-m) + l2 e^(m2-m).  Nothing carries between blocks.  The
// xa row sits in dynamic shared memory, so any K works.  Ragged C and N
// need no padding: the grid has exactly C blocks and the thread loop
// stops at N.  The contraction is plain fp32 FMAs (no tensor cores:
// K is 2..12, and TF32 would ruin the expanded-square cancellation).
//
// Fully masked rows: every s is about -1e30, so the kernel returns about
// -1e30 (finite), where the plain PyTorch version returns -inf.  Callers
// always pass at least one valid row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) {  // both empty: keep (-inf, 0), avoid inf - inf
    l = 0.f;
  } else {
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
  }
  m = mn;
}

__global__ void parzen_lse_kernel(const float* __restrict__ xa,
                                  const float* __restrict__ oa,
                                  float* __restrict__ out, int n, int k) {
  extern __shared__ float xrow[];  // k floats
  __shared__ float red_m[kThreads];
  __shared__ float red_l[kThreads];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < k; j += kThreads) {
    xrow[j] = xa[static_cast<size_t>(c) * k + j];
  }
  __syncthreads();

  float m = -INFINITY;
  float l = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float* o = oa + static_cast<size_t>(i) * k;
    float s = 0.f;
    for (int j = 0; j < k; ++j) {
      s = fmaf(xrow[j], o[j], s);
    }
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }
  red_m[tid] = m;
  red_l[tid] = l;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      float mm = red_m[tid];
      float ll = red_l[tid];
      merge(mm, ll, red_m[tid + stride], red_l[tid + stride]);
      red_m[tid] = mm;
      red_l[tid] = ll;
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[c] = logf(fmaxf(red_l[0], 1e-37f)) + red_m[0];
  }
}

}  // namespace

extern "C" int parzen(const void* xa, const void* oa, void* out, int c,
                      int n, int k, void* stream) {
  if (c > 0) {
    parzen_lse_kernel<<<c, kThreads, k * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xa), static_cast<const float*>(oa),
        static_cast<float*>(out), n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
