// Matérn-5/2 cross-covariance for the GP sampler, with the GP's masks in
// the same launch.
//
// Replaces the TPU kernel src/repro/core/kernels/matern.py
// (_matern_kernel, launched by _matern_pallas_impl): the same function,
// from the raw operands (a, b, ls):
//
//     d^2[i, j] = |as_i|^2 + |bs_j|^2 - 2 as_i . bs_j   (as = a/ls, bs = b/ls)
//     k[i, j] = (1 + sqrt5 d + (sqrt5 d)^2 / 3) exp(-sqrt5 d),
//     d = sqrt(max(d^2, 1e-12)).
//
// Optionally masked as the GP sampler needs it: where row_mask[i] or
// col_mask[j] is not > 0 (a missing mask counts as 1) the entry is 0, and
// with `diag` the diagonal gets `jitter` where the row is valid and 1.0
// where it is padding, so that K = matern(X, X) masked with the jitter
// diagonal and Ks = matern(cands, X) with the column mask are one launch
// each.
//
// What bounds it on an H100: launch latency, then the output.  At
// A = B = 512, D = 5 it writes 1 MB (0.31 us at 3.35 TB/s), does ~4e6
// fp32 operations and 2.6e5 exponentials; the old kernel took 3.4 us with
// one output per thread after three PyTorch ops that built augmented
// operands.
//
// Design: a block of 256 threads computes a 32 x 32 output tile (256
// blocks at 512 x 512, about 16 warps an SM to hide the latency of each
// output's sqrt and exp).  It scales its 32 rows of a and of b by 1/ls
// into shared memory, transposed (dimension-major, so a thread reads its
// 4 columns as one float4), with their squared norms.  Each thread then
// holds one row's 4 dot products (fp32 FMAs; no tensor cores: D is small
// and TF32 would ruin the cancellation of the expanded square), applies
// the Matérn form and the masks, and writes its 4 outputs as one float4
// when B is a multiple of 4 (scalar stores on a ragged edge).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;               // rows of a and of b a block
constexpr int kThreads = 256;           // 32 rows x 8 column quads

__global__ void __launch_bounds__(kThreads)
    matern52_tile_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ ls,
                         const float* __restrict__ row_mask,
                         const float* __restrict__ col_mask, float jitter,
                         int diag, float* __restrict__ out, int na, int nb,
                         int d) {
  extern __shared__ float4 smem4[];
  float* at = reinterpret_cast<float*>(smem4);   // [d][kTile]
  float* bt = at + d * kTile;                     // [d][kTile]
  __shared__ float sa[kTile], sb[kTile];
  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;

  for (int e = tid; e < kTile * d; e += kThreads) {
    const int r = e / d;
    const int k = e - r * d;
    at[k * kTile + r] =
        a0 + r < na ? a[static_cast<size_t>(a0) * d + e] / ls[k] : 0.f;
    bt[k * kTile + r] =
        b0 + r < nb ? b[static_cast<size_t>(b0) * d + e] / ls[k] : 0.f;
  }
  __syncthreads();
  if (tid < 2 * kTile) {
    const float* col = (tid < kTile ? at : bt) + (tid % kTile);
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float v = col[k * kTile];
      s += v * v;
    }
    (tid < kTile ? sa : sb)[tid % kTile] = s;
  }
  __syncthreads();

  const int r = tid / 8;                  // row a0 + r
  const int q = tid % 8;                  // columns b0 + 4 q .. + 3
  const int i = a0 + r;
  const int j0 = b0 + 4 * q;
  if (i >= na || j0 >= nb) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < d; ++k) {
    const float av = at[k * kTile + r];
    const float4 bv = *reinterpret_cast<const float4*>(bt + k * kTile + 4 * q);
    acc[0] = fmaf(av, bv.x, acc[0]);
    acc[1] = fmaf(av, bv.y, acc[1]);
    acc[2] = fmaf(av, bv.z, acc[2]);
    acc[3] = fmaf(av, bv.w, acc[3]);
  }
  const bool masked = row_mask != nullptr || col_mask != nullptr;
  const float rm = row_mask != nullptr ? row_mask[i] : 1.f;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + c;
    const float d2 = (sa[r] + sb[4 * q + c]) - 2.f * acc[c];
    const float dist = sqrtf(fmaxf(d2, 1e-12f));
    const float s5d = 2.2360679774997896f * dist;
    float k = (1.f + s5d + s5d * s5d * (1.f / 3.f)) * expf(-s5d);
    if (masked && j < nb) {
      const float cm = col_mask != nullptr ? col_mask[j] : 1.f;
      k = rm > 0.f && cm > 0.f ? k : 0.f;
    }
    if (diag && i == j) k += rm > 0.f ? jitter : 1.f;
    v[c] = k;
  }
  float* row = out + static_cast<size_t>(i) * nb + j0;
  if (j0 + 3 < nb && nb % 4 == 0) {
    *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (j0 + c < nb) row[c] = v[c];
    }
  }
}

}  // namespace

// row_mask, col_mask: nullptr or (na,) / (nb,) validity; diag != 0 adds
// the jitter diagonal (needs row_mask).
extern "C" int matern(const void* a, const void* b, const void* ls,
                      const void* row_mask, const void* col_mask,
                      float jitter, int diag, void* out, int na, int nb,
                      int d, void* stream) {
  if (na > 0 && nb > 0) {
    const size_t smem = sizeof(float) * 2 * kTile * d;
    if (smem > 46 * 1024) {           // 48 KB less the static arrays
      const cudaError_t err = cudaFuncSetAttribute(
          matern52_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(err);
      }
    }
    const dim3 grid((nb + kTile - 1) / kTile, (na + kTile - 1) / kTile);
    matern52_tile_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(ls), static_cast<const float*>(row_mask),
        static_cast<const float*>(col_mask), jitter, diag,
        static_cast<float*>(out), na, nb, d);
  }
  return static_cast<int>(cudaGetLastError());
}
