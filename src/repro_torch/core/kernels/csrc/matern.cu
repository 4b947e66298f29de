// Matérn-5/2 cross-covariance for the GP sampler.
//
// Replaces the TPU kernel src/repro/core/kernels/matern.py
// (_matern_kernel, launched by _matern_pallas_impl).  Same augmented
// form: aa = [-2 a/ls, |a/ls|^2, 1] (A, K) and bb = [b/ls, 1, |b/ls|^2]
// (B, K), K = D + 2, so aa[i] . bb[j] = d^2 and
//
//     out[i, j] = (1 + sqrt5 d + (sqrt5 d)^2 / 3) exp(-sqrt5 d),
//     d = sqrt(max(d^2, 1e-12)).
//
// What bounds it on an H100: launch latency at the service's shapes.  At
// A = B = 512, D = 5 it writes 1 MB (0.3 us at 3.35 TB/s) and does about
// 3.4 MFLOP plus A*B sqrtf/expf.
//
// Design: a 2-D grid of 16x16 output tiles, one thread per output.  The
// K columns of the tile's 16 rows of aa and of bb are staged in dynamic
// shared memory (any K works), then each thread forms d^2 with fp32 FMAs
// (no tensor cores: K is 3..13, and TF32 would ruin the expanded-square
// cancellation) and applies the Matérn form.  threadIdx.x runs along B,
// so the stores of a warp are contiguous.  Ragged A and B are masked in
// the kernel.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;

__global__ void matern52_kernel(const float* __restrict__ aa,
                                const float* __restrict__ bb,
                                float* __restrict__ out, int a_rows,
                                int b_rows, int k) {
  extern __shared__ float smem[];  // 2 * kTile * k floats
  float* sa = smem;
  float* sb = smem + kTile * k;
  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int e = tid; e < kTile * k; e += kTile * kTile) {
    const int r = e / k;
    const int j = e - r * k;
    sa[e] = (a0 + r < a_rows) ? aa[static_cast<size_t>(a0 + r) * k + j] : 0.f;
    sb[e] = (b0 + r < b_rows) ? bb[static_cast<size_t>(b0 + r) * k + j] : 0.f;
  }
  __syncthreads();

  const int i = a0 + threadIdx.y;
  const int j = b0 + threadIdx.x;
  if (i >= a_rows || j >= b_rows) {
    return;
  }
  const float* ra = sa + threadIdx.y * k;
  const float* rb = sb + threadIdx.x * k;
  float d2 = 0.f;
  for (int c = 0; c < k; ++c) {
    d2 = fmaf(ra[c], rb[c], d2);
  }
  const float d = sqrtf(fmaxf(d2, 1e-12f));
  const float s5d = 2.2360679774997896f * d;
  out[static_cast<size_t>(i) * b_rows + j] =
      (1.f + s5d + s5d * s5d / 3.f) * expf(-s5d);
}

}  // namespace

extern "C" int matern(const void* aa, const void* bb, void* out, int a_rows,
                      int b_rows, int k, void* stream) {
  if (a_rows > 0 && b_rows > 0) {
    const dim3 grid((b_rows + kTile - 1) / kTile, (a_rows + kTile - 1) / kTile);
    const dim3 block(kTile, kTile);
    matern52_kernel<<<grid, block, 2 * kTile * k * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(aa), static_cast<const float*>(bb),
        static_cast<float*>(out), a_rows, b_rows, k);
  }
  return static_cast<int>(cudaGetLastError());
}
