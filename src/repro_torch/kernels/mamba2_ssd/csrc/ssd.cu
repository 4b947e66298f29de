// Chunked Mamba2 SSD scan, forward.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd/kernel.py:81
// (_kernel, launched by ssd_fwd) together with the precompute of its
// wrapper ops.ssd.  Per (batch, head), with A = -exp(a_log[h]) and, in
// each chunk of Q tokens, xw = x * dt (rounded to the input type, as the
// reference's product is) and cum the inclusive in-chunk cumsum of dt * A:
//
//     M[t,s]  = (C_t . B_s) * exp(cum_t - cum_s) for s <= t, else 0
//     y[t]    = M[t,:] @ xw + exp(cum_t) * (C_t . h)    (h entering the chunk)
//     h       = exp(cum_Q) * h + (xw * exp(cum_Q - cum))^T @ B
//
// and the last h is the float32 final state.  The arithmetic is float32.
//
// What bounds it on an H100: bytes.  At zamba2-1.2b's prefill shape (b 4,
// S 2048, 64 heads of 64, ds 64, chunk 64, bf16) the function reads x, dt,
// B and C once and writes y and the final state: about 142 MB, 0.042 ms
// at 3.35 TB/s, against about 8.6e9 multiply-adds that tensor cores would do
// in 0.017 ms.  This first version runs plain float32 FMAs from shared
// memory, far above that bound; its measured time sits beside the bound
// in PERF.md.  mma.sync/wgmma for the four chunk products and cp.async
// loads are later work.
//
// Design.  The TPU kernel runs a grid (b, nh, chunk) whose last axis is
// sequential and carries h in VMEM scratch.  Blocks on the H100 run in no
// order, so here one block owns one (batch, head) and a loop inside it
// walks the chunks, keeping the (hd, ds) state in shared memory for the
// whole sequence (16 KB at hd = ds = 64).  The dt-weighting, A and the
// in-chunk cumsum (a warp scan) are computed in the block, so the wrapper
// enqueues nothing but the launch.  x (b, S, nh, hd), dt (b, S, nh) and
// B, C (b, S, ds) are read through their strides, so the model's views
// are never copied or transposed.  256 threads form a 16 x 16 grid over
// each output tile; a thread owns rows ty + 16 i and columns tx + 16 j,
// so its operand reads are either broadcasts or hit 16 distinct banks
// (rows are padded by one float).  Tile pairs above the diagonal of the
// causal C.B^T product are skipped.
//
// hd and ds are template parameters (16, 32, 64 or 128), so each
// thread's patches are fixed register arrays with no run-time guards.
//
// Shared memory (sized for chunks of 64): 83,712 bytes at hd = ds = 64
// (two blocks per SM), 182,272 bytes at hd = ds = 128; each launch
// raises the dynamic limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;  // rows of a chunk tile: 4 x 16

struct Strides {
  long long b, s, h;  // element strides; the last dim is dense
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int HD, int DS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kMaxChunk * (HD + 1) + 2 * kMaxChunk * (DS + 1) +
                          kMaxChunk * (kMaxChunk + 1) + HD * (DS + 1) +
                          2 * kMaxChunk);
}

// HD and DS (multiples of 16) are compile-time, so each thread's patch
// of every product is a fixed set of registers with no guards; the chunk
// length q <= 64 is not: rows past q are clamped on load and not stored.
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const float* __restrict__ a_log, const T* __restrict__ bm,
                   const T* __restrict__ cm, T* __restrict__ y,
                   float* __restrict__ h_out, Strides xs, Strides dts,
                   Strides ys, Strides bs, Strides cs, int s_len, int nh,
                   int q) {
  constexpr int XP = HD + 1;  // padded rows
  constexpr int DP = DS + 1;
  constexpr int MP = kMaxChunk + 1;
  constexpr int HJ = HD / 16;  // column tiles over hd
  constexpr int DJ = DS / 16;  // column tiles over ds
  extern __shared__ float smem[];
  float* xw = smem;                   // q x XP: dt-weighted x of the chunk
  float* bt = xw + kMaxChunk * XP;    // q x DP: B
  float* ct = bt + kMaxChunk * DP;    // q x DP: C
  float* mt = ct + kMaxChunk * DP;    // q x MP: causal-decay-masked C.B^T
  float* ht = mt + kMaxChunk * MP;    // HD x DP: the state h
  float* cum = ht + HD * DP;          // q: inclusive in-chunk cumsum of dt*A
  float* tail = cum + kMaxChunk;      // q: exp(cum_Q - cum_s)

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float A = -expf(a_log[h]);
  int row[4];  // this thread's chunk rows, clamped into the chunk
#pragma unroll
  for (int i = 0; i < 4; ++i) row[i] = min(ty + 16 * i, q - 1);

  const T* xb = x + b * xs.b + h * xs.h;
  const T* dtb = dt + b * dts.b + h * dts.h;
  const T* bb = bm + b * bs.b;
  const T* cb = cm + b * cs.b;
  T* yb = y + b * ys.b + h * ys.h;

  for (int i = tid; i < HD * DS; i += kThreads) ht[(i / DS) * DP + i % DS] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += q) {
    // ---- load the chunk; the dt-weighted x is a product in T
    for (int i = tid; i < q * HD; i += kThreads) {
      const int t = i / HD;
      const int d = i % HD;
      const float prod = to_f32(xb[(t0 + t) * xs.s + d]) *
                         to_f32(dtb[(t0 + t) * dts.s]);
      xw[t * XP + d] = to_f32(from_f32<T>(prod));
    }
    for (int i = tid; i < q * DS; i += kThreads) {
      const int t = i / DS;
      const int n = i % DS;
      bt[t * DP + n] = to_f32(bb[(t0 + t) * bs.s + n]);
      ct[t * DP + n] = to_f32(cb[(t0 + t) * cs.s + n]);
    }
    if (tid < 32) {  // warp 0: inclusive scan of dt * A, two rows a lane
      float a0 = tid < q ? to_f32(dtb[(t0 + tid) * dts.s]) * A : 0.f;
      float a1 = tid + 32 < q ? to_f32(dtb[(t0 + tid + 32) * dts.s]) * A : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n0 = __shfl_up_sync(0xffffffffu, a0, off);
        const float n1 = __shfl_up_sync(0xffffffffu, a1, off);
        if (tid >= off) {
          a0 += n0;
          a1 += n1;
        }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      const float last = __shfl_sync(0xffffffffu, q > 32 ? a1 : a0,
                                     (q - 1) % 32);
      if (tid < q) {
        cum[tid] = a0;
        tail[tid] = expf(last - a0);
      }
      if (tid + 32 < q) {
        cum[tid + 32] = a1;
        tail[tid + 32] = expf(last - a1);
      }
    }
    __syncthreads();

    // ---- M = (C.B^T) * exp(cum_t - cum_s), causal (s <= t)
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = ct[row[i] * DP + n];
          bv[i] = bt[min(tx + 16 * i, q - 1) * DP + n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i;
          const int s = tx + 16 * j;
          if (t < q && s < q) {
            mt[t * MP + s] = s <= t ? expf(cum[t] - cum[s]) * acc[i][j] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // ---- y = exp(cum_t) * (C_t . h) + M @ xw
    {
      float acc[4][HJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < HJ; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[4], hv[HJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ct[row[i] * DP + n];
#pragma unroll
        for (int j = 0; j < HJ; ++j) hv[j] = ht[(tx + 16 * j) * DP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < HJ; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = expf(cum[row[i]]);
#pragma unroll
        for (int j = 0; j < HJ; ++j) acc[i][j] *= g;
      }
      for (int s = 0; s < q; ++s) {
        float mv[4], xv[HJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = mt[row[i] * MP + s];
#pragma unroll
        for (int j = 0; j < HJ; ++j) xv[j] = xw[s * XP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < HJ; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= q) continue;
#pragma unroll
        for (int j = 0; j < HJ; ++j) {
          yb[(t0 + t) * ys.s + tx + 16 * j] = from_f32<T>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of h for this chunk is done

    // ---- h = exp(cum_Q) * h + (xw * tail)^T @ B
    {
      float acc[HJ][DJ];
#pragma unroll
      for (int i = 0; i < HJ; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
      }
      for (int s = 0; s < q; ++s) {
        const float w = tail[s];
        float xv[HJ], bv[DJ];
#pragma unroll
        for (int i = 0; i < HJ; ++i) xv[i] = xw[s * XP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < DJ; ++j) bv[j] = bt[s * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < HJ; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
        }
      }
      const float gamma = expf(cum[q - 1]);
#pragma unroll
      for (int i = 0; i < HJ; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          float* hp = ht + (ty + 16 * i) * DP + tx + 16 * j;
          *hp = *hp * gamma + acc[i][j];
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites the tiles
  }

  float* hb = h_out + (static_cast<long long>(b) * nh + h) * HD * DS;
  for (int i = tid; i < HD * DS; i += kThreads) hb[i] = ht[(i / DS) * DP + i % DS];
}

template <typename T, int HD, int DS>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, void* y, void* h_out,
                   Strides xs, Strides dts, Strides ys, Strides bs,
                   Strides cs, int batch, int s_len, int nh, int q,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, DS>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, batch);
  ssd_fwd_kernel<T, HD, DS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(h_out), xs, dts, ys, bs, cs, s_len, nh, q);
  return cudaGetLastError();
}

#define SSD_ARGS \
  x, dt, a_log, bm, cm, y, h_out, xs, dts, ys, bs, cs, batch, s_len, nh, q, st

template <typename T, int HD>
cudaError_t dispatch_ds(int ds, const void* x, const void* dt,
                        const void* a_log, const void* bm, const void* cm,
                        void* y, void* h_out, Strides xs, Strides dts,
                        Strides ys, Strides bs, Strides cs, int batch,
                        int s_len, int nh, int q, cudaStream_t st) {
  switch (ds) {
    case 16: return launch<T, HD, 16>(SSD_ARGS);
    case 32: return launch<T, HD, 32>(SSD_ARGS);
    case 64: return launch<T, HD, 64>(SSD_ARGS);
    case 128: return launch<T, HD, 128>(SSD_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int hd, int ds, const void* x, const void* dt,
                     const void* a_log, const void* bm, const void* cm,
                     void* y, void* h_out, Strides xs, Strides dts,
                     Strides ys, Strides bs, Strides cs, int batch,
                     int s_len, int nh, int q, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_ds<T, 16>(ds, SSD_ARGS);
    case 32: return dispatch_ds<T, 32>(ds, SSD_ARGS);
    case 64: return dispatch_ds<T, 64>(ds, SSD_ARGS);
    case 128: return dispatch_ds<T, 128>(ds, SSD_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef SSD_ARGS

}  // namespace

// x (b, S, nh, hd), dt (b, S, nh), B and C (b, S, ds), y (b, S, nh, hd),
// all of one type (is_bf16: 1 bf16, 0 fp32) with a dense last dim,
// strides in elements; a_log (nh,) and h_out (b, nh, hd, ds) contiguous
// float32.  Needs 1 <= chunk <= 64 dividing S and hd, ds in {16, 32, 64,
// 128}.  Returns cudaGetLastError() after the launch.
extern "C" int ssd(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, void* y, void* h_out,
                   long long x_sb, long long x_ss, long long x_sh,
                   long long dt_sb, long long dt_ss, long long dt_sh,
                   long long y_sb, long long y_ss, long long y_sh,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, int batch, int s_len, int nh, int hd,
                   int ds, int chunk, int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || s_len % chunk != 0) {
    return cudaErrorInvalidValue;
  }
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh},
      ys{y_sb, y_ss, y_sh}, bs{b_sb, b_ss, 0}, cs{c_sb, c_ss, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(hd, ds, x, dt, a_log, bm, cm, y, h_out,
                                   xs, dts, ys, bs, cs, batch, s_len, nh,
                                   chunk, st);
  }
  return dispatch<float>(hd, ds, x, dt, a_log, bm, cm, y, h_out, xs, dts,
                         ys, bs, cs, batch, s_len, nh, chunk, st);
}
