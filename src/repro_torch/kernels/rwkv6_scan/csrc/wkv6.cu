// Chunked RWKV6 (Finch) WKV scan, forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py:86
// (_kernel, launched by wkv6_fwd) together with the precompute of its
// wrapper ops.wkv6.  Per (batch, head), in each chunk of Q tokens, with W
// the inclusive in-chunk cumsum of logw (W_{-1} = 0) and S the (hd, hd)
// state entering the chunk (S0, or zero):
//
//     score[t,s] = sum_d r[t,d] k[s,d] exp(W_{t-1,d} - W_{s,d})  (s < t)
//     score[t,t] = sum_d r[t,d] u[d] k[t,d]                        (bonus)
//     o[t]       = score[t,:] @ v + (r[t] * exp(W_{t-1})) @ S
//     S          = diag(exp(W_last)) S + (k * exp(W_last - W))^T @ v
//
// and the last S is the float32 final state.  The arithmetic is float32.
//
// What bounds it on an H100: bytes.  At rwkv6-7b's prefill shape (b 4,
// S 2048, 64 heads of 64, chunk 64, bf16) the function reads r, k, v and
// logw once and writes o and the final state: about 340 MB, 0.101 ms at
// 3.35 TB/s.  It does about 1.4e10 flops (0.014 ms on tensor cores) and
// about 1.12e9 exponentials (0.017 ms at the 67 TFLOP/s float32 rate).
// This first version runs plain float32 FMAs and one exp2f per (t, s, d)
// term from shared memory, far above that bound; its measured time sits
// beside the bound in PERF.md.
//
// Design.  The decay is per channel and depends on the data, so the
// intra-chunk term is not a plain matrix product: the decay stays inside
// the sum over d.  Factoring it as exp(W_{t-1}) * exp(-W_s) overflows
// float32 (W is a long negative cumsum).  The TPU kernel materialises the
// (Q, Q, hd) decay tensor in VMEM (1 MiB of float32 at the model's chunk
// of 64), which no SM can hold.  Here each thread owns a 4 x 4 patch of
// the (t, s) score tile and loops over d, computing each exponent from
// the two cumsum rows; for s < t every exponent is <= 0, so nothing
// overflows (the argument is clamped at 0, which only the masked s >= t
// entries of the diagonal tiles reach).  Tile pairs above the diagonal
// are skipped.  Exponents are kept in log2 units so each term costs one
// exp2f.  Factoring the decay over sub-blocks (to move the products onto
// tensor cores) is later work.
//
// The TPU kernel's grid (b, nh, chunk) runs its chunk axis in order and
// carries S in VMEM scratch.  Blocks on the H100 run in no order, so one
// block owns one (batch, head) and loops over the chunks, keeping S (16 KB
// at hd 64) in shared memory for the whole sequence.  The in-chunk cumsum
// (a warp scan per channel) is computed in the block, so the wrapper
// enqueues nothing but the launch; r, k, v and logw are read through
// (b, S, nh, hd) strides, so the model's tensors are never transposed.
// 256 threads form a 16 x 16 grid over each output tile (rows ty + 16 i,
// columns tx + 16 j; rows padded by one float, so operand reads are
// broadcasts or hit 16 distinct banks).
//
// hd is a template parameter (16, 32, 64 or 128), so each thread's
// patches are fixed register arrays with no run-time guards.
//
// Shared memory (sized for chunks of 64): 100,096 bytes at hd = 64 (two
// blocks per SM), 215,296 bytes at hd = 128; each launch raises the
// dynamic limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;    // rows of a chunk tile: 4 x 16
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides; the head dim is dense
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kMaxChunk * (HD + 1) +
                          kMaxChunk * (kMaxChunk + 1) + HD * (HD + 1) + HD);
}

// HD (a multiple of 16) is compile-time, so each thread's patch of every
// product is a fixed set of registers with no guards; the chunk length
// q <= 64 is not: rows past q are clamped on load and not stored.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    T* __restrict__ o, float* __restrict__ s_out,
                    Strides rs, Strides ks, Strides vs, Strides ws,
                    Strides os, int s_len, int nh, int q) {
  constexpr int P = HD + 1;             // padded rows
  constexpr int SP = kMaxChunk + 1;
  constexpr int HJ = HD / 16;           // tiles over hd
  extern __shared__ float smem[];
  float* rt = smem;                 // q x P: r, then r * exp(W_{t-1})
  float* kt = rt + kMaxChunk * P;   // q x P: k, then k * exp(W_last - W_s)
  float* vt = kt + kMaxChunk * P;   // q x P: v
  float* wt = vt + kMaxChunk * P;   // q x P: logw, then W in log2 units
  float* st = wt + kMaxChunk * P;   // q x SP: scores (strictly lower + bonus)
  float* S = st + kMaxChunk * SP;   // HD x P: the state
  float* ut = S + HD * P;           // HD: u

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int row[4], col[4];  // this thread's chunk rows (t) and columns (s)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = min(ty + 16 * i, q - 1);
    col[i] = min(tx + 16 * i, q - 1);
  }

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* wb = logw + b * ws.b + h * ws.h;
  T* ob = o + b * os.b + h * os.h;
  const long long state = (static_cast<long long>(b) * nh + h) * HD * HD;

  for (int i = tid; i < HD * HD; i += kThreads) {
    S[(i / HD) * P + i % HD] = s0 != nullptr ? s0[state + i] : 0.f;
  }
  for (int d = tid; d < HD; d += kThreads) ut[d] = u[h * HD + d];

  for (int t0 = 0; t0 < s_len; t0 += q) {
    // ---- load the chunk
    for (int i = tid; i < q * HD; i += kThreads) {
      const int t = i / HD;
      const int d = i % HD;
      rt[t * P + d] = to_f32(rb[(t0 + t) * rs.s + d]);
      kt[t * P + d] = to_f32(kb[(t0 + t) * ks.s + d]);
      vt[t * P + d] = to_f32(vb[(t0 + t) * vs.s + d]);
      wt[t * P + d] = to_f32(wb[(t0 + t) * ws.s + d]);
    }
    __syncthreads();

    // ---- W: inclusive cumsum over t of each channel, a warp per channel
    for (int d = warp; d < HD; d += kWarps) {
      float a0 = lane < q ? wt[lane * P + d] : 0.f;
      float a1 = lane + 32 < q ? wt[(lane + 32) * P + d] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n0 = __shfl_up_sync(0xffffffffu, a0, off);
        const float n1 = __shfl_up_sync(0xffffffffu, a1, off);
        if (lane >= off) {
          a0 += n0;
          a1 += n1;
        }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      if (lane < q) wt[lane * P + d] = a0 * kLog2e;
      if (lane + 32 < q) wt[(lane + 32) * P + d] = a1 * kLog2e;
    }
    __syncthreads();

    // ---- scores: strictly lower part, decay inside the sum over d
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float rv[4], wr[4], kv[4], wk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rv[i] = rt[row[i] * P + d];
          wr[i] = wt[max(row[i] - 1, 0) * P + d];  // W_{t-1}
          kv[i] = kt[col[i] * P + d];
          wk[i] = wt[col[i] * P + d];              // W_s
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            acc[i][j] = fmaf(rv[i] * kv[j],
                             exp2f(fminf(wr[i] - wk[j], 0.f)), acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i;
          const int s = tx + 16 * j;
          if (t < q && s < q && s != t) st[t * SP + s] = s < t ? acc[i][j] : 0.f;
        }
      }
    }
    // ---- the diagonal: the u bonus, a warp per row
    for (int t = warp; t < q; t += kWarps) {
      float part = 0.f;
      for (int d = lane; d < HD; d += 32) {
        part = fmaf(rt[t * P + d] * ut[d], kt[t * P + d], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0) st[t * SP + t] = part;
    }
    __syncthreads();

    // ---- r * exp(W_{t-1}) and k * exp(W_last - W_s), in place
    for (int i = tid; i < q * HD; i += kThreads) {
      const int t = i / HD;
      const int d = i % HD;
      if (t > 0) rt[t * P + d] *= exp2f(wt[(t - 1) * P + d]);
      kt[t * P + d] *= exp2f(wt[(q - 1) * P + d] - wt[t * P + d]);
    }
    __syncthreads();

    // ---- o = scores @ v + (r * exp(W_{t-1})) @ S
    {
      float acc[4][HJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < HJ; ++j) acc[i][j] = 0.f;
      }
      for (int s = 0; s < q; ++s) {
        float sv[4], vv[HJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = st[row[i] * SP + s];
#pragma unroll
        for (int j = 0; j < HJ; ++j) vv[j] = vt[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < HJ; ++j) acc[i][j] = fmaf(sv[i], vv[j], acc[i][j]);
        }
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float rv[4], sv[HJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) rv[i] = rt[row[i] * P + d];
#pragma unroll
        for (int j = 0; j < HJ; ++j) sv[j] = S[d * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < HJ; ++j) acc[i][j] = fmaf(rv[i], sv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= q) continue;
#pragma unroll
        for (int j = 0; j < HJ; ++j) {
          ob[(t0 + t) * os.s + tx + 16 * j] = from_f32<T>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of S for this chunk is done

    // ---- S = diag(exp(W_last)) S + (k * exp(W_last - W))^T @ v
    {
      float acc[HJ][HJ];
#pragma unroll
      for (int i = 0; i < HJ; ++i) {
#pragma unroll
        for (int j = 0; j < HJ; ++j) acc[i][j] = 0.f;
      }
      for (int s = 0; s < q; ++s) {
        float kv[HJ], vv[HJ];
#pragma unroll
        for (int i = 0; i < HJ; ++i) kv[i] = kt[s * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < HJ; ++j) vv[j] = vt[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < HJ; ++i) {
#pragma unroll
          for (int j = 0; j < HJ; ++j) acc[i][j] = fmaf(kv[i], vv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < HJ; ++i) {
        const int d = ty + 16 * i;
        const float gamma = exp2f(wt[(q - 1) * P + d]);
#pragma unroll
        for (int j = 0; j < HJ; ++j) {
          float* sp = S + d * P + tx + 16 * j;
          *sp = *sp * gamma + acc[i][j];
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites the tiles
  }

  for (int i = tid; i < HD * HD; i += kThreads) {
    s_out[state + i] = S[(i / HD) * P + i % HD];
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* o,
                   void* s_out, Strides rs, Strides ks, Strides vs,
                   Strides ws, Strides os, int batch, int s_len, int nh,
                   int q, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, batch);
  wkv6_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_out), rs, ks, vs, ws, os,
      s_len, nh, q);
  return cudaGetLastError();
}

#define WKV_ARGS \
  r, k, v, logw, u, s0, o, s_out, rs, ks, vs, ws, os, batch, s_len, nh, q, st

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0,
                     void* o, void* s_out, Strides rs, Strides ks,
                     Strides vs, Strides ws, Strides os, int batch,
                     int s_len, int nh, int q, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(WKV_ARGS);
    case 32: return launch<T, 32>(WKV_ARGS);
    case 64: return launch<T, 64>(WKV_ARGS);
    case 128: return launch<T, 128>(WKV_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef WKV_ARGS

}  // namespace

// r, k, v, logw and o (b, S, nh, hd), all of one type (is_bf16: 1 bf16,
// 0 fp32) with a dense head dim, strides in elements; u (nh, hd), s0
// (b, nh, hd, hd; NULL for a zero state) and s_out (b, nh, hd, hd)
// contiguous float32.  Needs 1 <= chunk <= 64 dividing S and hd in {16,
// 32, 64, 128}.  Returns cudaGetLastError() after the launch.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, const void* s0, void* o,
                    void* s_out, long long r_sb, long long r_ss,
                    long long r_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long w_sb, long long w_ss,
                    long long w_sh, long long o_sb, long long o_ss,
                    long long o_sh, int batch, int s_len, int nh, int hd,
                    int chunk, int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || s_len % chunk != 0) {
    return cudaErrorInvalidValue;
  }
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, ws{w_sb, w_ss, w_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(hd, r, k, v, logw, u, s0, o, s_out, rs,
                                   ks, vs, ws, os, batch, s_len, nh, chunk,
                                   st);
  }
  return dispatch<float>(hd, r, k, v, logw, u, s0, o, s_out, rs, ks, vs, ws,
                         os, batch, s_len, nh, chunk, st);
}
