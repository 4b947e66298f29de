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
// and the last S is the float32 final state.
//
// What bounds it on an H100: bytes.  At rwkv6-7b's prefill shape (b 4,
// S 2048, 64 heads of 64, chunk 64, bf16) the function reads r, k, v and
// logw once and writes o and the final state: 339.7 MB, 0.1014 ms at
// 3.35 TB/s.  Its least work besides is about 1.4e10 flops of products
// (0.014 ms on bf16 tensor cores) and one exponential per decay element,
// b S nh hd = 3.4e7 (0.008 ms on the SFUs: 132 SMs x 16 a clock x 1.98
// GHz = 4.18e12 a second).  A design pays more exponentials than that:
// the one a kernel evaluates is its own floor (chip_smoke.py prints both).
//
// Two kernels, chosen by type and head dim (ops.kernel_symbol):
//
// wkv6_mma_kernel<HD>, bf16 at hd 16, 32 and 64 (the model's path).
//   The decay is factored over sub-blocks of 16 rows (one mma M tile).
//   For t in sub-block i, which starts at row b_i, and s < b_i,
//       exp(W_{t-1} - W_s) = exp(W_{t-1} - W_{b_i-1}) exp(W_{b_i-1} - W_s),
//   and both exponents are <= 0 because W falls monotonically, so
//   r~ = r exp(W_{t-1} - W_{b_i-1}) and k~ = k exp(W_{b_i-1} - W_s) are
//   bounded by r and k and every off-diagonal sub-block pair is one
//   tensor-core product r~ k~^T.  Inside a diagonal sub-block the same
//   factoring at W_{b_i+7} makes its lower-left 8 x 8 quadrant one more
//   product; only its two diagonal 8 x 8 quadrants keep one exponential
//   per (t, s, d) term with s < t (14,336 a chunk of 64 at hd 64, against
//   129,024 unfactored).  With the factors a chunk evaluates 35,072
//   exponentials, 2.9e8 a call at the model's shape (0.069 ms on the
//   SFUs, as ex2.approx.ftz).  No exponent evaluated is positive.
//   Eight warps.  Warp i < 4 computes the outputs of sub-block i: r^ S,
//   the off-diagonal scores and scores V.  Warp i + 4 sums W (with the
//   other three), computes sub-block i's diagonal scores and hands them
//   over through shared memory and a named barrier, then updates rows
//   16 i .. 16 i + 15 of the state, which stays float32 in its mma
//   accumulator fragments across chunks (scaled by exp(W_last), then
//   K^T V accumulated into it); r^ S reads bf16 copies of S written once
//   a chunk.  The two roles run separate loops that meet at named
//   barriers, so neither holds the other's registers.  r~ k~^T, scores
//   V, r^ S and K^T V are mma.sync m16n8k16 with bf16 operands and
//   float32 sums.  One bf16 copy of a computed operand loses too much:
//   over the model's 3.4e7 outputs a few near 0, whose terms are large,
//   fall outside the reference's 6e-2 tolerance
//   (tests/test_torch_scan_blocking.py).  So every operand that is not
//   an input (r~, k~, the scores, r^, S, K^) goes as two bf16 parts, hi
//   + lo: a product of two such is three mmas (hi hi, hi lo, lo hi), of
//   one such and an input two.  The next chunk's r, k, v and logw tiles
//   load with cp.async into a second stage while this chunk computes.
//   The in-chunk cumsum is computed in the block; r, k, v and logw are
//   read through (b, S, nh, hd) strides, rows 16-byte aligned (the
//   wrapper copies a view that is not).  Shared memory: 114,720 bytes at
//   hd 64, two blocks an SM.
//
// wkv6_fwd_kernel<T, HD>, float32 (and bf16 at hd 128): plain float32
//   FMAs from shared memory, one exp2f per (t, s, d) term, one block per
//   (batch, head) looping over the chunks with S in shared memory.  Each
//   thread owns a 4 x 4 patch of the (t, s) score tile and loops over d;
//   for s < t every exponent is <= 0 (clamped at 0, which only the masked
//   s >= t entries reach).  Exponents are in log2 units.  256 threads form
//   a 16 x 16 grid over each output tile (rows ty + 16 i, columns
//   tx + 16 j; rows padded by one float).  Shared memory (chunks of 64):
//   100,096 bytes at hd = 64, 215,296 bytes at hd = 128.
//
// The TPU kernel's grid (b, nh, chunk) runs its chunk axis in order and
// carries S in VMEM scratch, and materialises the (Q, Q, hd) decay tensor
// (1 MiB of float32 at chunk 64), which no SM can hold.  Blocks on the
// H100 run in no order, so one block owns one (batch, head) and loops
// over the chunks; the wrapper enqueues nothing but the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ------------------------------------------------------------------- //
// bf16 inputs, hd 16, 32 and 64: tensor cores (mma.sync m16n8k16)
// ------------------------------------------------------------------- //
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // rows of a chunk tile (chunk <= 64)
constexpr int kSub = 16;           // rows of a sub-block: one mma M tile
constexpr int kMmaThreads = 256;   // two warps a sub-block
constexpr int kBlockBar = 6;       // named barrier of all the block's warps
constexpr int kDiagLd = kSub + 1;  // row stride of the diagonal scratch

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// B fragment (16 x 8, col) of a [k][n] row-major tile, k rows from p
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(  // no memory access: free to be scheduled around other products
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the SFU (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to 0; every argument here is <= 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as two bf16 pairs, hi + lo: a ~ hi.x + lo.x to 16 bits
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <int HD>
struct MmaLayout {
  static constexpr int RS = HD + 8;  // bf16 row stride: 16-byte rows,
                                     // conflict-free fragment reads
  static constexpr int WS = HD + 4;  // float32 row stride of W
  static constexpr int kTileElems = kTile * RS;
  static constexpr size_t tiles = sizeof(bf16) * 2 * 4 * kTileElems;
  static constexpr size_t state = sizeof(bf16) * 2 * HD * RS;  // hi, lo
  static constexpr size_t w = sizeof(float) * (kTile + 2) * WS;
  static constexpr size_t diag = sizeof(float) * 4 * kSub * kDiagLd;
  static constexpr size_t bytes = tiles + state + w + diag + sizeof(float) * HD;
};

// rows [t0, t0 + q) of r, k, v and logw into one stage, 16 bytes a copy
template <int HD>
__device__ __forceinline__ void load_chunk(bf16* stage,
                                           const bf16* const (&src)[4],
                                           const long long (&stride)[4],
                                           int t0, int q, int tid) {
  constexpr int RS = MmaLayout<HD>::RS;
  constexpr int kPieces = HD / 8;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    for (int p = tid; p < q * kPieces; p += kMmaThreads) {
      const int t = p / kPieces;
      const int c8 = (p % kPieces) * 8;
      cp_async16(stage + m * MmaLayout<HD>::kTileElems + t * RS + c8,
                 src[m] + (t0 + t) * stride[m] + c8);
    }
  }
}

// the state fragments of one warp (rows d0 .. d0 + 15) into the hi and
// lo bf16 copies of S
template <int HD>
__device__ __forceinline__ void store_state(const float (&st)[HD / 8][4],
                                            bf16* hi, bf16* lo, int d0,
                                            int g, int c) {
  constexpr int RS = MmaLayout<HD>::RS;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = 8 * nt + 2 * c;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int off = (d0 + g + 8 * rr) * RS + col;
      split_bf16(st[nt][2 * rr], st[nt][2 * rr + 1],
                 *reinterpret_cast<uint32_t*>(hi + off),
                 *reinterpret_cast<uint32_t*>(lo + off));
    }
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// (t, s), s < t, of strict pair p of a 16 x 16 diagonal sub-block
__device__ __forceinline__ void diag_pair(int p, int& t, int& s) {
  t = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
  if (t * (t - 1) / 2 > p) --t;
  if (t * (t + 1) / 2 <= p) ++t;
  s = p - t * (t - 1) / 2;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
    wkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    bf16* __restrict__ o, float* __restrict__ s_out,
                    Strides rs, Strides ks, Strides vs, Strides ws,
                    Strides os, int s_len, int nh, int q) {
  using L = MmaLayout<HD>;
  constexpr int RS = L::RS;
  constexpr int WS = L::WS;
  constexpr int KT = HD / 16;  // k-steps over d
  constexpr int NT = HD / 8;   // n-tiles over e (outputs, state columns)
  constexpr int MT = HD / 16;  // m-tiles of the state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);   // [stage][r k v logw]
  bf16* sbh = reinterpret_cast<bf16*>(smem_raw + L::tiles);  // S [d][e], hi
  bf16* sbl = sbh + HD * RS;                                 // and lo
  float* wf = reinterpret_cast<float*>(smem_raw + L::tiles + L::state);
  float* dg = wf + (kTile + 2) * WS;  // per sub-block: diagonal scores
  float* uf = dg + 4 * kSub * kDiagLd;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (group)
  const int c = lane % 4;  // fragment column pair
  // warp w < 4 computes the outputs of sub-block w; warp w + 4 its
  // diagonal scores, then rows 16 w .. 16 w + 15 of the state (w < MT)
  const int sub = warp % 4;
  const bool out_warp = warp < 4;
  const bool state_warp = !out_warp && sub < MT;
  const int row0 = kSub * sub;
  const int d0 = 16 * sub;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bf16* const src[4] = {r + b * rs.b + h * rs.h, k + b * ks.b + h * ks.h,
                              v + b * vs.b + h * vs.h,
                              logw + b * ws.b + h * ws.h};
  const long long stride[4] = {rs.s, ks.s, vs.s, ws.s};
  bf16* ob = o + b * os.b + h * os.h;
  const long long state = (static_cast<long long>(b) * nh + h) * HD * HD;
  const int n_chunks = s_len / q;

  load_chunk<HD>(tiles, src, stride, 0, q, tid);
  cp_async_commit();
  // rows at or past q stay zero in both stages: zero logw keeps W flat
  // there, zero r and k keep them out of every sum
  for (int i = tid; i < 2 * 4 * (kTile - q) * RS; i += kMmaThreads) {
    const int tile = i / ((kTile - q) * RS);
    const int off = i % ((kTile - q) * RS);
    tiles[tile * L::kTileElems + q * RS + off] = __float2bfloat16(0.f);
  }
  for (int d = tid; d < HD; d += kMmaThreads) {
    wf[d] = 0.f;  // W_{-1}
    uf[d] = u[h * HD + d];
  }

  if (out_warp) {
    // ---- warps 0-3: the outputs of sub-block `sub`
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int t0 = ci * q;
      cp_async_wait_all();
      bar_sync(kBlockBar, kMmaThreads);  // chunk ci has landed; chunk ci - 1
      if (ci + 1 < n_chunks) {            // is done with the other stage
        load_chunk<HD>(tiles + ((ci + 1) % 2) * 4 * L::kTileElems, src,
                       stride, t0 + q, q, tid);
      }
      cp_async_commit();
      const bf16* rt = tiles + (ci % 2) * 4 * L::kTileElems;
      const bf16* kt = rt + L::kTileElems;
      const bf16* vt = kt + L::kTileElems;
      bar_sync(kBlockBar, kMmaThreads);  // W is ready
      const float* wb = wf + row0 * WS;  // W_{b_i - 1} of this sub-block
      float* dgw = dg + sub * kSub * kDiagLd;
      if (row0 < q) {
        // ---- the outputs of sub-block `sub`
        float oacc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
        }
        // A fragments: r~ (hi, lo) and r^ = r~ exp(W_{b_i - 1}) = r exp(W_{t-1});
        // register j holds row row0 + g + 8 (j % 2), columns
        // 16 kk + 2 c + 8 (j / 2) + {0, 1}
        uint32_t ahi[KT][4], alo[KT][4];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t rh[4], rl[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int d = 16 * kk + 2 * c + 8 * half;
            const float2 base = f2(wb + d);
            const float e0 = fast_exp2(base.x);
            const float e1 = fast_exp2(base.y);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int t = row0 + g + 8 * rr;
              const float2 rv = bf2(rt + t * RS + d);
              const float2 wt = f2(wf + t * WS + d);  // W_{t-1}
              const float x0 = rv.x * fast_exp2(fminf(wt.x - base.x, 0.f));
              const float x1 = rv.y * fast_exp2(fminf(wt.y - base.y, 0.f));
              split_bf16(x0, x1, ahi[kk][2 * half + rr], alo[kk][2 * half + rr]);
              split_bf16(x0 * e0, x1 * e1, rh[2 * half + rr], rl[2 * half + rr]);
            }
          }
          // o = r^ S, both as hi + lo, S from its bf16 copies [d][e]
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bh[2], bl[2];
            ldmatrix_x2_trans(bh, sbh + (16 * kk + lane % 16) * RS + 8 * nt);
            ldmatrix_x2_trans(bl, sbl + (16 * kk + lane % 16) * RS + 8 * nt);
            mma_bf16(oacc[nt], rh, bh);
            mma_bf16(oacc[nt], rh, bl);
            mma_bf16(oacc[nt], rl, bh);
          }
        }

        // k-step j of scores v: score tiles 2 j and 2 j + 1, as hi + lo,
        // are its A fragment.  Tiles of earlier sub-blocks (j < sub) are
        // r~ k~^T; the diagonal one (j = sub) comes from the state warp.
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) {
          if (j > sub) break;
          float sc[2][4];
          if (j < sub) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              sc[h2][0] = sc[h2][1] = sc[h2][2] = sc[h2][3] = 0.f;
              const int s = 16 * j + 8 * h2 + g;
#pragma unroll
              for (int kk = 0; kk < KT; ++kk) {
                uint32_t bhi[2], blo[2];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int d = 16 * kk + 2 * c + 8 * half;
                  const float2 base = f2(wb + d);
                  const float2 kv = bf2(kt + s * RS + d);
                  const float2 wsv = f2(wf + (s + 1) * WS + d);  // W_s
                  split_bf16(kv.x * fast_exp2(fminf(base.x - wsv.x, 0.f)),
                             kv.y * fast_exp2(fminf(base.y - wsv.y, 0.f)),
                             bhi[half], blo[half]);
                }
                mma_bf16(sc[h2], ahi[kk], bhi);
                mma_bf16(sc[h2], ahi[kk], blo);
                mma_bf16(sc[h2], alo[kk], bhi);
              }
            }
          } else {
            bar_sync(1 + sub, 64);  // the diagonal scores are written
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int tl = g + 8 * (e / 2);
                const int sl = 8 * h2 + 2 * c + e % 2;
                sc[h2][e] = sl <= tl ? dgw[tl * kDiagLd + sl] : 0.f;
              }
            }
          }
          uint32_t phi[4], plo[4];
          split_bf16(sc[0][0], sc[0][1], phi[0], plo[0]);
          split_bf16(sc[0][2], sc[0][3], phi[1], plo[1]);
          split_bf16(sc[1][0], sc[1][1], phi[2], plo[2]);
          split_bf16(sc[1][2], sc[1][3], phi[3], plo[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bv[2];
            ldmatrix_x2_trans(bv, vt + (16 * j + lane % 16) * RS + 8 * nt);
            mma_bf16(oacc[nt], phi, bv);
            mma_bf16(oacc[nt], plo, bv);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = row0 + g + 8 * rr;
          if (t < q) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              *reinterpret_cast<uint32_t*>(ob + (t0 + t) * os.s + 8 * nt +
                                           2 * c) =
                  pack_bf16(oacc[nt][2 * rr], oacc[nt][2 * rr + 1]);
            }
          }
        }
      }
      bar_sync(kBlockBar, kMmaThreads);  // done with the copies of S
    }
    return;
  }

  // ---- warps 4-7: W, the diagonal scores of sub-block `sub`, and
  // rows 16 sub .. 16 sub + 15 of the state (sub < MT)
  // the state of a state warp: element e of tile nt sits at row
  // d0 + g + 8 (e / 2), column 8 nt + 2 c + e % 2
  float st[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + g + 8 * (e / 2);
      const int col = 8 * nt + 2 * c + e % 2;
      st[nt][e] = (state_warp && s0 != nullptr) ? s0[state + d * HD + col]
                                                : 0.f;
    }
  }
  if (state_warp) store_state<HD>(st, sbh, sbl, d0, g, c);

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * q;
    cp_async_wait_all();
    bar_sync(kBlockBar, kMmaThreads);  // chunk ci has landed; chunk ci - 1
    if (ci + 1 < n_chunks) {            // is done with the other stage
      load_chunk<HD>(tiles + ((ci + 1) % 2) * 4 * L::kTileElems, src,
                     stride, t0 + q, q, tid);
    }
    cp_async_commit();
    const bf16* rt = tiles + (ci % 2) * 4 * L::kTileElems;
    const bf16* kt = rt + L::kTileElems;
    const bf16* vt = kt + L::kTileElems;
    const bf16* lt = vt + L::kTileElems;

    // ---- W in log2 units, wf row t + 1 = W_t: the state warps, a thread
    // per channel and half of the rows, its 32 values loaded before the
    // sum; the second half adds the first half's total
    {
      const int d = (tid - 128) % 64;
      const int t_half = (tid - 128) / 64 * (kTile / 2);
      float x[kTile / 2];
      if (d < HD) {
#pragma unroll
        for (int t = 0; t < kTile / 2; ++t) {
          x[t] = __bfloat162float(lt[(t_half + t) * RS + d]);
        }
#pragma unroll
        for (int t = 1; t < kTile / 2; ++t) x[t] += x[t - 1];
        if (t_half == 0) wf[(kTile + 1) * WS + d] = x[kTile / 2 - 1];
      }
      bar_sync(5, 128);  // the first half's totals are in the spare row
      if (d < HD) {
        const float offset = t_half ? wf[(kTile + 1) * WS + d] : 0.f;
#pragma unroll
        for (int t = 0; t < kTile / 2; ++t) {
          wf[(t_half + t + 1) * WS + d] = (x[t] + offset) * kLog2e;
        }
      }
    }
    bar_sync(kBlockBar, kMmaThreads);  // W is ready
    const float* wl = wf + q * WS;   // W_last (flat past q)
    const float* wb = wf + row0 * WS;  // W_{b_i - 1} of this sub-block
    float* dgw = dg + sub * kSub * kDiagLd;

    if (row0 < q) {
      // ---- the diagonal sub-block.  Its lower-left 8 x 8 quadrant
      // (t in rows 8-15, s in rows 0-7) is factored at W_{b_i+7} like
      // the off-diagonal sub-blocks: one product r~' k~'^T, A rows 0-7
      // zero.  The two diagonal 8 x 8 quadrants are exact: one exponential
      // per term with s < t, two pairs a lane at a time.
      {
        const float* wq = wb + 8 * WS;  // W_{b_i + 7}
        float bl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
          uint32_t bh[2], bq[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int d = 16 * kk + 2 * c + 8 * half;
            const float2 base = f2(wq + d);
            const int t = row0 + 8 + g;
            const float2 rv = bf2(rt + t * RS + d);
            const float2 wt = f2(wf + t * WS + d);        // W_{t-1}
            split_bf16(rv.x * fast_exp2(fminf(wt.x - base.x, 0.f)),
                       rv.y * fast_exp2(fminf(wt.y - base.y, 0.f)),
                       ah[1 + 2 * half], al[1 + 2 * half]);
            const int s = row0 + g;
            const float2 kv = bf2(kt + s * RS + d);
            const float2 wsv = f2(wf + (s + 1) * WS + d);  // W_s
            split_bf16(kv.x * fast_exp2(fminf(base.x - wsv.x, 0.f)),
                       kv.y * fast_exp2(fminf(base.y - wsv.y, 0.f)),
                       bh[half], bq[half]);
          }
          mma_bf16(bl, ah, bh);
          mma_bf16(bl, ah, bq);
          mma_bf16(bl, al, bh);
        }
        dgw[(8 + g) * kDiagLd + 2 * c] = bl[2];
        dgw[(8 + g) * kDiagLd + 2 * c + 1] = bl[3];
      }
      {
        constexpr int kQuadPairs = 8 * 7 / 2;
        const int p1 = lane + 32;
        int ta, sa, tb, sb;
        diag_pair(lane % kQuadPairs, ta, sa);
        const int qa = 8 * (lane / kQuadPairs);
        ta += qa;
        sa += qa;
        const int pb = p1 < 2 * kQuadPairs ? p1 : lane;
        diag_pair(pb % kQuadPairs, tb, sb);
        const int qb = 8 * (pb / kQuadPairs);
        tb += qb;
        sb += qb;
        const bf16* ra = rt + (row0 + ta) * RS;
        const bf16* ka = kt + (row0 + sa) * RS;
        const bf16* rb = rt + (row0 + tb) * RS;
        const bf16* kb = kt + (row0 + sb) * RS;
        const float* wta = wf + (row0 + ta) * WS;      // W_{t-1}
        const float* wsa = wf + (row0 + sa + 1) * WS;  // W_s
        const float* wtb = wf + (row0 + tb) * WS;
        const float* wsb = wf + (row0 + sb + 1) * WS;
        float acc_a = 0.f, acc_b = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 2) {
          const float2 r_a = bf2(ra + d), k_a = bf2(ka + d);
          const float2 r_b = bf2(rb + d), k_b = bf2(kb + d);
          const float2 x_a = f2(wta + d), y_a = f2(wsa + d);
          const float2 x_b = f2(wtb + d), y_b = f2(wsb + d);
          acc_a = fmaf(r_a.x * k_a.x, fast_exp2(fminf(x_a.x - y_a.x, 0.f)),
                       acc_a);
          acc_a = fmaf(r_a.y * k_a.y, fast_exp2(fminf(x_a.y - y_a.y, 0.f)),
                       acc_a);
          acc_b = fmaf(r_b.x * k_b.x, fast_exp2(fminf(x_b.x - y_b.x, 0.f)),
                       acc_b);
          acc_b = fmaf(r_b.y * k_b.y, fast_exp2(fminf(x_b.y - y_b.y, 0.f)),
                       acc_b);
        }
        dgw[ta * kDiagLd + sa] = acc_a;
        if (p1 < 2 * kQuadPairs) dgw[tb * kDiagLd + sb] = acc_b;
      }
      if (lane < kSub) {
        const bf16* rp = rt + (row0 + lane) * RS;
        const bf16* kp = kt + (row0 + lane) * RS;
        float acc = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 2) {
          const float2 rv = bf2(rp + d);
          const float2 kv = bf2(kp + d);
          acc = fmaf(rv.x * uf[d], kv.x, acc);
          acc = fmaf(rv.y * uf[d + 1], kv.y, acc);
        }
        dgw[lane * kDiagLd + lane] = acc;
      }
      __threadfence_block();
      bar_arrive(1 + sub, 64);
    }

    // ---- S = diag(exp(W_last)) S + K^T v, K = k exp(W_last - W)
    if (state_warp) {
      const float gm0 = fast_exp2(wl[d0 + g]);
      const float gm1 = fast_exp2(wl[d0 + g + 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        st[nt][0] *= gm0;
        st[nt][1] *= gm0;
        st[nt][2] *= gm1;
        st[nt][3] *= gm1;
      }
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        if (16 * j < q) {
          // A fragment of K^T as hi + lo: register e holds row
          // d0 + g + 8 (e % 2), columns s = 16 j + 2 c + 8 (e / 2) + {0, 1}
          uint32_t kh[4], kl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + g + 8 * (e % 2);
            const int s = 16 * j + 2 * c + 8 * (e / 2);
            const float w_last = wl[d];
            split_bf16(__bfloat162float(kt[s * RS + d]) *
                           fast_exp2(fminf(w_last - wf[(s + 1) * WS + d], 0.f)),
                       __bfloat162float(kt[(s + 1) * RS + d]) *
                           fast_exp2(fminf(w_last - wf[(s + 2) * WS + d], 0.f)),
                       kh[e], kl[e]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bv[2];
            ldmatrix_x2_trans(bv, vt + (16 * j + lane % 16) * RS + 8 * nt);
            mma_bf16(st[nt], kh, bv);
            mma_bf16(st[nt], kl, bv);
          }
        }
      }
    }
    bar_sync(kBlockBar, kMmaThreads);  // the outputs are done with S
    if (state_warp) store_state<HD>(st, sbh, sbl, d0, g, c);
  }


  if (state_warp) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_out[state + (d0 + g + 8 * (e / 2)) * HD + 8 * nt + 2 * c + e % 2] =
            st[nt][e];
      }
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       void* o, void* s_out, Strides rs, Strides ks,
                       Strides vs, Strides ws, Strides os, int batch,
                       int s_len, int nh, int q, cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, batch);
  wkv6_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<bf16*>(o), static_cast<float*>(s_out), rs, ks, vs, ws, os,
      s_len, nh, q);
  return cudaGetLastError();
}

// every row of a (b, S, nh, hd) bf16 operand starts on a 16-byte boundary
bool rows_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
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
// 32, 64, 128}; bf16 at hd <= 64 (the tensor-core kernel) also needs
// every row of r, k, v and logw on a 16-byte boundary and even o strides.
// Returns cudaGetLastError() after the launch.
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
  if (is_bf16 && hd <= 64) {
    if (!rows_aligned(r, rs) || !rows_aligned(k, ks) || !rows_aligned(v, vs) ||
        !rows_aligned(logw, ws) || reinterpret_cast<uintptr_t>(o) % 4 != 0 ||
        o_sb % 2 != 0 || o_ss % 2 != 0 || o_sh % 2 != 0) {
      return cudaErrorInvalidValue;
    }
    switch (hd) {
      case 16: return launch_mma<16>(r, k, v, logw, u, s0, o, s_out, rs, ks,
                                     vs, ws, os, batch, s_len, nh, chunk, st);
      case 32: return launch_mma<32>(r, k, v, logw, u, s0, o, s_out, rs, ks,
                                     vs, ws, os, batch, s_len, nh, chunk, st);
      case 64: return launch_mma<64>(r, k, v, logw, u, s0, o, s_out, rs, ks,
                                     vs, ws, os, batch, s_len, nh, chunk, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (is_bf16) {  // hd 128: the FMA kernel
    if (hd != 128) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16, 128>(r, k, v, logw, u, s0, o, s_out, rs, ks,
                                      vs, ws, os, batch, s_len, nh, chunk,
                                      st);
  }
  return dispatch<float>(hd, r, k, v, logw, u, s0, o, s_out, rs, ks, vs, ws,
                         os, batch, s_len, nh, chunk, st);
}
