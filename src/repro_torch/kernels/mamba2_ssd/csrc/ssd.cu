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
// and the last h is the float32 final state.
//
// What bounds it on an H100: bytes.  At zamba2-1.2b's prefill shape (b 4,
// S 2048, 64 heads of 64, ds 64, chunk 64, bf16) the function reads x, dt,
// B and C once and writes y and the final state: 141.6 MB, 0.0423 ms at
// 3.35 TB/s, against 1.3e10 flops of products (0.013 ms on bf16 tensor
// cores) and one exponential per decay element, b S nh = 5.2e5 (0.0001
// ms on the SFUs).  The chunked form's decays, 2,080 exponentials a chunk
// of 64 (M's causal half), cost 0.004 ms there.
//
// Two kernels, chosen by type and dims (ops.kernel_symbol):
//
// ssd_mma_kernel<HD, DS>, bf16 at hd and ds 16, 32 and 64 (the model's
//   path).  All four chunk products run on tensor cores (mma.sync
//   m16n8k16, bf16 operands, float32 sums): C B^T; (C B^T * L) xw with
//   L = exp(cum_t - cum_s) masked inside the argument (one exponential
//   per causal (t, s) pair, ex2.approx.ftz: the decay is one scalar per
//   head); C h^T scaled by exp(cum_t); and (xw * tail)^T B into the (hd,
//   ds) state, which stays float32 in accumulator fragments across
//   chunks (state warp w owns rows 16 w .. 16 w + 15), with bf16 copies
//   written once a chunk
//   for C h^T.  One bf16 copy of a computed operand loses too much: over
//   the model's 3.4e7 outputs a few near 0, whose terms are large, fall
//   outside the reference's 5e-2 tolerance
//   (tests/test_torch_scan_blocking.py).  So the decay-masked C B^T, h
//   and xw * tail go as two bf16 parts, hi + lo, in two products each;
//   C, B and xw (rounded to bf16 as the plain version rounds it) go as
//   one.  Eight warps: warp i < 4 owns rows 16 i .. 16 i + 15 of the
//   chunk's outputs; warps 4-7 weight x by dt, scan the cumsum and, while
//   the output warps finish, update rows 16 (i - 4) .. of the state.  The
//   next chunk's x, B and C tiles load with cp.async into a second stage
//   (its dt into registers) while this chunk computes; rows
//   must start on 16-byte boundaries (the wrapper copies a view that does
//   not).  Shared memory: 74,752 bytes at hd = ds = 64, two blocks an SM.
//
// ssd_fwd_kernel<T, HD, DS>, float32 (and bf16 at hd or ds 128): plain
//   float32 FMAs from shared memory; 256 threads form a 16 x 16 grid over
//   each output tile, a thread owning rows ty + 16 i and columns
//   tx + 16 j (rows padded by one float); tile pairs above the diagonal
//   of the causal C.B^T product are skipped.  Shared memory (chunks of
//   64): 83,712 bytes at hd = ds = 64, 182,272 bytes at hd = ds = 128.
//
// The TPU kernel runs a grid (b, nh, chunk) whose last axis is sequential
// and carries h in VMEM scratch.  Blocks on the H100 run in no order, so
// here one block owns one (batch, head) and a loop inside it walks the
// chunks.  The dt-weighting, A and the in-chunk cumsum (a warp scan) are
// computed in the block, so the wrapper enqueues nothing but the launch.
// x (b, S, nh, hd), dt (b, S, nh) and B, C (b, S, ds) are read through
// their strides, so the model's views are never copied or transposed; the
// grid runs heads fastest, so the blocks of one batch row, which share B
// and C, are in flight together and find them in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ------------------------------------------------------------------- //
// bf16 inputs, hd and ds 16, 32 or 64: tensor cores (mma.sync m16n8k16)
// ------------------------------------------------------------------- //
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // rows of a chunk tile (chunk <= 64)
constexpr int kMmaThreads = 256;   // output and state warps, 4 each
constexpr int kBlockBar = 6;       // named barrier of all the block's warps
constexpr float kLog2e = 1.4426950408889634f;

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

// A fragment (16 x 16, row) of a [m][k] row-major tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// B fragment (16 x 8, col) of a [n][k] row-major tile
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// B fragment (16 x 8, col) of a [k][n] row-major tile
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
  asm volatile(
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

template <int HD, int DS>
struct MmaLayout {
  static constexpr int RX = HD + 8;  // bf16 row strides: 16-byte rows,
  static constexpr int RD = DS + 8;  // conflict-free fragment reads
  static constexpr int kStage = kTile * (RX + 2 * RD);  // x, B, C
  static constexpr size_t tiles = sizeof(bf16) * 2 * kStage;
  static constexpr size_t state = sizeof(bf16) * 2 * HD * RD;  // hi, lo
  static constexpr size_t bytes = tiles + state + sizeof(float) * 4 * kTile;
};

// rows [t0, t0 + q) of x, B and C into one stage, 16 bytes a copy
template <int HD, int DS>
__device__ __forceinline__ void load_chunk(bf16* stage, const bf16* xb,
                                           const bf16* bb, const bf16* cb,
                                           long long xs, long long bs,
                                           long long cs, int t0, int q,
                                           int tid) {
  using L = MmaLayout<HD, DS>;
  for (int p = tid; p < q * (HD / 8); p += kMmaThreads) {
    const int t = p / (HD / 8);
    const int c8 = (p % (HD / 8)) * 8;
    cp_async16(stage + t * L::RX + c8, xb + (t0 + t) * xs + c8);
  }
  bf16* bt = stage + kTile * L::RX;
  bf16* ct = bt + kTile * L::RD;
  for (int p = tid; p < q * (DS / 8); p += kMmaThreads) {
    const int t = p / (DS / 8);
    const int c8 = (p % (DS / 8)) * 8;
    cp_async16(bt + t * L::RD + c8, bb + (t0 + t) * bs + c8);
    cp_async16(ct + t * L::RD + c8, cb + (t0 + t) * cs + c8);
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int HD, int DS>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                   const float* __restrict__ a_log, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, bf16* __restrict__ y,
                   float* __restrict__ h_out, Strides xs, Strides dts,
                   Strides ys, Strides bs, Strides cs, int s_len, int nh,
                   int q) {
  using L = MmaLayout<HD, DS>;
  constexpr int RX = L::RX;
  constexpr int RD = L::RD;
  constexpr int KD = DS / 16;  // k-steps over ds
  constexpr int NT = HD / 8;   // n-tiles over hd (outputs)
  constexpr int NS = DS / 8;   // n-tiles over ds (state columns)
  constexpr int MT = HD / 16;  // m-tiles of the state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);           // [stage][x B C]
  bf16* hbh = reinterpret_cast<bf16*>(smem_raw + L::tiles);  // h [d][n], hi
  bf16* hbl = hbh + HD * RD;                                  // and lo
  float* dtw = reinterpret_cast<float*>(smem_raw + L::tiles + L::state);
  float* cum = dtw + 2 * kTile;   // [stage][t] dt, then cum in log2 units
  float* tail = cum + kTile;      // exp(cum_last - cum_t)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (group)
  const int c = lane % 4;  // fragment column pair
  // warp w < 4 computes the outputs of rows 16 w .. 16 w + 15; warp w + 4
  // rows 16 w .. 16 w + 15 of the state (w < MT), and with the others
  // x dt and the cumsum
  const int sub = warp % 4;
  const bool out_warp = warp < 4;
  const bool state_warp = !out_warp && sub < MT;
  const int row0 = 16 * sub;
  const int d0 = 16 * sub;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bf16* xb = x + b * xs.b + h * xs.h;
  const bf16* dtb = dt + b * dts.b + h * dts.h;
  const bf16* bb = bm + b * bs.b;
  const bf16* cb = cm + b * cs.b;
  bf16* yb = y + b * ys.b + h * ys.h;
  const int n_chunks = s_len / q;

  load_chunk<HD, DS>(tiles, xb, bb, cb, xs.s, bs.s, cs.s, 0, q, tid);
  cp_async_commit();
  // rows at or past q stay zero in both stages (and dt there is 0)
  for (int i = tid; i < 2 * (kTile - q) * (RX + 2 * RD); i += kMmaThreads) {
    const int stage = i / ((kTile - q) * (RX + 2 * RD));
    int off = i % ((kTile - q) * (RX + 2 * RD));
    bf16* base = tiles + stage * L::kStage;
    if (off < (kTile - q) * RX) {
      base[q * RX + off] = __float2bfloat16(0.f);
    } else {
      off -= (kTile - q) * RX;
      const int tile = off / ((kTile - q) * RD);
      base[kTile * RX + tile * kTile * RD + q * RD +
           off % ((kTile - q) * RD)] = __float2bfloat16(0.f);
    }
  }
  if (tid < 2 * kTile) {
    dtw[tid] = tid < q ? __bfloat162float(dtb[tid * dts.s]) : 0.f;
  }
  for (int i = tid; i < 2 * HD * RD; i += kMmaThreads) {
    hbh[i] = __float2bfloat16(0.f);  // both copies
  }

  if (out_warp) {
    // ---- warps 0-3: the outputs of rows row0 .. row0 + 15
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int t0 = ci * q;
      cp_async_wait_all();
      bar_sync(kBlockBar, kMmaThreads);  // chunk ci has landed; chunk
      if (ci + 1 < n_chunks) {            // ci - 1 is done with the stage
        load_chunk<HD, DS>(tiles + ((ci + 1) % 2) * L::kStage, xb, bb, cb,
                           xs.s, bs.s, cs.s, t0 + q, q, tid);
      }
      cp_async_commit();
      const bf16* xt = tiles + (ci % 2) * L::kStage;
      const bf16* bt = xt + kTile * RX;
      const bf16* ct = bt + kTile * RD;
      float yacc[NT][4];
      float sc[kTile / 8][4];
      if (row0 < q) {
        uint32_t cf[KD][4];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldmatrix_x4(cf[kk], ct + (row0 + lane % 16) * RD + 16 * kk +
                                  (lane / 16) * 8);
        }
        // C h^T, h from its bf16 copies [d][n], hi + lo
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            const int off = (8 * nt + lane % 8) * RD + 16 * kk +
                            ((lane / 8) % 2) * 8;
            uint32_t bh[2], bl[2];
            ldmatrix_x2(bh, hbh + off);
            ldmatrix_x2(bl, hbl + off);
            mma_bf16(yacc[nt], cf[kk], bh);
            mma_bf16(yacc[nt], cf[kk], bl);
          }
        }
        // C B^T on and below the diagonal
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
          if (nt < 2 * sub + 2) {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
              uint32_t bbf[2];
              ldmatrix_x2(bbf, bt + (8 * nt + lane % 8) * RD + 16 * kk +
                                   ((lane / 8) % 2) * 8);
              mma_bf16(sc[nt], cf[kk], bbf);
            }
          }
        }
      }
      bar_sync(1, kMmaThreads);  // cum and x dt are ready
      if (row0 < q) {
        // y = exp(cum_t) (C h^T) + M xw, M = (C B^T) exp(cum_t - cum_s)
        // masked inside the argument; tiles 2 j and 2 j + 1 of M are the
        // A fragment of k-step j, as hi + lo
        const float e0 = fast_exp2(cum[row0 + g]);
        const float e1 = fast_exp2(cum[row0 + g + 8]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          yacc[nt][0] *= e0;
          yacc[nt][1] *= e0;
          yacc[nt][2] *= e1;
          yacc[nt][3] *= e1;
        }
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          if (nt < 2 * sub + 2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = row0 + g + 8 * (e / 2);
              const int s = 8 * nt + 2 * c + e % 2;
              sc[nt][e] *= fast_exp2(s <= t ? cum[t] - cum[s] : -INFINITY);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) {
          if (j <= sub) {
            uint32_t mhi[4], mlo[4];
            split_bf16(sc[2 * j][0], sc[2 * j][1], mhi[0], mlo[0]);
            split_bf16(sc[2 * j][2], sc[2 * j][3], mhi[1], mlo[1]);
            split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], mhi[2], mlo[2]);
            split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], mhi[3], mlo[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              uint32_t bx[2];
              ldmatrix_x2_trans(bx, xt + (16 * j + lane % 16) * RX + 8 * nt);
              mma_bf16(yacc[nt], mhi, bx);
              mma_bf16(yacc[nt], mlo, bx);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = row0 + g + 8 * rr;
          if (t < q) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              *reinterpret_cast<uint32_t*>(yb + (t0 + t) * ys.s + 8 * nt +
                                           2 * c) =
                  pack_bf16(yacc[nt][2 * rr], yacc[nt][2 * rr + 1]);
            }
          }
        }
      }
      bar_sync(kBlockBar, kMmaThreads);  // done with the copies of h
    }
    return;
  }

  // ---- warps 4-7: x dt, the cumsum, and the state
  const int st_tid = tid - 128;
  float st[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
  }
  const float A2 = -expf(a_log[h]) * kLog2e;  // A in log2 units
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * q;
    cp_async_wait_all();
    bar_sync(kBlockBar, kMmaThreads);  // chunk ci has landed; chunk ci - 1
    float dt_next = 0.f;               // is done with the other stage
    if (ci + 1 < n_chunks) {
      load_chunk<HD, DS>(tiles + ((ci + 1) % 2) * L::kStage, xb, bb, cb,
                         xs.s, bs.s, cs.s, t0 + q, q, tid);
      if (st_tid < q) {
        dt_next = __bfloat162float(dtb[(t0 + q + st_tid) * dts.s]);
      }
    }
    cp_async_commit();
    bf16* xt = tiles + (ci % 2) * L::kStage;
    const bf16* bt = xt + kTile * RX;
    const float* dtc = dtw + (ci % 2) * kTile;

    // xw = x dt rounded to bf16 (as the plain version), in place
    for (int p = st_tid; p < q * (HD / 2); p += kMmaThreads - 128) {
      const int t = p / (HD / 2);
      const int d = (p % (HD / 2)) * 2;
      uint32_t* xp = reinterpret_cast<uint32_t*>(xt + t * RX + d);
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));
      *xp = pack_bf16(xv.x * dtc[t], xv.y * dtc[t]);
    }
    // cum: inclusive scan of dt A over the chunk, two rows a lane
    if (warp == 4) {
      float a0 = dtc[lane] * A2;
      float a1 = dtc[lane + 32] * A2;
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
      const float last = __shfl_sync(0xffffffffu, a1, 31);  // flat past q
      cum[lane] = a0;
      cum[lane + 32] = a1;
      tail[lane] = fast_exp2(fminf(last - a0, 0.f));
      tail[lane + 32] = fast_exp2(fminf(last - a1, 0.f));
    }
    __threadfence_block();
    bar_arrive(1, kMmaThreads);  // the output warps may read cum and xw
    bar_sync(2, kMmaThreads - 128);  // ... and so may the state warps

    // h = exp(cum_last) h + (xw * tail)^T B
    if (state_warp) {
      const float gamma = fast_exp2(cum[q - 1]);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        st[nt][0] *= gamma;
        st[nt][1] *= gamma;
        st[nt][2] *= gamma;
        st[nt][3] *= gamma;
      }
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        if (16 * j < q) {
          // A fragment of (xw * tail)^T as hi + lo: register e holds row
          // d0 + g + 8 (e % 2), columns s = 16 j + 2 c + 8 (e / 2) + {0, 1}
          uint32_t xh[4], xl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + g + 8 * (e % 2);
            const int s = 16 * j + 2 * c + 8 * (e / 2);
            split_bf16(__bfloat162float(xt[s * RX + d]) * tail[s],
                       __bfloat162float(xt[(s + 1) * RX + d]) * tail[s + 1],
                       xh[e], xl[e]);
          }
#pragma unroll
          for (int nt = 0; nt < NS; ++nt) {
            uint32_t bbf[2];
            ldmatrix_x2_trans(bbf, bt + (16 * j + lane % 16) * RD + 8 * nt);
            mma_bf16(st[nt], xh, bbf);
            mma_bf16(st[nt], xl, bbf);
          }
        }
      }
    }
    if (ci + 1 < n_chunks && st_tid < q) {
      dtw[((ci + 1) % 2) * kTile + st_tid] = dt_next;
    }
    bar_sync(kBlockBar, kMmaThreads);  // the outputs are done with h
    if (state_warp) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int off = (d0 + g + 8 * rr) * RD + 8 * nt + 2 * c;
          split_bf16(st[nt][2 * rr], st[nt][2 * rr + 1],
                     *reinterpret_cast<uint32_t*>(hbh + off),
                     *reinterpret_cast<uint32_t*>(hbl + off));
        }
      }
    }
  }

  if (state_warp) {
    float* ho = h_out + (static_cast<long long>(b) * nh + h) * HD * DS;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ho[(d0 + g + 8 * (e / 2)) * DS + 8 * nt + 2 * c + e % 2] = st[nt][e];
      }
    }
  }
}

template <int HD, int DS>
cudaError_t launch_mma(const void* x, const void* dt, const void* a_log,
                       const void* bm, const void* cm, void* y, void* h_out,
                       Strides xs, Strides dts, Strides ys, Strides bs,
                       Strides cs, int batch, int s_len, int nh, int q,
                       cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<HD, DS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_kernel<HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, batch);
  ssd_mma_kernel<HD, DS><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const float*>(a_log), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<bf16*>(y),
      static_cast<float*>(h_out), xs, dts, ys, bs, cs, s_len, nh, q);
  return cudaGetLastError();
}

#define SSD_MMA_ARGS \
  x, dt, a_log, bm, cm, y, h_out, xs, dts, ys, bs, cs, batch, s_len, nh, q, st

template <int HD>
cudaError_t dispatch_mma_ds(int ds, const void* x, const void* dt,
                            const void* a_log, const void* bm,
                            const void* cm, void* y, void* h_out, Strides xs,
                            Strides dts, Strides ys, Strides bs, Strides cs,
                            int batch, int s_len, int nh, int q,
                            cudaStream_t st) {
  switch (ds) {
    case 16: return launch_mma<HD, 16>(SSD_MMA_ARGS);
    case 32: return launch_mma<HD, 32>(SSD_MMA_ARGS);
    case 64: return launch_mma<HD, 64>(SSD_MMA_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_mma(int hd, int ds, const void* x, const void* dt,
                         const void* a_log, const void* bm, const void* cm,
                         void* y, void* h_out, Strides xs, Strides dts,
                         Strides ys, Strides bs, Strides cs, int batch,
                         int s_len, int nh, int q, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_mma_ds<16>(ds, SSD_MMA_ARGS);
    case 32: return dispatch_mma_ds<32>(ds, SSD_MMA_ARGS);
    case 64: return dispatch_mma_ds<64>(ds, SSD_MMA_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef SSD_MMA_ARGS

// every row of a bf16 operand starts on a 16-byte boundary
bool rows_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
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
// 128}; bf16 at hd, ds <= 64 (the tensor-core kernel) also needs every
// row of x, B and C on a 16-byte boundary and even y strides.  Returns
// cudaGetLastError() after the launch.
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
  if (is_bf16 && hd <= 64 && ds <= 64) {
    if (!rows_aligned(x, xs) || !rows_aligned(bm, bs) ||
        !rows_aligned(cm, cs) || reinterpret_cast<uintptr_t>(y) % 4 != 0 ||
        y_sb % 2 != 0 || y_ss % 2 != 0 || y_sh % 2 != 0) {
      return cudaErrorInvalidValue;
    }
    return dispatch_mma(hd, ds, x, dt, a_log, bm, cm, y, h_out, xs, dts, ys,
                        bs, cs, batch, s_len, nh, chunk, st);
  }
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(hd, ds, x, dt, a_log, bm, cm, y, h_out,
                                   xs, dts, ys, bs, cs, batch, s_len, nh,
                                   chunk, st);
  }
  return dispatch<float>(hd, ds, x, dt, a_log, bm, cm, y, h_out, xs, dts,
                         ys, bs, cs, batch, s_len, nh, chunk, st);
}
