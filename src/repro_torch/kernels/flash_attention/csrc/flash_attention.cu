// Forward flash attention: blocked online-softmax attention with causal
// (top-left aligned), sliding-window and grouped-query masking.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:114
// (_kernel, launched by flash_attention_fwd).  It computes what _kernel
// computes, in the same order of operations per kv tile:
//
//     s = (q . k) * scale, masked entries -> -1e30
//     m_new = max(m, rowmax(s)); p = exp(s - m_new), masked p -> 0
//     l = l * exp(m - m_new) + rowsum(p); acc = acc * exp(m - m_new) + p v
//     out = acc / (l == 0 ? 1 : l)          (fully masked rows give 0)
//
// with q_pos and k_pos both counted from 0 (k visible from q when
// k_pos <= q_pos, and k_pos > q_pos - window with a window).
//
// What bounds it on an H100: operations.  At the serving path's shape
// (B 4, 32 heads of 128, S = T = 2048, bf16, causal) the function does
// 4 * hd flops for each of the B * H * S(S+1)/2 visible (q, k) pairs,
// 1.37e11 flops, 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate,
// against 268 MB of q, k, v and out, 0.080 ms at 3.35 TB/s.  Both paths
// below are simple first versions, far above that bound (no cp.async or
// TMA pipeline, no wgmma); their measured times sit beside the bound in
// PERF.md.  torch.nn.functional.scaled_dot_product_attention is only
// chip_smoke.py's yardstick for it and is never called by the port.
//
// Design.  The TPU kernel walks kv tiles as its innermost sequential grid
// axis, carrying (m, l, acc) in VMEM scratch.  Blocks on the H100 run in
// no order, so here one block owns one (q tile, head, batch) and a loop
// inside it walks the kv tiles, carrying (m, l, acc) itself.  The causal
// and window bounds are the loop's own limits, so tiles that no row of
// the q tile can see are never loaded (skipping a fully masked tile
// leaves (m, l, acc) unchanged, as _kernel's pl.when does).  The kv head
// is h / (Hq / Hkv): kv is never repeated in memory.  Inputs are read
// through (B, S, H, hd) strides (head dim contiguous), so the wrapper
// copies nothing; ragged S and T are masked (zero-filled tile rows), so
// no divisibility is assumed.  Scores, m, l and acc are fp32 throughout.
//
// fp32 inputs (flash_fwd_kernel): plain fp32 FMAs, never TF32, so the
// result holds to 2e-4.  Tiles of 64 q rows by 32 kv rows, 256 threads,
// converted to fp32 in shared memory (rows padded by one float, so the
// column reads of the q.k loop hit 16 different banks).  Each thread
// computes a 4 x 2 patch of the score tile and owns a 4 x hd/16 patch of
// the accumulator; each warp runs the softmax update of 8 rows, one
// column per lane.
//
// bf16 inputs (flash_fwd_mma_kernel): tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), FlashAttention-2's warp layout.
// Tiles of 64 q rows by 64 kv rows, 4 warps; each warp owns 16 q rows,
// keeps its q fragments, its 16 x 64 score tile and its 16 x hd output
// accumulator in registers, and does the softmax update in registers
// (row max and sum over the 4 lanes that share a row).  P is rounded to
// bf16 to enter the P.V product, as on the TPU's MXU at default
// precision.  K and V come from shared memory through ldmatrix (V
// transposed); rows are padded by 16 bytes so that the 8 rows of one
// ldmatrix hit 8 different bank groups.  Tiles load as 16-byte vectors,
// so the wrapper hands this path 16-byte aligned rows.
//
// Shared memory at hd = 128: 75,136 bytes (fp32 path), 52,224 bytes
// (bf16 path), both above the 48 KB default, so each launch raises the
// dynamic limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 32;        // kv rows per tile (one per lane)
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

struct Strides {
  long long b, s, h;           // element strides; the head dim is dense
};

__device__ __forceinline__ bool visible(int qp, int kp, int t, int causal,
                                        int window) {
  return kp < t && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

// ------------------------------------------------------------------- //
// fp32 inputs: plain FMAs
// ------------------------------------------------------------------- //
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int s_len, int t_len, int group, int causal, int window,
                     float scale) {
  constexpr int QP = HD + 1;   // padded row of the q and k tiles
  constexpr int PP = kBK + 1;  // padded row of the score tile
  constexpr int CW = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_t = smem;                  // kBQ x QP
  float* k_t = q_t + kBQ * QP;        // kBK x QP
  float* v_t = k_t + kBK * QP;        // kBK x HD
  float* p_t = v_t + kBK * HD;        // kBQ x PP: scores, then p
  float* row_m = p_t + kBQ * PP;      // running max
  float* row_l = row_m + kBQ;         // running denominator
  float* row_a = row_l + kBQ;         // this tile's rescale exp(m - m_new)

  const int tid = threadIdx.x;
  const int ty = tid / 16;            // rows ty + 16 i, i < 4
  const int tx = tid % 16;            // score cols tx + 16 j; out cols too
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int qp = q0 + r;
    q_t[r * QP + d] = qp < s_len ? qb[qp * qs.s + d] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = kMasked;
    row_l[tid] = 0.f;
  }

  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  }

  // kv tiles some row of this q tile can see
  int kt_end = (t_len + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's p.v is done with k_t, v_t, p_t
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD;
      const int d = i % HD;
      const int kp = k0 + r;
      const bool in = kp < t_len;
      k_t[r * QP + d] = in ? kb[kp * ks.s + d] : 0.f;
      v_t[r * HD + d] = in ? vb[kp * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4];
      float kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_t[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = k_t[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        p_t[r * PP + c] = visible(q0 + r, k0 + c, t_len, causal, window)
                              ? s[i][j] * scale
                              : kMasked;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w + 7, lane = column
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float m_prev = row_m[r];
      const float sv = p_t[r * PP + lane];
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_prev, mx);
      const float p = visible(q0 + r, k0 + lane, t_len, causal, window)
                          ? expf(sv - m_new)
                          : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      p_t[r * PP + lane] = p;
      if (lane == 0) {  // every lane read row_m[r] before the shuffles
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[i] = row_a[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= alpha[i];
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
      float vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_t[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < CW; ++j) vv[j] = v_t[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= s_len) continue;
    const float l = row_l[r] == 0.f ? 1.f : row_l[r];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      ob[qp * os.s + tx + 16 * j] = acc[i][j] / l;
    }
  }
}

// ------------------------------------------------------------------- //
// bf16 inputs: tensor cores (mma.sync m16n8k16)
// ------------------------------------------------------------------- //
constexpr int kMmaBQ = 64;     // q rows per block, 16 per warp
constexpr int kMmaBK = 64;     // kv rows per tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [p0, p0 + rows) of one head into a padded tile, 16 bytes a thread;
// rows at or past n are zero
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int p0,
                                               int n, int tid) {
  constexpr int RS = HD + 8;
  constexpr int CHUNKS = HD / 8;
  for (int i = tid; i < ROWS * CHUNKS; i += kMmaThreads) {
    const int r = i / CHUNKS;
    const int cc = i % CHUNKS;
    const int p = p0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < n) {
      val = *reinterpret_cast<const uint4*>(src + p * row_stride + cc * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * RS + cc * 8) = val;
  }
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kMmaBQ + 2 * kMmaBK) * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, Strides qs,
                         Strides ks, Strides vs, Strides os, int s_len,
                         int t_len, int group, int causal, int window,
                         float scale) {
  constexpr int RS = HD + 8;          // padded tile row, in bf16
  constexpr int KS = HD / 16;         // k-steps of q.k over the head dim
  constexpr int NT = kMmaBK / 8;      // 8-column tiles of the score tile
  constexpr int DT = HD / 8;          // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_t = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_t = q_t + kMmaBQ * RS;
  __nv_bfloat16* v_t = k_t + kMmaBK * RS;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;             // fragment row (and row + 8)
  const int c = lane % 4;             // fragment column pair
  const int q0 = blockIdx.x * kMmaBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  load_tile_bf16<HD, kMmaBQ>(q_t, qb, qs.s, q0, s_len, tid);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], q_t + (warp * 16 + lane % 16) * RS + kk * 16 +
                            (lane / 16) * 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};

  int kt_end = (t_len + kMmaBK - 1) / kMmaBK;
  if (causal) kt_end = min(kt_end, (q0 + kMmaBQ - 1) / kMmaBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kMmaBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();  // every warp is done with the last tile
    load_tile_bf16<HD, kMmaBK>(k_t, kb, ks.s, k0, t_len, tid);
    load_tile_bf16<HD, kMmaBK>(v_t, vb, vs.s, k0, t_len, tid);
    __syncthreads();

    // s = q k^T: 16 x 64 per warp; element e of tile nt sits at row
    // row0 + 8 (e / 2), column k0 + 8 nt + 2 c + e % 2
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[2];
        ldmatrix_x2(bf, k_t + (nt * 8 + lane % 8) * RS + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[nt], qf[kk], bf);
      }
    }

    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * c + (e % 2);
        const bool vis = visible(row0 + 8 * (e / 2), kp, t_len, causal, window);
        s[nt][e] = vis ? s[nt][e] * scale : kMasked;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    }
    float m_new[2];
    float alpha[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * c + (e % 2);
        const bool vis = visible(row0 + 8 * (e / 2), kp, t_len, causal, window);
        s[nt][e] = vis ? expf(s[nt][e] - m_new[e / 2]) : 0.f;
        sum[e / 2] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += p v: the score fragments of tiles 2 j and 2 j + 1 are the
    // A fragment of k-step j
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, v_t + (j * 16 + lane % 16) * RS + dt * 8);
        mma_bf16(acc[dt], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= s_len) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      __nv_bfloat16* dst = ob + qp * os.s + dt * 8 + 2 * c;
      dst[0] = __float2bfloat16(acc[dt][2 * i] / li);
      dst[1] = __float2bfloat16(acc[dt][2 * i + 1] / li);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int batch, int hq, int hkv, int s_len, int t_len,
                       int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kMmaBQ - 1) / kMmaBQ, hq, batch);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qs, ks, vs, os, s_len, t_len, hq / hkv, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        int batch, int hq, int hkv, int s_len, int t_len,
                        int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBQ - 1) / kBQ, hq, batch);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      s_len, t_len, hq / hkv, causal, window, scale);
  return cudaGetLastError();
}

#define FLASH_ARGS                                                        \
  q, k, v, o, qs, ks, vs, os, batch, hq, hkv, s_len, t_len, causal, window, \
      stream

cudaError_t dispatch(int hd, int is_bf16, const void* q, const void* k,
                     const void* v, void* o, Strides qs, Strides ks,
                     Strides vs, Strides os, int batch, int hq, int hkv,
                     int s_len, int t_len, int causal, int window,
                     cudaStream_t stream) {
  if (is_bf16) {
    switch (hd) {
      case 16: return launch_mma<16>(FLASH_ARGS);
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_mma<64>(FLASH_ARGS);
      case 128: return launch_mma<128>(FLASH_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 16: return launch_fp32<16>(FLASH_ARGS);
    case 32: return launch_fp32<32>(FLASH_ARGS);
    case 64: return launch_fp32<64>(FLASH_ARGS);
    case 128: return launch_fp32<128>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef FLASH_ARGS

}  // namespace

// q (B, S, Hq, hd), k and v (B, T, Hkv, hd), o (B, S, Hq, hd), all of one
// type (is_bf16: 1 bf16, 0 fp32) with a dense head dim; strides in
// elements.  bf16 rows must start on 16-byte boundaries (pointers 16-byte
// aligned, strides multiples of 8).  window <= 0: no window.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int batch, int hq,
    int hkv, int s_len, int t_len, int hd, int causal, int window,
    int is_bf16, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    const long long strides = q_sb | q_ss | q_sh | k_sb | k_ss | k_sh |
                              v_sb | v_ss | v_sh;
    if ((ptrs % 16) != 0 || (strides % 8) != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  return dispatch(hd, is_bf16, q, k, v, o, Strides{q_sb, q_ss, q_sh},
                  Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                  Strides{o_sb, o_ss, o_sh}, batch, hq, hkv, s_len, t_len,
                  causal, window, static_cast<cudaStream_t>(stream));
}
