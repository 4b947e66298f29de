// Forward flash attention: blocked online-softmax attention with causal
// (top-left aligned), sliding-window and grouped-query masking.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:114
// (_kernel, launched by flash_attention_fwd).  It computes what _kernel
// computes, in the same order of operations per kv tile:
//
//     s = (q . k) * scale, masked entries -> -1e30 (-inf on Hopper)
//     m_new = max(m, rowmax(s)); p = exp(s - m_new), masked p = 0
//     l = l * exp(m - m_new) + rowsum(p); acc = acc * exp(m - m_new) + p v
//     out = acc / (l == 0 ? 1 : l)          (fully masked rows give 0)
//
// with k_pos counted from 0 and q_pos from q_off (query row r sits at
// position q_off + r: a shard of a sequence-parallel q; 0 for a whole
// sequence), k visible from q when k_pos <= q_pos, and k_pos > q_pos -
// window with a window.  Masks and kv-tile bounds use positions; loads
// and stores use rows.  Scores, m,
// l and acc are fp32; p enters the p.v product rounded to bf16, as on the
// TPU's MXU at default precision.
//
// What bounds it on an H100: operations.  At deepseek-7b's prefill shape
// (B 4, 32 heads of 128, S = T = 2048, bf16, causal) the function does
// 4 * hd flops for each of the B * H * S(S+1)/2 visible (q, k) pairs,
// 1.375e11 flops, 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate,
// against 268 MB of q, k, v and out, 0.080 ms at 3.35 TB/s.  At
// zamba2-1.2b's (the same with 32 heads of 64) it is 6.87e10 flops,
// 0.0695 ms.  torch.nn.functional.scaled_dot_product_attention is only
// chip_smoke.py's yardstick for it and is never called by the port.
//
// Common to all paths.  The TPU kernel walks kv tiles as its innermost
// sequential grid axis, carrying (m, l, acc) in VMEM scratch.  Blocks on
// the H100 run in no order, so here one block owns one (q tile, head,
// batch) and a loop inside it walks the kv tiles, carrying (m, l, acc)
// itself.  The causal and window bounds are the loop's own limits, so
// tiles that no row of the q tile can see are never loaded (skipping a
// fully masked tile leaves (m, l, acc) unchanged, as _kernel's pl.when
// does).  The kv head is h / (Hq / Hkv): kv is never repeated in memory.
// Inputs are read through (B, S, H, hd) strides (head dim contiguous), so
// the wrapper copies nothing; ragged S and T are masked, so no
// divisibility is assumed.
//
// bf16, hd 64 and 128 (flash_fwd_wgmma_kernel): the Hopper pipeline.
//  - Tiles: work items of 128 q rows (one q tile of one head and batch),
//    kv tiles of 128 rows.  384 threads in three warpgroups: warpgroups 0
//    and 1 are consumers, each owning 64 q rows of the item; warpgroup 2
//    is the producer, of which one thread issues every load.  setmaxnreg
//    moves registers from the producer (40 a thread) to the consumers
//    (232), which hold a 64 x 128 fp32 score tile, its bf16 copy and a
//    64 x hd fp32 output accumulator each.
//  - Persistent: one block per SM (the registers of 384 threads allow no
//    second).  A block's first item is its index; then its producer takes
//    the next from a counter shared by all blocks (set to 0 by the
//    launch), so blocks that drew light items take more, and hands it to
//    the consumers through a 2-slot ring in shared memory.  Under causal
//    masking each head's q tiles come heaviest first, and the q tiles of
//    one head come together, so its K and V stay in L2.  The next item's
//    Q and K/V load while the consumers finish this one.
//  - Loads: TMA, from one CUtensorMap per operand built on the host for
//    each call over the 4-D view (hd, H, S, B) with the tensors' own
//    strides, passed as __grid_constant__ parameters.  Boxes are 64
//    columns (128 bytes) wide with the 128-byte swizzle, so hd 128 loads
//    as two boxes.  TMA zero-fills rows past S or T.  K and V go through
//    a ring of 2 stages (hd 128) or 3 (hd 64), with a full and an empty
//    mbarrier each for K and for V: the 8 consumer warps release K after
//    q k^T and V after p v, so the next K loads early.
//  - Products: wgmma.  s = q k^T with q and k both K-major from shared
//    memory (m64n128k16, hd / 16 steps); acc += p v with p as the
//    register A operand (packed to bf16 from the score accumulator) and v
//    MN-major from shared memory through wgmma's transpose bit
//    (m64n{hd}k16, 8 steps), so v is never transposed in memory.
//  - Overlap: each consumer issues tile i's q k^T before tile i - 1's
//    p v, so tile i's softmax runs while the tensor cores do p v (the
//    accumulator is rescaled while q k^T runs); named barriers hand the
//    tensor cores from one warpgroup to the other (ping-pong), so one's
//    softmax overlaps the other's products.
//  - Softmax: scale * log2(e) folded into one FMA before ex2; the mask is
//    applied only on tiles that cross the diagonal, the window's edge or
//    the ragged end of T (TMA's zero rows give score 0, not -inf, so the
//    last tile masks k_pos >= T); interior tiles skip it.
//  - Epilogue: divide by l (l == 0 -> 1), write bf16 into the
//    warpgroup's own output tile in shared memory (in the swizzled layout)
//    and store it with TMA, which skips rows past S; the store runs while
//    the next item starts, where 4-byte st.global from the accumulator
//    layout would hold the consumers.
//  - Shared memory: 197,752 bytes at hd 128 (Q 32 KB + 2 x (K 32 KB +
//    V 32 KB) + 2 x 16 KB output + 1 KB alignment + barriers and work
//    slots), 132,248 at hd 64 (Q 16 KB + 3 x (16 KB + 16 KB) + 2 x 8 KB +
//    ...).  The limit is raised once per process.
//
// bf16, hd 16 and 32 (flash_fwd_mma_kernel): the head dims of the smoke
// configs only, below a 64-column TMA box.  Tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), FlashAttention-2's warp layout:
// tiles of 64 q rows by 64 kv rows, 4 warps; each warp owns 16 q rows and
// keeps its fragments, scores and accumulator in registers.  K and V come
// from shared memory through ldmatrix (V transposed), loaded as 16-byte
// vectors.  dispatch() picks the kernel by head dim alone.
//
// fp32 inputs (flash_fwd_kernel): plain fp32 FMAs, never TF32, so the
// result holds to 2e-4.  Tiles of 64 q rows by 32 kv rows, 256 threads,
// converted to fp32 in shared memory (rows padded by one float, so the
// column reads of the q.k loop hit 16 different banks).  Each thread
// computes a 4 x 2 patch of the score tile and owns a 4 x hd/16 patch of
// the accumulator; each warp runs the softmax update of 8 rows, one
// column per lane.  75,136 bytes of shared memory at hd 128.
//
// Every bf16 path needs rows that start on 16-byte boundaries (TMA's base
// and stride rule, and the 16-byte loads of the mma.sync path); the
// wrapper copies an odd view once.  cuTensorMapEncodeTiled comes through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
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
                     int q_off, float scale) {
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

  // kv tiles some row of this q tile can see (positions p0 ...)
  const int p0 = q_off + q0;
  int kt_end = (t_len + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (p0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, p0 - window + 1) / kBK : 0;

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
        p_t[r * PP + c] = visible(p0 + r, k0 + c, t_len, causal, window)
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
      const float p = visible(p0 + r, k0 + lane, t_len, causal, window)
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
// bf16 inputs, hd 16 and 32: tensor cores (mma.sync m16n8k16)
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
                         int q_off, float scale) {
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
  const int pos0 = q_off + row0;        // and their positions

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
  if (causal) kt_end = min(kt_end, (q_off + q0 + kMmaBQ - 1) / kMmaBK + 1);
  const int kt_begin =
      window > 0 ? max(0, q_off + q0 - window + 1) / kMmaBK : 0;

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
        const bool vis = visible(pos0 + 8 * (e / 2), kp, t_len, causal, window);
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
        const bool vis = visible(pos0 + 8 * (e / 2), kp, t_len, causal, window);
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

// ------------------------------------------------------------------- //
// bf16 inputs, hd 64 and 128: TMA ring, wgmma, warp-specialised
// ------------------------------------------------------------------- //
constexpr int kWgBQ = 128;         // q rows per item, 64 per consumer
constexpr int kWgBK = 128;         // kv rows per tile
constexpr int kWgThreads = 384;    // consumer warpgroups 0-1, producer 2
constexpr int kConsumerWarps = 8;
constexpr int kSwizzleRow = 128;   // bytes of one swizzled row: 64 bf16
constexpr long long kWaitCycles = 1ll << 34;  // ~8 s: a deadlock traps

template <int HD>
struct WgTile {
  static_assert(HD == 64 || HD == 128, "the wgmma path takes hd 64, 128");
  static constexpr int kBoxes = HD / 64;              // 64-column boxes
  static constexpr int kStages = HD == 128 ? 2 : 3;   // K/V ring depth
  static constexpr uint32_t kQBox = kWgBQ * kSwizzleRow;
  static constexpr uint32_t kKVBox = kWgBK * kSwizzleRow;
  static constexpr uint32_t kOBox = 64 * kSwizzleRow;    // 64 output rows
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kKVBytes = kBoxes * kKVBox;  // K or V tile
  static constexpr uint32_t kOBytes = kBoxes * kOBox;    // a consumer's
  // Q, K of every stage, V of every stage, each consumer's output tile,
  // then the barriers (Q's full and empty, the work ring's 2 full and 2
  // empty, then K's full, V's full, K's empty and V's empty of every
  // stage) and the work ring's 2 slots
  static constexpr uint32_t kOOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr uint32_t kBarOff = kOOff + 2 * kOBytes;
  static constexpr uint32_t kSmem =
      1024 + kBarOff + 8 * (6 + 4 * kStages) + 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of this parity has completed; a wait
// of kWaitCycles means a deadlock, which traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kWaitCycles) {
      __trap();
    }
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// a box of shared memory out to a 4-D tensor map (rows past the tensor's
// end are not written), in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// leading and stride byte offsets in bytes (encoded in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128) = (scale_d ? d : 0) + a . b, a and b K-major in shared
// memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) += a . b, a (64 x 16) in registers, b MN-major in shared
// memory (128-byte swizzle, transposed)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += a . b, a (64 x 16) in registers, b MN-major in shared
// memory (128-byte swizzle, transposed)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// a barrier of one warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// s = q k^T, issued and committed: hd / 16 steps of 16 columns, each 32
// bytes further within a swizzled row, the next box after 4
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kWgBK / 2], uint64_t dq,
                                         uint64_t dk) {
  using Tile = WgTile<HD>;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t q_off = (kk / 4) * Tile::kQBox + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * Tile::kKVBox + (kk % 4) * 32;
    wgmma_ss_n128(sc, dq + (q_off >> 4), dk + (k_off >> 4), kk > 0);
  }
  wgmma_commit();
}

// acc += p v, issued and committed: v MN-major, 16 kv rows (2 KB of
// swizzled rows) a step
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pa)[kWgBK / 16][4],
                                         uint64_t dv) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    const uint64_t b = dv + ((kk * 16 * kSwizzleRow) >> 4);
    if constexpr (HD == 128) {
      wgmma_rs_n128_tb(acc, pa[kk], b);
    } else {
      wgmma_rs_n64_tb(acc, pa[kk], b);
    }
  }
  wgmma_commit();
}

// the online-softmax step of one score tile, in place: masks it where
// `edge`, updates the row max m and this thread's share of l, leaves p
// in sc and the rescale factor of the accumulator in alpha.  Element e of
// score n8-chunk j sits at row `row` + 8 (e / 2), column k0 + 8 j + 2 c +
// e % 2.  Log2 domain: p = 2^(s scale_log2 - m scale_log2).
__device__ __forceinline__ void softmax_step(float (&sc)[kWgBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int row, int k0, int c,
                                             int t_len, int causal,
                                             int window, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < kWgBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * c + (e % 2);
        if (!visible(row + 8 * (e / 2), kp, t_len, causal, window)) {
          sc[4 * j + e] = -INFINITY;
        }
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kWgBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row that has seen no key yet keeps m = -inf: p = alpha = 0
    ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
    alpha[r] = ex2(m[r] * scale_log2 - ms[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kWgBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -ms[e / 2]));
      sum[e / 2] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// p as wgmma's A operand: score chunks 2 kk and 2 kk + 1 are the fragment
// of k-step kk
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kWgBK / 16][4],
                                       const float (&sc)[kWgBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// one arrival per consumer warp on a ring barrier
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// one (q tile, head, batch) work item: under causal masking each head's
// q tiles come heaviest first, and the q tiles of one head come together
// (their K and V stay in L2)
struct Work {
  int q0, h, b, kt_begin, n_tiles;
};

__device__ __forceinline__ Work decode(int w, int n_qt, int hq, int t_len,
                                       int causal, int window, int q_off) {
  Work wk;
  const int qi = w % n_qt;
  wk.h = (w / n_qt) % hq;
  wk.b = w / n_qt / hq;
  wk.q0 = (causal ? n_qt - 1 - qi : qi) * kWgBQ;
  // kv tiles some row of this q tile can see, from its positions
  const int p0 = q_off + wk.q0;
  int kt_end = (t_len + kWgBK - 1) / kWgBK;
  if (causal) kt_end = min(kt_end, (p0 + kWgBQ - 1) / kWgBK + 1);
  wk.kt_begin = window > 0 ? max(0, p0 - window + 1) / kWgBK : 0;
  wk.n_tiles = max(0, kt_end - wk.kt_begin);
  return wk;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           int* __restrict__ next_work, int n_work, int hq,
                           int s_len, int t_len, int group, int causal,
                           int window, int q_off, float scale_log2) {
  using Tile = WgTile<HD>;
  constexpr int kStages = Tile::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // 128-byte swizzle atoms are 1024 bytes: align the tiles to them
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;                               // Q boxes
  const uint32_t k_s = base + Tile::kQBytes;               // + stage tile
  const uint32_t v_s = k_s + kStages * Tile::kKVBytes;
  const uint32_t o_s = base + Tile::kOOff;                 // + consumer
  const uint32_t q_full = base + Tile::kBarOff;
  const uint32_t q_empty = q_full + 8;
  const uint32_t work_full = q_empty + 8;                  // + 8 slot
  const uint32_t work_empty = work_full + 16;
  const uint32_t full_k = work_empty + 16;                 // + 8 stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t work = empty_v + 8 * kStages;             // + 4 slot
  const int n_qt = (s_len + kWgBQ - 1) / kWgBQ;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < 2; ++s) {
      mbar_init(work_full + 8 * s, 1);
      mbar_init(work_empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread takes work items (the first by block index,
    // then from a counter shared by all blocks, so blocks that finish
    // early take more), hands each to the consumers through a 2-slot ring
    // and keeps the K and V rings full across items.  K of ring position
    // p waits for K of position p - stages to be consumed, V likewise;
    // the next item's Q waits for the last q k^T of this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int w = blockIdx.x;
      int it = 0;                        // ring position
      for (int item = 0;; ++item) {
        const int slot = item & 1;
        mbar_wait(work_empty + 8 * slot, ((item >> 1) & 1) ^ 1);
        st_shared(work + 4 * slot, static_cast<uint32_t>(w));
        mbar_arrive(work_full + 8 * slot);
        if (w >= n_work) break;
        const int next = gridDim.x + atomicAdd(next_work, 1);
        const Work wk = decode(w, n_qt, hq, t_len, causal, window, q_off);
        const int hk = wk.h / group;
        mbar_wait(q_empty, (item & 1) ^ 1);
        mbar_expect_tx(q_full, Tile::kQBytes);
        for (int x = 0; x < Tile::kBoxes; ++x) {
          tma_load(q_s + x * Tile::kQBox, &tq, q_full, 64 * x, wk.h, wk.q0,
                   wk.b);
        }
        for (int i = 0; i < wk.n_tiles; ++i, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          const int k0 = (wk.kt_begin + i) * kWgBK;
          mbar_wait(empty_k + 8 * s, parity);
          mbar_expect_tx(full_k + 8 * s, Tile::kKVBytes);
          for (int x = 0; x < Tile::kBoxes; ++x) {
            tma_load(k_s + s * Tile::kKVBytes + x * Tile::kKVBox, &tk,
                     full_k + 8 * s, 64 * x, hk, k0, wk.b);
          }
          mbar_wait(empty_v + 8 * s, parity);
          mbar_expect_tx(full_v + 8 * s, Tile::kKVBytes);
          for (int x = 0; x < Tile::kBoxes; ++x) {
            tma_load(v_s + s * Tile::kKVBytes + x * Tile::kKVBox, &tv,
                     full_v + 8 * s, 64 * x, hk, k0, wk.b);
          }
        }
        w = next;
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 of each
    // item.  Tile i's q k^T is issued before tile i - 1's p v, so its
    // softmax runs while the tensor cores do p v; named barriers 1 and 2
    // hand the tensor cores from one warpgroup to the other (ping-pong),
    // so one's softmax overlaps the other's products.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int c = lane % 4;            // accumulator column pair
    const int my_turn = 1 + wg;
    const int their_turn = 2 - wg;
    const uint64_t dq = sw128_desc(q_s + 64 * wg * kSwizzleRow, 16, 1024);
    auto dk = [&](int s) {
      return sw128_desc(k_s + s * Tile::kKVBytes, 16, 1024);
    };
    auto dv = [&](int s) {
      return sw128_desc(v_s + s * Tile::kKVBytes, Tile::kKVBox, 1024);
    };
    float sc[kWgBK / 2];
    float acc[HD / 2];
    uint32_t pa[kWgBK / 16][4];
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) sc[i] = 0.f;
    if (wg == 0) named_arrive(my_turn);   // warpgroup 0 goes first
    int it = 0;                           // ring position
    for (int item = 0;; ++item) {
      const int slot = item & 1;
      mbar_wait(work_full + 8 * slot, (item >> 1) & 1);
      const int w = ld_shared(work + 4 * slot);
      release(work_empty + 8 * slot, lane);
      if (w >= n_work) break;
      const Work wk = decode(w, n_qt, hq, t_len, causal, window, q_off);
      const int r0 = wk.q0 + 64 * wg;
      const int p0 = q_off + r0;                  // its first position
      const int row = p0 + 16 * warp + lane / 4;  // and row + 8: positions
      // the mask can bite only where the tile crosses the diagonal, the
      // window's edge or the end of T (uniform over the warpgroup)
      auto edge = [&](int k0) {
        return k0 + kWgBK > t_len || (causal && k0 + kWgBK - 1 > p0) ||
               (window > 0 && k0 <= p0 + 63 - window);
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};           // this thread's columns only
      float alpha[2];

      mbar_wait(q_full, item & 1);
      if (wk.n_tiles > 0) {
        const int s = it % kStages;
        const int k0 = wk.kt_begin * kWgBK;
        mbar_wait(full_k + 8 * s, (it / kStages) & 1);
        named_sync(my_turn);
        issue_qk<HD>(sc, dq, dk(s));
        named_arrive(their_turn);
        wgmma_wait_all();
        fence_regs(sc);
        release(empty_k + 8 * s, lane);
        softmax_step(sc, m, l, alpha, edge(k0), row, k0, c, t_len, causal,
                     window, scale_log2);
        pack_p(pa, sc);
      }
      for (int i = 1; i < wk.n_tiles; ++i) {
        const int s = (it + i) % kStages;
        const int ps = (it + i - 1) % kStages;
        const int k0 = (wk.kt_begin + i) * kWgBK;
        mbar_wait(full_k + 8 * s, ((it + i) / kStages) & 1);
        named_sync(my_turn);
        issue_qk<HD>(sc, dq, dk(s));
        rescale(acc, alpha);
        mbar_wait(full_v + 8 * ps, ((it + i - 1) / kStages) & 1);
        issue_pv<HD>(acc, pa, dv(ps));
        named_arrive(their_turn);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(sc);
        release(empty_k + 8 * s, lane);
        softmax_step(sc, m, l, alpha, edge(k0), row, k0, c, t_len, causal,
                     window, scale_log2);
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(pa);
        release(empty_v + 8 * ps, lane);
        pack_p(pa, sc);
      }
      // every q k^T of this item is done: the producer may load the next Q
      release(q_empty, lane);
      if (wk.n_tiles > 0) {
        const int ls = (it + wk.n_tiles - 1) % kStages;
        rescale(acc, alpha);
        mbar_wait(full_v + 8 * ls, ((it + wk.n_tiles - 1) / kStages) & 1);
        issue_pv<HD>(acc, pa, dv(ls));
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(pa);
        release(empty_v + 8 * ls, lane);
      }
      it += wk.n_tiles;

      // epilogue: rows scaled by 1 / l into this warpgroup's output tile
      // (the layout TMA's 128-byte swizzle gives), then one thread stores
      // it with TMA, which skips rows past S; the store of the previous
      // item must have read the tile first
      const uint32_t o_tile = o_s + wg * Tile::kOBytes;
      if (tw == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      warpgroup_sync(3 + wg);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
        const int rr = 16 * warp + lane / 4 + 8 * r;   // row in the tile
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          st_shared(o_tile + (j / 8) * Tile::kOBox + rr * kSwizzleRow +
                        (((j % 8) ^ (rr % 8)) * 16) + 4 * c,
                    pack_bf16(acc[4 * j + 2 * r] * inv,
                              acc[4 * j + 2 * r + 1] * inv));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(3 + wg);
      if (tw == 0 && r0 < s_len) {
        for (int x = 0; x < Tile::kBoxes; ++x) {
          tma_store(&to, o_tile + x * Tile::kOBox, 64 * x, wk.h, r0, wk.b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // the block's shared memory must outlive the last store
    if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// the driver's cuTensorMapEncodeTiled, reached through the runtime so that
// the library links no libcuda; null if the driver has none
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a (B, rows, heads, hd) bf16 tensor as the 4-D view (hd, heads, rows, B)
// with its own strides, in boxes of 64 columns by `box_rows` rows of one
// head, 128-byte swizzled; rows past `rows` load as zeros and are not
// stored
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads,
              int rows, int batch, Strides st, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device, read once
int sm_count() {
  static const int n = []() {
    int dev = 0;
    int sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    return sms;
  }();
  return n;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int* next_work, Strides qs, Strides ks,
                         Strides vs, Strides os, int batch, int hq, int hkv,
                         int s_len, int t_len, int causal, int window,
                         int q_off, cudaStream_t stream) {
  using Tile = WgTile<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (attr != cudaSuccess) return attr;
  if (next_work == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(next_work, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, HD, hq, s_len, batch, qs, kWgBQ) ||
      !make_map(&tk, k, HD, hkv, t_len, batch, ks, kWgBK) ||
      !make_map(&tv, v, HD, hkv, t_len, batch, vs, kWgBK) ||
      !make_map(&to, o, HD, hq, s_len, batch, os, kWgBQ / 2)) {
    return cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  // one block per SM (the registers of 384 threads allow no second);
  // each takes work items until none is left
  const int n_work = (s_len + kWgBQ - 1) / kWgBQ * hq * batch;
  const int blocks = min(sms, n_work);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  flash_fwd_wgmma_kernel<HD><<<blocks, kWgThreads, Tile::kSmem, stream>>>(
      tq, tk, tv, to, next_work, n_work, hq, s_len, t_len, hq / hkv, causal,
      window, q_off, scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int batch, int hq, int hkv, int s_len, int t_len,
                       int causal, int window, int q_off,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((s_len + kMmaBQ - 1) / kMmaBQ, hq, batch);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qs, ks, vs, os, s_len, t_len, hq / hkv, causal, window, q_off, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        int batch, int hq, int hkv, int s_len, int t_len,
                        int causal, int window, int q_off,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((s_len + kBQ - 1) / kBQ, hq, batch);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      s_len, t_len, hq / hkv, causal, window, q_off, scale);
  return cudaGetLastError();
}

#define FLASH_ARGS                                                        \
  q, k, v, o, qs, ks, vs, os, batch, hq, hkv, s_len, t_len, causal, window, \
      q_off, stream
#define WGMMA_ARGS                                                       \
  q, k, v, o, next_work, qs, ks, vs, os, batch, hq, hkv, s_len, t_len,   \
      causal, window, q_off, stream

// bf16 takes the kernel of its head dim: the Hopper pipeline from hd 64
// (one 64-column TMA box) up, mma.sync below
cudaError_t dispatch(int hd, int is_bf16, const void* q, const void* k,
                     const void* v, void* o, int* next_work, Strides qs,
                     Strides ks, Strides vs, Strides os, int batch, int hq,
                     int hkv, int s_len, int t_len, int causal, int window,
                     int q_off, cudaStream_t stream) {
  if (is_bf16) {
    switch (hd) {
      case 16: return launch_mma<16>(FLASH_ARGS);
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_wgmma<64>(WGMMA_ARGS);
      case 128: return launch_wgmma<128>(WGMMA_ARGS);
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
#undef WGMMA_ARGS

}  // namespace

// q (B, S, Hq, hd), k and v (B, T, Hkv, hd), o (B, S, Hq, hd), all of one
// type (is_bf16: 1 bf16, 0 fp32) with a dense head dim; strides in
// elements.  bf16 rows must start on 16-byte boundaries (pointers 16-byte
// aligned, strides multiples of 8).  window <= 0: no window.  q_off >= 0:
// the position of q's row 0 (keys sit at 0 .. T - 1).  next_work:
// one int32 of scratch on the device, the work counter of the Hopper
// kernel (bf16, hd 64 and 128; unused otherwise), which the launch sets
// to 0 on the stream.  Returns cudaGetLastError() after the launch, or
// the error that kept it from launching.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, void* next_work,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int batch,
    int hq, int hkv, int s_len, int t_len, int hd, int causal, int window,
    int q_off, int is_bf16, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || q_off < 0) return cudaErrorInvalidValue;
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
  return dispatch(hd, is_bf16, q, k, v, o, static_cast<int*>(next_work),
                  Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                  Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}, batch,
                  hq, hkv, s_len, t_len, causal, window, q_off,
                  static_cast<cudaStream_t>(stream));
}
