// flash_attention_bwd: the flash-attention backward in two deterministic
// passes, each output written once by one block (no atomics).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (src/repro/kernels/flash_attention/kernel_bwd.py, entered through
// `flash_attention_bwd_bhsd`).  Same contract: both passes recompute
// p = exp(s - lse) from the forward's logsumexp, with s = (q * scale) . k in
// fp32 and the forward's mask (kv positions past Skv, and kv_pos > q_pos when
// causal, top-left aligned); delta = rowsum(dO * O); ds = p * (dp - delta)
// with dp = dO . v; then
//   dq   = scale * sum_kv ds . k                      (pass A, per q tile)
//   dv_h = sum_q p^T . dO,  dk_h = sum_q ds^T . (q * scale)
//                                                     (pass B, per kv tile)
// per *query* head, in q's dtype; the caller sums the H / KV query heads of
// each kv head (GQA), as the reference's ops.py does.
//
// What bounds them on an H100: operations.  Per causal (q, kv) pair pass A
// does three hd-long products (s, dp, dq) and pass B four (s, dp, dv, dk):
// 6 * hd and 8 * hd flops against a few bytes, far above the card's ~295
// flop/B balance point in bf16.
//
// Design.  The TPU grid walks (bh, q block, kv block) with the innermost axis
// in order and the accumulators in VMEM.  Here one block of 128 threads owns
// one (bh, 64-row tile) and loops over the other axis itself, so nothing is
// carried between blocks:
//   pass A: block (q tile, bh) loops over kv tiles at or below the diagonal;
//           it also computes delta for its rows (needed at its first kv step,
//           as in the reference) and writes it once to `delta`, which pass B
//           reads rather than recomputing it per q tile.
//   pass B: block (kv tile, bh) loops over q tiles at or above the diagonal.
//
// The dtype alone picks the kernel of each pass (the wrapper's
// `_kernel_variant`).  float32 runs fp32 FMAs on the CUDA cores
// (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`).  Tiles are staged in
// shared memory as fp32 with odd row pitches (HD + 1, 65), which keep the
// column walks free of bank conflicts.  Thread (ty, tx) = (t / 8, t % 8)
// owns tile rows ty + 16 r (r < 4) and the columns tx + 8 c of the 64 x 64
// score tile and of the HD-wide accumulators, so a row's eight threads are
// adjacent lanes.
//
// bfloat16 runs both passes on the tensor cores (mma.sync m16n8k16 with
// ldmatrix and cp.async from mma_bf16.cuh):
//
// * Pass A, `flash_bwd_dq_mma_kernel`: the FA-2 dq structure of the forward's
//   `flash_fwd_mma_kernel`.  The last q tiles launch first (under the causal
//   mask they carry the most work).  Each of the 4 warps owns 16 q rows,
//   whose Q fragments stay in registers for the whole kv loop (dO's are
//   re-read from shared memory); K and V tiles of 64 rows stream through a
//   two-stage cp.async ring.  Per 32-column half of a kv tile (halves keep
//   fewer registers live): S = Q K^T and dP = dO V^T on the tensor cores;
//   P = exp2(S scale log2e - lse log2e) and dS = P (dP - delta) on the
//   fragments, for kept pairs only; then dQ += dS K with dS packed to bf16
//   in registers as the A operand and K by ldmatrix.trans.  A warp whose
//   rows all lie before a half's first kv column skips the half.
//   delta = rowsum(dO * O) is taken in fp32 in the prologue (dO from the
//   shared tile, O from global memory) and written once; dQ is scaled once
//   in the epilogue.  dS is rounded to bf16 once: dq has no per-head sum
//   before its own rounding (unlike dk and dv under D12), and at
//   TinyLlama's shape (S 2048, 8 query heads per kv head) the emulated
//   single rounding stays within a quarter of the 2e-2 tolerance of the
//   check against the plain version (tests/emulate_bf16_roundings.py).
// * Pass B, `flash_bwd_dkv_mma_kernel`: each of the 4 warps owns 16 kv rows
//   of the block's 64; K and V stay in shared memory, and Q, dO, lse and
//   delta tiles of 32 q rows stream through a two-stage cp.async ring.  Per
//   q tile: S^T = K Q^T and dP^T = V dO^T on the tensor cores; P^T = exp(scale
//   S^T - lse) and dS^T = P^T (dP^T - delta) on the fragments, for kept pairs
//   only (a warp whose kv rows all lie past the tile's last q row skips the
//   tile); then dV += P^T dO and dK += dS^T Q with P^T and dS^T in registers
//   as A operands (dO and Q by ldmatrix.trans).  dK is scaled once in the
//   epilogue.  P^T and dS^T go in as a bf16 high part plus a bf16 low part
//   (two products each): D12 rounds each query head's dk and dv to bf16
//   before the GQA sum, and a single bf16 rounding of P and dS moves the fp32
//   sums far enough that several of the 8 per-head roundings flip together:
//   at TinyLlama's shape (S 2048, G = 8) dv then left the bf16 tolerance of
//   the check against the plain version.
//
// In every kernel rows past Sq or Skv load as zeros, and exp is taken only
// where the mask keeps the pair: a masked or padded pair contributes exactly
// 0, never 0 * inf or 0 * NaN.  Templated on the head dim (multiples of 16 up
// to 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlock = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 128;
constexpr int kRows = 4;            // tile rows per thread: ty + 16 r
constexpr int kCols = 8;            // score columns per thread: tx + 8 c
constexpr int kSP = kBlock + 1;     // row pitch of the score tiles

// the FMA kernels are instantiated for float only (bfloat16 runs on mma)
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

struct Strides {
  long long b, h, s;
};

// rows r0 .. r0 + 63 of one (batch, head) slab -> fp32 tile (pitch HD + 1),
// times `mul`; rows at or past `n` load as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0, int n,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kBlock * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] =
        row < n ? to_f32(src[row * row_stride + d]) * mul : 0.0f;
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBlock * (HD + 1) + kBlock * kSP);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (4 * kBlock * (HD + 1) + 2 * kBlock * kSP + 2 * kBlock);
}

// Pass A: dq for one (64-row q tile, bh); also writes delta for its rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int H,
                    int KV, int Sq, int Skv, Strides qs, Strides ks,
                    Strides vs, Strides os, Strides dos, float scale,
                    int causal) {
  constexpr int P = HD + 1;
  constexpr int kOut = HD / 8;           // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // q * scale
  float* dOs = Qs + kBlock * P;
  float* Ks = dOs + kBlock * P;
  float* Vs = Ks + kBlock * P;
  float* dSs = Vs + kBlock * P;          // [64][kSP]

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBlock;
  const long long row0 = static_cast<long long>(bh) * Sq;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = o + b * os.b + h * os.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  load_tile<T, HD>(Qs, qb, qs.s, q0, Sq, scale);
  load_tile<T, HD>(dOs, dob, dos.s, q0, Sq, 1.0f);
  __syncthreads();

  // delta = rowsum(dO * O) in fp32; lse of the thread's rows
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty + 16 * r;
    float part = 0.0f;
    if (row < Sq) {
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        part += dOs[(ty + 16 * r) * P + tx + 8 * c] *
                to_f32(ob[row * os.s + tx + 8 * c]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    delta_r[r] = part;
    lse_r[r] = row < Sq ? lse[row0 + row] : 0.0f;
    if (tx == 0 && row < Sq) delta[row0 + row] = part;
  }

  float acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.0f;

  int n_tiles = (Skv + kBlock - 1) / kBlock;
  if (causal) {                       // kv tiles at or below the diagonal
    const int last_q = min(q0 + kBlock, Sq) - 1;
    n_tiles = min(n_tiles, min(last_q, Skv - 1) / kBlock + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBlock;
    __syncthreads();                  // previous tile's Ks/Vs/dSs consumed
    load_tile<T, HD>(Ks, kb, ks.s, kv0, Skv, 1.0f);
    load_tile<T, HD>(Vs, vb, vs.s, kv0, Skv, 1.0f);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float a[kRows], g[kRows], bk[kCols], bv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a[r] = Qs[(ty + 16 * r) * P + d];
        g[r] = dOs[(ty + 16 * r) * P + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        bk[c] = Ks[(tx + 8 * c) * P + d];
        bv[c] = Vs[(tx + 8 * c) * P + d];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[r][c] = fmaf(a[r], bk[c], s[r][c]);
          dp[r][c] = fmaf(g[r], bv[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kpos = kv0 + tx + 8 * c;
        const bool keep =
            qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
        float ds = 0.0f;
        if (keep) ds = expf(s[r][c] - lse_r[r]) * (dp[r][c] - delta_r[r]);
        dSs[(ty + 16 * r) * kSP + tx + 8 * c] = ds;
      }
    }
    __syncthreads();                  // dSs complete

#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float w[kRows], kk[kOut];
#pragma unroll
      for (int r = 0; r < kRows; ++r) w[r] = dSs[(ty + 16 * r) * kSP + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) kk[c] = Ks[j * P + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[r][c] = fmaf(w[r], kk[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    T* dst = dq + (row0 + row) * HD;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      dst[tx + 8 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

// Pass B: per-query-head dk and dv for one (64-row kv tile, bh).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     float scale, int causal) {
  constexpr int P = HD + 1;
  constexpr int kOut = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * P;
  float* Qs = Vs + kBlock * P;           // q * scale
  float* dOs = Qs + kBlock * P;
  float* Ps = dOs + kBlock * P;          // [kv row][q row], pitch kSP
  float* dSs = Ps + kBlock * kSP;
  float* lse_s = dSs + kBlock * kSP;     // [64]
  float* delta_s = lse_s + kBlock;       // [64]

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int kv0 = blockIdx.x * kBlock;
  const long long qrow0 = static_cast<long long>(bh) * Sq;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  load_tile<T, HD>(Ks, k + b * ks.b + kvh * ks.h, ks.s, kv0, Skv, 1.0f);
  load_tile<T, HD>(Vs, v + b * vs.b + kvh * vs.h, vs.s, kv0, Skv, 1.0f);

  float acc_k[kRows][kOut], acc_v[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;

  const int n_tiles = (Sq + kBlock - 1) / kBlock;
  // q tiles at or above the diagonal: q_pos >= kv_pos >= kv0
  const int first = causal ? kv0 / kBlock : 0;

  for (int tile = first; tile < n_tiles; ++tile) {
    const int q0 = tile * kBlock;
    __syncthreads();                  // previous tile's tiles consumed
    load_tile<T, HD>(Qs, qb, qs.s, q0, Sq, scale);
    load_tile<T, HD>(dOs, dob, dos.s, q0, Sq, 1.0f);
    if (tid < kBlock) {
      const int row = q0 + tid;
      lse_s[tid] = row < Sq ? lse[qrow0 + row] : 0.0f;
      delta_s[tid] = row < Sq ? delta[qrow0 + row] : 0.0f;
    }
    __syncthreads();

    // transposed score tile: thread rows are kv rows, columns q rows
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float a[kRows], av[kRows], bq[kCols], bo[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a[r] = Ks[(ty + 16 * r) * P + d];
        av[r] = Vs[(ty + 16 * r) * P + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        bq[c] = Qs[(tx + 8 * c) * P + d];
        bo[c] = dOs[(tx + 8 * c) * P + d];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[r][c] = fmaf(a[r], bq[c], s[r][c]);
          dp[r][c] = fmaf(av[r], bo[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kpos = kv0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = tx + 8 * c;
        const int qpos = q0 + i;
        const bool keep =
            qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
        float p = 0.0f, ds = 0.0f;
        if (keep) {
          p = expf(s[r][c] - lse_s[i]);
          ds = p * (dp[r][c] - delta_s[i]);
        }
        Ps[(ty + 16 * r) * kSP + i] = p;
        dSs[(ty + 16 * r) * kSP + i] = ds;
      }
    }
    __syncthreads();                  // Ps, dSs complete

#pragma unroll 4
    for (int i = 0; i < kBlock; ++i) {
      float pw[kRows], dw[kRows], qv[kOut], ov[kOut];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pw[r] = Ps[(ty + 16 * r) * kSP + i];
        dw[r] = dSs[(ty + 16 * r) * kSP + i];
      }
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        qv[c] = Qs[i * P + tx + 8 * c];
        ov[c] = dOs[i * P + tx + 8 * c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          acc_v[r][c] = fmaf(pw[r], ov[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dw[r], qv[c], acc_k[r][c]);
        }
    }
  }

  const long long krow0 = static_cast<long long>(bh) * Skv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = kv0 + ty + 16 * r;
    if (row >= Skv) continue;
    T* dk_row = dk + (krow0 + row) * HD;
    T* dv_row = dv + (krow0 + row) * HD;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dk_row[tx + 8 * c] = from_f32<T>(acc_k[r][c]);
      dv_row[tx + 8 * c] = from_f32<T>(acc_v[r][c]);
    }
  }
}

// Pass A in bfloat16 on the tensor cores: dq for one (64-row q tile, bh);
// also writes delta for its rows.
template <int HD>
constexpr size_t dq_mma_smem_bytes() {  // Qs, dOs [64]; Ks, Vs [2][64] rows
  return sizeof(__nv_bfloat16) * 6 * kBlock * repro_mma::pitch<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int KV, int Sq,
                        int Skv, Strides qs, Strides ks, Strides vs,
                        Strides os, Strides dos, float scale, int causal) {
  using namespace repro_mma;
  constexpr int P = pitch<HD>();
  constexpr int KS = HD / 16;           // k-steps of Q K^T and dO V^T
  constexpr int NO = HD / 8;            // n-tiles of dQ
  constexpr int kHalf = HD / 2;         // delta: columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBlock * P;
  bf16* Ks = dOs + kBlock * P;          // [2][64][P]
  bf16* Vs = Ks + 2 * kBlock * P;       // [2][64][P]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  // the last q tiles first: under the causal mask they carry the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int wq0 = q0 + warp * 16;       // the warp's first q row
  const int row[2] = {wq0 + g, wq0 + g + 8};
  const long long row0 = static_cast<long long>(bh) * Sq;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  int n_tiles = (Skv + kBlock - 1) / kBlock;
  if (causal) {                         // kv tiles at or below the diagonal
    const int last_q = min(q0 + kBlock, Sq) - 1;
    n_tiles = min(n_tiles, min(last_q, Skv - 1) / kBlock + 1);
  }

  cp_tile<HD, kBlock, kThreads>(Qs, qb, qs.s, q0, Sq);
  cp_tile<HD, kBlock, kThreads>(dOs, dob, dos.s, q0, Sq);
  cp_tile<HD, kBlock, kThreads>(Ks, kb, ks.s, 0, Skv);
  cp_tile<HD, kBlock, kThreads>(Vs, vb, vs.s, 0, Skv);
  cp_async_commit();

  unsigned qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float lse2[2], dl[2] = {0.0f, 0.0f};  // lse * log2(e), delta: rows g, g+8
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = row[r] < Sq ? lse[row0 + row[r]] * kLog2e : 0.0f;
  const float sl2 = scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {           // next K/V tile into the other stage
      const int nxt = (tile + 1) * kBlock;
      cp_tile<HD, kBlock, kThreads>(Ks + (buf ^ 1) * kBlock * P, kb, ks.s,
                                    nxt, Skv);
      cp_tile<HD, kBlock, kThreads>(Vs + (buf ^ 1) * kBlock * P, vb, vs.s,
                                    nxt, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this stage's K/V (and Q, dO) landed
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], a_rows(Qs, P, warp * 16, kk * 16, lane));
      // delta = rowsum(dO * O) in fp32: lane l sums half l % 2 of row l / 2
      const int r = lane / 2, c0 = (lane % 2) * kHalf;
      const int qrow = wq0 + r;
      float part = 0.0f;
      if (qrow < Sq) {
        const bf16* orow = o + b * os.b + h * os.h + qrow * os.s + c0;
        const bf16* drow = dOs + (warp * 16 + r) * P + c0;
#pragma unroll
        for (int c = 0; c < kHalf; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 of = __bfloat1622float2(o2[i]);
            const float2 df = __bfloat1622float2(d2[i]);
            part = fmaf(df.x, of.x, part);
            part = fmaf(df.y, of.y, part);
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (lane % 2 == 0 && qrow < Sq) delta[row0 + qrow] = part;
      dl[0] = __shfl_sync(0xffffffffu, part, 2 * g);
      dl[1] = __shfl_sync(0xffffffffu, part, 2 * (g + 8));
    }
    const bf16* Kt = Ks + buf * kBlock * P;
    const bf16* Vt = Vs + buf * kBlock * P;
    const int kv0 = tile * kBlock;

    // the tile in two 32-column halves (fewer live registers); a warp whose
    // q rows all lie before a half's first kv column keeps nothing there
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = kv0 + half * 32;   // the half's first kv column
      if (causal && c0 > wq0 + 15) continue;
      // S = Q K^T and dP = dO V^T: rows q, columns kv (dO fragments
      // re-read from shared memory)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned df[4];
        ldsm_x4(df, a_rows(dOs, P, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bk[4], bv[4];
          ldsm_x4(bk, b_rows_nk(Kt, P, half * 32 + np * 16, kk * 16, lane));
          ldsm_x4(bv, b_rows_nk(Vt, P, half * 32 + np * 16, kk * 16, lane));
          mma_16816(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma_16816(dp[2 * np], df, bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], df, bv[2], bv[3]);
        }
      }

      // dS = P (dP - delta) on the kept pairs; exactly 0 elsewhere
      const bool edge = c0 + 32 > Skv || wq0 + 16 > Sq ||
                        (causal && c0 + 31 > wq0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          bool keep = true;
          if (edge) {
            const int col = c0 + j * 8 + 2 * t4 + (e & 1);
            keep = row[r] < Sq && col < Skv && (!causal || col <= row[r]);
          }
          dp[j][e] = keep ? exp2f(s[j][e] * sl2 - lse2[r]) * (dp[j][e] - dl[r])
                          : 0.0f;
        }

      // dQ += dS K: dS packed to bf16 from the fragments, K by
      // ldmatrix.trans
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const unsigned da[4] = {
            pack_bf16(dp[2 * kt][0], dp[2 * kt][1]),
            pack_bf16(dp[2 * kt][2], dp[2 * kt][3]),
            pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
            pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          unsigned bk[4];
          ldsm_x4_trans(bk,
                        b_rows_kn(Kt, P, half * 32 + kt * 16, np * 16, lane));
          mma_16816(acc[2 * np], da, bk[0], bk[1]);
          mma_16816(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                    // this stage is free for reuse
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    bf16* dst = dq + (row0 + row[r]) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// Pass B in bfloat16 on the tensor cores: per-query-head dk and dv for one
// (64-row kv tile, bh).
constexpr int kQRows = 32;          // q rows per streamed tile

template <int HD>
constexpr size_t dkv_mma_smem_bytes() {  // Ks, Vs; Qs, dOs, lse, delta x 2
  return sizeof(__nv_bfloat16) * (2 * kBlock + 4 * kQRows) *
             repro_mma::pitch<HD>() +
         sizeof(float) * 4 * kQRows;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int KV,
                         int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                         Strides dos, float scale, int causal) {
  using namespace repro_mma;
  constexpr int P = pitch<HD>();
  constexpr int QT = kQRows;
  constexpr int KS = HD / 16;           // k-steps of K Q^T over hd
  constexpr int NQ = QT / 8;            // n-tiles of a score row block
  constexpr int NO = HD / 8;            // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBlock * P;
  bf16* Qs = Vs + kBlock * P;           // [2][QT][P]
  bf16* dOs = Qs + 2 * QT * P;          // [2][QT][P]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * QT * P);   // [2][QT]
  float* Ds = Ls + 2 * QT;                                  // [2][QT]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int kv0 = blockIdx.x * kBlock;
  const int kw0 = warp * 16;            // the warp's first row in the tile
  const int krow[2] = {kv0 + kw0 + g, kv0 + kw0 + g + 8};
  const long long qrow0 = static_cast<long long>(bh) * Sq;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const int n_tiles = (Sq + QT - 1) / QT;
  // q tiles at or above the diagonal: q_pos >= kv_pos >= kv0
  const int first = causal ? kv0 / QT : 0;

  auto load_q_tile = [&](int stage, int tile) {
    const int q0 = tile * QT;
    cp_tile<HD, QT, kThreads>(Qs + stage * QT * P, qb, qs.s, q0, Sq);
    cp_tile<HD, QT, kThreads>(dOs + stage * QT * P, dob, dos.s, q0, Sq);
    for (int i = threadIdx.x; i < 2 * QT; i += kThreads) {
      const int r = i % QT;
      const bool ok = q0 + r < Sq;
      const float* src = (i < QT ? lse : delta) + qrow0 + (ok ? q0 + r : 0);
      cp_async_4((i < QT ? Ls : Ds) + stage * QT + r, src, ok);
    }
  };

  cp_tile<HD, kBlock, kThreads>(Ks, k + b * ks.b + kvh * ks.h, ks.s, kv0,
                                Skv);
  cp_tile<HD, kBlock, kThreads>(Vs, v + b * vs.b + kvh * vs.h, vs.s, kv0,
                                Skv);
  if (first < n_tiles) load_q_tile(0, first);
  cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;
  const float sl2 = scale * kLog2e;

  for (int tile = first; tile < n_tiles; ++tile) {
    const int st = (tile - first) & 1;
    if (tile + 1 < n_tiles) {           // next q tile into the other stage
      load_q_tile(st ^ 1, tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this stage (and K, V) landed
    const bf16* Qt = Qs + st * QT * P;
    const bf16* dOt = dOs + st * QT * P;
    const float* Lt = Ls + st * QT;
    const float* Dt = Ds + st * QT;

    const int q0 = tile * QT;
    // a warp whose kv rows all lie past the tile's last q row keeps nothing
    if (!causal || q0 + QT - 1 >= kv0 + kw0) {
      // S^T = K Q^T and dP^T = V dO^T: rows kv, columns q
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned ka[4], va[4];
        ldsm_x4(ka, a_rows(Ks, P, kw0, kk * 16, lane));
        ldsm_x4(va, a_rows(Vs, P, kw0, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          unsigned bq[4], bo[4];
          ldsm_x4(bq, b_rows_nk(Qt, P, np * 16, kk * 16, lane));
          ldsm_x4(bo, b_rows_nk(dOt, P, np * 16, kk * 16, lane));
          mma_16816(s[2 * np], ka, bq[0], bq[1]);
          mma_16816(s[2 * np + 1], ka, bq[2], bq[3]);
          mma_16816(dp[2 * np], va, bo[0], bo[1]);
          mma_16816(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }

      // P^T and dS^T on the kept pairs; exactly 0 elsewhere
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t4 + (e & 1);
          const int qpos = q0 + qi;
          const int kpos = krow[e >> 1];
          const bool keep =
              qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
          float p = 0.0f, ds = 0.0f;
          if (keep) {
            p = exp2f(s[j][e] * sl2 - Lt[qi] * kLog2e);
            ds = p * (dp[j][e] - Dt[qi]);
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }

      // dV += P^T dO, dK += dS^T Q: A (high and low bf16 parts) from the
      // fragments, B by ldmatrix.trans
#pragma unroll
      for (int kt = 0; kt < NQ / 2; ++kt) {
        unsigned ph[4], pl[4], dh[4], dl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {     // a_i: n-tile 2kt + i/2, rows i%2
          const int j = 2 * kt + i / 2, e = 2 * (i % 2);
          split_bf16(s[j][e], s[j][e + 1], ph[i], pl[i]);
          split_bf16(dp[j][e], dp[j][e + 1], dh[i], dl[i]);
        }
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          unsigned bo[4], bq[4];
          ldsm_x4_trans(bo, b_rows_kn(dOt, P, kt * 16, np * 16, lane));
          ldsm_x4_trans(bq, b_rows_kn(Qt, P, kt * 16, np * 16, lane));
          mma_16816(acc_v[2 * np], ph, bo[0], bo[1]);
          mma_16816(acc_v[2 * np + 1], ph, bo[2], bo[3]);
          mma_16816(acc_v[2 * np], pl, bo[0], bo[1]);
          mma_16816(acc_v[2 * np + 1], pl, bo[2], bo[3]);
          mma_16816(acc_k[2 * np], dh, bq[0], bq[1]);
          mma_16816(acc_k[2 * np + 1], dh, bq[2], bq[3]);
          mma_16816(acc_k[2 * np], dl, bq[0], bq[1]);
          mma_16816(acc_k[2 * np + 1], dl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                    // this stage is free for reuse
  }
  cp_async_wait<0>();                   // K, V when no q tile was kept

  const long long krow0 = static_cast<long long>(bh) * Skv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= Skv) continue;
    bf16* dk_row = dk + (krow0 + krow[r]) * HD + 2 * t4;
    bf16* dv_row = dv + (krow0 + krow[r]) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<unsigned*>(dk_row + n * 8) = pack_bf16(
          acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<unsigned*>(dv_row + n * 8) =
          pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, H, KV, Sq, Skv;
  Strides qs, ks, vs, os, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_dq(const Args& a) {
  constexpr size_t shmem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBlock - 1) / kBlock, a.B * a.H);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, shmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.H, a.KV, a.Sq,
      a.Skv, a.qs, a.ks, a.vs, a.os, a.dos, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_mma(const Args& a) {
  using T = __nv_bfloat16;
  constexpr size_t shmem = dq_mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBlock - 1) / kBlock, a.B * a.H);
  flash_bwd_dq_mma_kernel<HD><<<grid, kThreads, shmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.H, a.KV, a.Sq,
      a.Skv, a.qs, a.ks, a.vs, a.os, a.dos, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const Args& a) {
  constexpr size_t shmem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Skv + kBlock - 1) / kBlock, a.B * a.H);
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, shmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KV, a.Sq, a.Skv,
      a.qs, a.ks, a.vs, a.dos, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_mma(const Args& a) {
  using T = __nv_bfloat16;
  constexpr size_t shmem = dkv_mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Skv + kBlock - 1) / kBlock, a.B * a.H);
  flash_bwd_dkv_mma_kernel<HD><<<grid, kThreads, shmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KV, a.Sq, a.Skv,
      a.qs, a.ks, a.vs, a.dos, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// kernel 0: pass A in float32 (FMA); 1: pass A in bfloat16 (tensor cores);
// 2: pass B in float32 (FMA); 3: pass B in bfloat16 (tensor cores)
template <int KERNEL, int HD>
int launch_one(const Args& a) {
  if constexpr (KERNEL == 0) return launch_dq<float, HD>(a);
  else if constexpr (KERNEL == 1) return launch_dq_mma<HD>(a);
  else if constexpr (KERNEL == 2) return launch_dkv<float, HD>(a);
  else return launch_dkv_mma<HD>(a);
}

template <int KERNEL>
int dispatch_hd(const Args& a, int hd) {
  switch (hd) {
#define REPRO_FA_BWD_CASE(D) \
  case D:                    \
    return launch_one<KERNEL, D>(a);
    REPRO_FA_BWD_CASE(16)
    REPRO_FA_BWD_CASE(32)
    REPRO_FA_BWD_CASE(48)
    REPRO_FA_BWD_CASE(64)
    REPRO_FA_BWD_CASE(80)
    REPRO_FA_BWD_CASE(96)
    REPRO_FA_BWD_CASE(112)
    REPRO_FA_BWD_CASE(128)
#undef REPRO_FA_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the pass's kernel KERNEL0 for code 0, KERNEL0 + 1 for code 1
template <int KERNEL0>
int dispatch(const Args& a, int hd, int code) {
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.Sq <= 0 || a.Skv <= 0 ||
      a.H % a.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code == 0) return dispatch_hd<KERNEL0>(a, hd);
  if (code == 1) return dispatch_hd<KERNEL0 + 1>(a, hd);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entry points launch on `stream` and return a CUDA error code as an int
// (0 = the launch was accepted).  All pointers are device pointers:
//   q, o, dout  T [B, H, Sq, hd]    element (b, h, s, d) at
//                                   b*xsb + h*xsh + s*xss + d (own strides)
//   k, v        T [B, KV, Skv, hd]  likewise
//   lse, delta  f32 [B, H, Sq]      contiguous
//   dq          T [B, H, Sq, hd]    contiguous
//   dk, dv      T [B, H, Skv, hd]   contiguous, per query head
// hd a multiple of 16 up to 128.

// Pass A: writes dq and delta.  kernel 0 = the float32 FMA kernel (T =
// float), 1 = the bfloat16 tensor-core kernel (T = bfloat16; q, k, v, o,
// dout 16-byte aligned with strides that are multiples of 8, which the
// wrapper checks).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int B, int H,
    int KV, int Sq, int Skv, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    long long dsb, long long dsh, long long dss, float scale, int causal,
    int kernel, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, B, H, KV,
               Sq, Skv, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, {dsb, dsh, dss}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<0>(a, hd, kernel);
}

// Pass B: reads delta (written by pass A), writes dk and dv.  kernel 0 = the
// float32 FMA kernel (T = float), 1 = the bfloat16 tensor-core kernel (T =
// bfloat16; q, k, v, dout 16-byte aligned with strides that are multiples of
// 8, which the wrapper checks).
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KV, int Sq, int Skv, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long dsb, long long dsh, long long dss,
    float scale, int causal, int kernel, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta),
               nullptr, dk, dv, B, H, KV, Sq, Skv, {qsb, qsh, qss},
               {ksb, ksh, kss}, {vsb, vsh, vss}, {0, 0, 0}, {dsb, dsh, dss},
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<2>(a, hd, kernel);
}
