// flash_attention_fwd: blockwise online-softmax attention forward with GQA.
//
// Replaces the Pallas TPU kernel `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py, entered through
// `flash_attention_bhsd`).  Same contract: scores (q . k) * scale in fp32,
// masked scores -1e30 (kv positions past Skv, and kv_pos > q_pos when causal,
// top-left aligned), running (max, sum, acc) in fp32 over kv blocks,
// o = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30)) in fp32.
// Query head h of batch b reads kv head b * KV + h / (H / KV): no repeated
// heads in memory.
//
// What bounds it on an H100: each causal (q, kv) pair costs 4 * hd flops.
// At TinyLlama's training shape (S 2048, hd 64, 8 query heads per kv head)
// that is far above the card's ~295 flop/B balance point in bf16, so the
// least time is the flops over the bf16 tensor-core peak; at Zamba2's
// serving shape (S 1024, hd 80, no GQA) bytes and flops nearly balance.
//
// Two kernels, chosen by dtype alone (the wrapper's `_kernel_variant`):
//
// * bfloat16: `flash_fwd_mma_kernel`, the FA-2 structure on the tensor cores
//   (mma.sync m16n8k16, ldmatrix, cp.async; building blocks in
//   mma_bf16.cuh).  One block of 4 warps per (bh, 64-row q tile), the last
//   q tiles launched first (under the causal mask they carry the most
//   work); each warp owns 16 q rows, whose Q fragments stay in registers for
//   the whole kv loop.  K and V tiles of 64 rows stream through a two-stage
//   cp.async ring in shared memory (pitch hd + 8: ldmatrix without bank
//   conflicts).
//   S = Q K^T accumulates in fp32 fragments and is scaled there (q is never
//   rounded after scaling); the online softmax runs on the fragments (row
//   max and sum over a quad of lanes, exp2 with log2(e) folded into the
//   scale); P is packed to bf16 in registers and is the A operand of P V
//   (V by ldmatrix.trans), with no trip through shared memory.  Rounding P
//   to bf16 is the one rounding the fp32 kernel does not have (as in
//   SDPA's kernels).  Causal kv tiles wholly above the diagonal are skipped;
//   the diagonal tile and the ragged kv edge are masked element by element.
//   Rows past Sq or Skv load as zeros and are never stored.
// * float32: `flash_fwd_kernel`, fp32 FMAs on the CUDA cores (the float32
//   gates' tolerances leave no room for TF32 or bf16 operands).  One block of
//   128 threads per (bh, 64-row q block) loops over 64-row kv tiles staged
//   in shared memory as fp32: Qs [64][HD+1] (scaled on load), Ks [64][HD+1],
//   Vs [64][HD], Ps [64][65] (odd pitches keep the column walks free of bank
//   conflicts).  Thread (ty, tx) = (t / 8, t % 8) owns rows ty + 16 r (r <
//   4): scores for columns tx + 8 c (c < 8) of each kv tile, output columns
//   tx + 8 c (c < HD / 8); row max and sum are three xor-shuffles.
//
// Both are templated on the head dim (multiples of 16 up to 128; the 2560 /
// 32 = 80 of Zamba2-2.7B among them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 128;
constexpr int kRows = 4;            // rows per thread: ty + 16 r
constexpr int kCols = 8;            // score columns per thread: tx + 8 c
constexpr float kNegInf = -1e30f;

// the FMA kernel is instantiated for float only (bfloat16 runs on mma)
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (HD + 1) + kBlockKV * (HD + 1) +
                          kBlockKV * HD + kBlockQ * (kBlockKV + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int Sq, int Skv,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal) {
  constexpr int QP = HD + 1;             // row pitch of Qs and Ks
  constexpr int PP = kBlockKV + 1;       // row pitch of Ps
  constexpr int kOutCols = HD / 8;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * QP;
  float* Vs = Ks + kBlockKV * QP;
  float* Ps = Vs + kBlockKV * HD;

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBlockQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int idx = tid; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    Qs[r * QP + d] =
        row < Sq ? to_f32(qb[row * qs.s + d]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[r][c] = 0.0f;
  }

  int n_tiles = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) {
    const int last_q = min(q0 + kBlockQ, Sq) - 1;
    const int last_kv = min(last_q, Skv - 1);
    n_tiles = min(n_tiles, last_kv / kBlockKV + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBlockKV;
    __syncthreads();                 // previous tile's Ks/Vs/Ps are consumed
    for (int idx = tid; idx < kBlockKV * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int row = kv0 + r;
      const bool ok = row < Skv;
      Ks[r * QP + d] = ok ? to_f32(kb[row * ks.s + d]) : 0.0f;
      Vs[r * HD + d] = ok ? to_f32(vb[row * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRows], bv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = Qs[(ty + 16 * r) * QP + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bv[c] = Ks[(tx + 8 * c) * QP + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(a[r], bv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kpos = kv0 + tx + 8 * c;
        const bool keep = kpos < Skv && (!causal || qpos >= kpos);
        s[r][c] = keep ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        Ps[(ty + 16 * r) * PP + tx + 8 * c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[r][c] *= corr;
    }
    __syncthreads();                 // Ps complete

#pragma unroll 4
    for (int j = 0; j < kBlockKV; ++j) {
      float p[kRows], vv[kOutCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = Ps[(ty + 16 * r) * PP + j];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) vv[c] = Vs[j * HD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kOutCols; ++c)
          acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutCols; ++c)
      ob[row * os.s + tx + 8 * c] = from_f32<T>(acc[r][c] / lc);
    if (tx == 0) lse[static_cast<long long>(bh) * Sq + row] = m[r] + logf(lc);
  }
}

// ---- bfloat16: tensor cores ----------------------------------------------

constexpr int kWarpRows = 16;       // q rows per warp (4 warps, 64 rows)

template <int HD>
constexpr size_t mma_smem_bytes() {  // Qs [64], Ks [2][64], Vs [2][64] rows
  return sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockKV) *
         repro_mma::pitch<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, int causal) {
  using namespace repro_mma;
  constexpr int P = pitch<HD>();
  constexpr int KS = HD / 16;           // k-steps of Q K^T over hd
  constexpr int NS = kBlockKV / 8;      // n-tiles of a score row block
  constexpr int NO = HD / 8;            // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBlockQ * P;          // [2][64][P]
  bf16* Vs = Ks + 2 * kBlockKV * P;     // [2][64][P]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  // the last q tiles first: under the causal mask they carry the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int wq0 = q0 + warp * kWarpRows;    // the warp's first q row
  const int row[2] = {wq0 + g, wq0 + g + 8};

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  int n_tiles = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) {
    const int last_q = min(q0 + kBlockQ, Sq) - 1;
    n_tiles = min(n_tiles, min(last_q, Skv - 1) / kBlockKV + 1);
  }

  cp_tile<HD, kBlockQ, kThreads>(Qs, qb, qs.s, q0, Sq);
  cp_tile<HD, kBlockKV, kThreads>(Ks, kb, ks.s, 0, Skv);
  cp_tile<HD, kBlockKV, kThreads>(Vs, vb, vs.s, 0, Skv);
  cp_async_commit();

  unsigned qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};      // running max, log2 units
  float l[2] = {0.0f, 0.0f};            // this lane's part of the row sums
  const float sl2 = scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {           // next K/V tile into the other stage
      const int nxt = (tile + 1) * kBlockKV;
      cp_tile<HD, kBlockKV, kThreads>(Ks + (buf ^ 1) * kBlockKV * P, kb,
                                      ks.s, nxt, Skv);
      cp_tile<HD, kBlockKV, kThreads>(Vs + (buf ^ 1) * kBlockKV * P, vb,
                                      vs.s, nxt, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this stage's K/V (and Q) landed
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], a_rows(Qs, P, warp * kWarpRows, kk * 16, lane));
    }
    const bf16* Kt = Ks + buf * kBlockKV * P;
    const bf16* Vt = Vs + buf * kBlockKV * P;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, b_rows_nk(Kt, P, np * 16, kk * 16, lane));
        mma_16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale in fp32, mask, online softmax on the fragments
    const int kv0 = tile * kBlockKV;
    const bool edge = kv0 + kBlockKV > Skv ||
                      (causal && kv0 + kBlockKV - 1 > wq0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int col = kv0 + j * 8 + 2 * t4 + (e & 1);
          if (col >= Skv || (causal && col > row[e >> 1])) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V: P from the score fragments, V by ldmatrix.trans
#pragma unroll
    for (int kt = 0; kt < NS / 2; ++kt) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]),
          pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned bv[4];
        ldsm_x4_trans(bv, b_rows_kn(Vt, P, kt * 16, np * 16, lane));
        mma_16816(acc[2 * np], pa, bv[0], bv[1]);
        mma_16816(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                    // this stage is free for reuse
  }

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.0f / lc;
    bf16* dst = ob + row[r] * os.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t4 == 0)
      lse[static_cast<long long>(bh) * Sq + row[r]] = m[r] * kLn2 + logf(lc);
  }
}

// ---- launch ---------------------------------------------------------------

template <typename T, typename Kernel>
int launch_with(Kernel kernel, size_t shmem, const void* q, const void* k,
                const void* v, void* o, void* lse, int B, int H, int KV,
                int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                Strides os, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, KV, Sq, Skv, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// kernel 0: the float32 FMA kernel; kernel 1: the bfloat16 tensor-core one
template <int KERNEL, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal,
              cudaStream_t st) {
  if constexpr (KERNEL == 0)
    return launch_with<float>(flash_fwd_kernel<float, HD>, smem_bytes<HD>(),
                              q, k, v, o, lse, B, H, KV, Sq, Skv, qs, ks, vs,
                              os, scale, causal, st);
  else
    return launch_with<__nv_bfloat16>(flash_fwd_mma_kernel<HD>,
                                      mma_smem_bytes<HD>(), q, k, v, o, lse,
                                      B, H, KV, Sq, Skv, qs, ks, vs, os,
                                      scale, causal, st);
}

template <int KERNEL>
int launch_k(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int KV, int Sq, int Skv, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             cudaStream_t st) {
  switch (hd) {
#define REPRO_FA_CASE(D)                                                     \
  case D:                                                                    \
    return launch_hd<KERNEL, D>(q, k, v, o, lse, B, H, KV, Sq, Skv, qs, ks, \
                                vs, os, scale, causal, st);
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(48)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(80)
    REPRO_FA_CASE(96)
    REPRO_FA_CASE(112)
    REPRO_FA_CASE(128)
#undef REPRO_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches a kernel on `stream`; returns a CUDA error code as an int
// (0 = the launch was accepted).  All pointers are device pointers:
//   q    T [B, H, Sq, hd]    element (b, h, s, d) at b*qsb + h*qsh + s*qss + d
//   k/v  T [B, KV, Skv, hd]  likewise with their own strides
//   o    T [B, H, Sq, hd]    likewise
//   lse  f32 [B, H, Sq]      contiguous
// kernel 0 = the float32 FMA kernel (T = float), 1 = the bfloat16
// tensor-core kernel (T = bfloat16; every pointer 16-byte aligned and every
// stride a multiple of 8, which the wrapper checks); hd a multiple of 16 up
// to 128.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Skv, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    float scale, int causal, int kernel, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Skv <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return launch_k<0>(q, k, v, o, lse, B, H, KV, Sq, Skv, hd, qs, ks, vs, os,
                       scale, causal, st);
  if (kernel == 1)
    return launch_k<1>(q, k, v, o, lse, B, H, KV, Sq, Skv, hd, qs, ks, vs, os,
                       scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
