// flash_attention_fwd: blockwise online-softmax attention forward with GQA.
//
// Replaces the Pallas TPU kernel `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py, entered through
// `flash_attention_bhsd`).  Same contract: scores (q * scale) . k in fp32,
// masked scores -1e30 (kv positions past Skv, and kv_pos > q_pos when causal,
// top-left aligned), running (max, sum, acc) in fp32 over kv blocks,
// o = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30)) in fp32.
// Query head h of batch b reads kv head b * KV + h / (H / KV): no repeated
// heads in memory.
//
// What bounds it on an H100: operations.  At the serving shapes (Sq = Skv =
// 1024, hd 80) each (q, kv) pair costs 4 * hd flops against a few bytes, far
// above the card's ~295 flop/B balance point in bf16.  The least time is the
// flops over the bf16 tensor-core peak; this first version does its products
// with fp32 FMAs on the CUDA cores (no mma), so it sits well above that
// bound.  That is deliberate: simple and right first.
//
// Design.  The TPU grid walks (bh, q block, kv block) with the kv axis in
// order and the softmax state in VMEM.  Here one block of 128 threads owns
// one (bh, 64-row q block) and loops over 64-row kv tiles itself, so nothing
// is carried between blocks.  Tiles are staged in shared memory as fp32:
//   Qs [64][HD+1] (scaled on load), Ks [64][HD+1], Vs [64][HD], Ps [64][65]
// (odd row pitches keep the column walks free of bank conflicts).  Thread
// (ty, tx) = (t / 8, t % 8) owns rows ty + 16 r (r < 4): it computes scores
// for columns tx + 8 c (c < 8) of each kv tile and accumulates output
// columns tx + 8 c (c < HD / 8).  The eight threads of a row are adjacent
// lanes, so row max and row sum are three xor-shuffles.  With `causal`, kv
// tiles wholly above the diagonal are skipped (their probabilities are
// exactly 0 once a row has seen key 0).  Out-of-range q rows and kv rows are
// loaded as zeros, so no garbage can reach p . v.  The kernel is templated
// on the head dim (multiples of 16 up to 128; the 2560 / 32 = 80 of
// Zamba2-2.7B among them) and on the element type (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 128;
constexpr int kRows = 4;            // rows per thread: ty + 16 r
constexpr int kCols = 8;            // score columns per thread: tx + 8 c
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal,
              cudaStream_t stream) {
  constexpr size_t shmem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, KV, Sq, Skv, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int KV, int Sq, int Skv, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             cudaStream_t st) {
  switch (hd) {
#define REPRO_FA_CASE(D)                                                     \
  case D:                                                                    \
    return launch_hd<T, D>(q, k, v, o, lse, B, H, KV, Sq, Skv, qs, ks, vs,  \
                           os, scale, causal, st);
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

// Launches the kernel on `stream`; returns a CUDA error code as an int
// (0 = the launch was accepted).  All pointers are device pointers:
//   q    T [B, H, Sq, hd]    element (b, h, s, d) at b*qsb + h*qsh + s*qss + d
//   k/v  T [B, KV, Skv, hd]  likewise with their own strides
//   o    T [B, H, Sq, hd]    likewise
//   lse  f32 [B, H, Sq]      contiguous
// dtype 0 = float32, 1 = bfloat16; hd a multiple of 16 up to 128.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Skv, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Skv <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, lse, B, H, KV, Sq, Skv, hd, qs, ks, vs,
                           os, scale, causal, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, o, lse, B, H, KV, Sq, Skv, hd, qs,
                                   ks, vs, os, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
