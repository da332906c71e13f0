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
// flop/B balance point in bf16.  This first version does the products with
// fp32 FMAs on the CUDA cores (no mma), as the forward kernel does, so it sits
// well above the tensor-core bound.  Simple and right first.
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
// Tiles are staged in shared memory as fp32 with odd row pitches (HD + 1,
// 65), which keep the column walks free of bank conflicts.  Thread (ty, tx) =
// (t / 8, t % 8) owns tile rows ty + 16 r (r < 4) and the columns tx + 8 c of
// the 64 x 64 score tile and of the HD-wide accumulators, so a row's eight
// threads are adjacent lanes.  Rows past Sq or Skv load as zeros, and exp is
// taken only where the mask keeps the pair: a masked or padded pair
// contributes exactly 0, never 0 * inf or 0 * NaN.  Templated on the head dim
// (multiples of 16 up to 128) and on the element type (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 128;
constexpr int kRows = 4;            // tile rows per thread: ty + 16 r
constexpr int kCols = 8;            // score columns per thread: tx + 8 c
constexpr int kSP = kBlock + 1;     // row pitch of the score tiles

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

template <bool kDq, typename T>
int dispatch_hd(const Args& a, int hd) {
  switch (hd) {
#define REPRO_FA_BWD_CASE(D)                                   \
  case D:                                                      \
    return kDq ? launch_dq<T, D>(a) : launch_dkv<T, D>(a);
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

template <bool kDq>
int dispatch(const Args& a, int hd, int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.Sq <= 0 || a.Skv <= 0 ||
      a.H % a.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_hd<kDq, float>(a, hd);
  if (dtype == 1) return dispatch_hd<kDq, __nv_bfloat16>(a, hd);
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
// dtype 0 = float32, 1 = bfloat16; hd a multiple of 16 up to 128.

// Pass A: writes dq and delta.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int B, int H,
    int KV, int Sq, int Skv, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    long long dsb, long long dsh, long long dss, float scale, int causal,
    int dtype, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, B, H, KV,
               Sq, Skv, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, {dsb, dsh, dss}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, hd, dtype);
}

// Pass B: reads delta (written by pass A), writes dk and dv.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KV, int Sq, int Skv, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long dsb, long long dsh, long long dss,
    float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta),
               nullptr, dk, dv, B, H, KV, Sq, Skv, {qsb, qsh, qss},
               {ksb, ksh, kss}, {vsb, vsh, vss}, {0, 0, 0}, {dsb, dsh, dss},
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, hd, dtype);
}
