// ssd_scan: the Mamba-2 SSD chunked scan.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py, entered through `ssd_scan_chunked`
// and `ops.ssd_scan`).  Same contract, per batch b and head h, chunk by
// chunk of Q steps with a [p, n] fp32 state that starts at zero:
//   cum_i   = sum_{t<=i} dt_t * A_h                       (within the chunk)
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//           + exp(cum_i) C_i . state                                (inter)
//           + D_h x_i
//   state  <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// x and y are fp32 or bf16, B and C fp32 or bf16, dt / A / D fp32; all
// arithmetic is fp32.
//
// What bounds it on an H100: operations.  Per (batch, chunk, head) the
// products are Q^2/2 * (n + p) for the intra term and 2 Q p n for the inter
// term and the state update, against Q (p + 2 n) elements read, so the
// least time is the flops over a matrix-unit peak; this first version runs
// them as fp32 FMAs on the CUDA cores (no mma).
//
// Design.  The TPU grid is (batch, chunks) with the chunk axis in order and
// the [h, p, n] state in VMEM.  Here one block of 256 threads owns one
// (batch, head) and loops over the chunks itself, keeping that head's
// [p, n] state in shared memory; blocks never talk to each other.  A chunk
// of up to 256 steps does not fit in shared memory at once (x, B and C of a
// 256-step chunk are 192 KB in fp32), so the chunk is tiled by 64 rows:
// for each 64-row tile of outputs i, the inter term comes first, then every
// 64-row tile of inputs j at or below the diagonal adds its intra term
// through a [64, 64] weight tile W = (C B^T) * exp(cum_i - cum_j) held in
// shared memory.  exp is evaluated only where j <= i (the TPU kernel takes
// exp of every pair and masks afterwards, which can overflow to inf; here a
// masked pair never computes one).  The state is updated once per chunk,
// after all its outputs have read the old state.  The prefix sum of dt * A
// is one warp's scan (8 steps per lane, then shuffles).  Thread (ty, tx) =
// (t / 16, t % 16) owns rows ty + 16 r and columns tx + 16 c of each tile;
// odd row pitches keep the shared-memory walks free of bank conflicts.
// Limits: Q <= 256, p <= 64, n <= 128.  Ragged l is padded by the caller
// with dt = 0 (ops.ssd_scan), as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kWPitch = kTile + 1;

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

size_t smem_floats(int p, int n) {
  const int np = n + 1;
  return 2 * kMaxChunk            // dt, cum of the chunk
         + static_cast<size_t>(p) * np   // state [p][n+1]
         + 2 * kTile * np                // C tile, B tile
         + kTile * p                     // x tile (scaled)
         + kTile * kWPitch;              // W tile
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TB* __restrict__ Bm,
                const TB* __restrict__ Cm, const float* __restrict__ D,
                TX* __restrict__ y, int L, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* dts = smem;
  float* cum = dts + kMaxChunk;
  float* St = cum + kMaxChunk;
  float* Cs = St + P * NP;
  float* Bs = Cs + kTile * NP;
  float* Xs = Bs + kTile * NP;
  float* Ws = Xs + kTile * P;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const float a_h = A[hi];
  const float d_h = D[hi];

  for (int idx = tid; idx < P * NP; idx += kThreads) St[idx] = 0.0f;

  // element offsets of step t of this batch
  auto x_at = [&](int t, int pp) -> long long {
    return ((static_cast<long long>(bi) * L + t) * H + hi) * P + pp;
  };
  auto bc_at = [&](int t, int k) -> long long {
    return (static_cast<long long>(bi) * L + t) * N + k;
  };

  const int n_chunks = L / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int base = ch * Q;
    __syncthreads();   // the previous chunk is done with dts/cum/tiles
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = dt[(static_cast<long long>(bi) * L + base + i) * H + hi];
    __syncthreads();
    if (tid < 32) {    // inclusive prefix sum of dt * A: 8 steps per lane
      float local[8];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = tid * 8 + e;
        run += i < Q ? dts[i] * a_h : 0.0f;
        local[e] = run;
      }
      float scan = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, scan, off);
        if (tid >= off) scan += up;
      }
      const float offset = scan - run;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = tid * 8 + e;
        if (i < Q) cum[i] = local[e] + offset;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    // ---- outputs, one 64-row tile at a time ----
    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int rows_i = min(kTile, Q - i0);
      __syncthreads();
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, k = idx % N;
        Cs[r * NP + k] = r < rows_i ? to_f32(Cm[bc_at(base + i0 + r, k)])
                                    : 0.0f;
      }
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ri = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          float s = 0.0f;
          if (pp < P && ri < rows_i) {
            for (int k = 0; k < N; ++k)
              s = fmaf(Cs[ri * NP + k], St[pp * NP + k], s);
            s *= expf(cum[i0 + ri]);
          }
          acc[r][c] = s;
        }
      }

      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int rows_j = min(kTile, Q - j0);
        __syncthreads();
        for (int idx = tid; idx < kTile * N; idx += kThreads) {
          const int r = idx / N, k = idx % N;
          Bs[r * NP + k] = r < rows_j ? to_f32(Bm[bc_at(base + j0 + r, k)])
                                      : 0.0f;
        }
        for (int idx = tid; idx < kTile * P; idx += kThreads) {
          const int r = idx / P, pp = idx % P;
          Xs[idx] = r < rows_j
                        ? to_f32(x[x_at(base + j0 + r, pp)]) * dts[j0 + r]
                        : 0.0f;
        }
        __syncthreads();

        float cb[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[r][c] = 0.0f;
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * NP + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * NP + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) cb[r][c] = fmaf(cv[r], bv[c], cb[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ri = ty + 16 * r, i = i0 + ri;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rj = tx + 16 * c, j = j0 + rj;
            const bool keep = ri < rows_i && rj < rows_j && j <= i;
            Ws[ri * kWPitch + rj] =
                keep ? cb[r][c] * expf(cum[i] - cum[j]) : 0.0f;
          }
        }
        __syncthreads();

        for (int rj = 0; rj < kTile; ++rj) {
          float wv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = Ws[(ty + 16 * r) * kWPitch + rj];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int pp = tx + 16 * c;
            xv[c] = pp < P ? Xs[rj * P + pp] : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ri = ty + 16 * r;
        if (ri >= rows_i) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          if (pp >= P) continue;
          const long long at = x_at(base + i0 + ri, pp);
          y[at] = from_f32<TX>(acc[r][c] + d_h * to_f32(x[at]));
        }
      }
    }

    // ---- state update, after every output of the chunk read the old state
    float upd[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) upd[r][c] = 0.0f;
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int rows_j = min(kTile, Q - j0);
      __syncthreads();
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, k = idx % N;
        Bs[r * NP + k] = r < rows_j ? to_f32(Bm[bc_at(base + j0 + r, k)])
                                    : 0.0f;
      }
      for (int idx = tid; idx < kTile * P; idx += kThreads) {
        const int r = idx / P, pp = idx % P;
        Xs[idx] = r < rows_j
                      ? to_f32(x[x_at(base + j0 + r, pp)]) * dts[j0 + r] *
                            expf(cum_last - cum[j0 + r])
                      : 0.0f;
      }
      __syncthreads();
      for (int rj = 0; rj < kTile; ++rj) {
        float uv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pp = ty + 16 * r;
          uv[r] = pp < P ? Xs[rj * P + pp] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = tx + 16 * c;
          bv[c] = k < N ? Bs[rj * NP + k] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) upd[r][c] = fmaf(uv[r], bv[c], upd[r][c]);
      }
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = ty + 16 * r;
      if (pp >= P) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = tx + 16 * c;
        if (k < N) St[pp * NP + k] = St[pp * NP + k] * decay + upd[r][c];
      }
    }
  }
}

template <typename TX, typename TB>
int launch_typed(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* D, void* y, int b, int l, int h,
                 int p, int n, int chunk, cudaStream_t stream) {
  const size_t shmem = smem_floats(p, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b);
  ssd_scan_kernel<TX, TB><<<grid, kThreads, shmem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TB*>(B),
      static_cast<const TB*>(C), static_cast<const float*>(D),
      static_cast<TX*>(y), l, h, p, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns a CUDA error code as an int
// (0 = the launch was accepted).  All pointers are device pointers to
// contiguous arrays:
//   x, y  [b, l, h, p]  dtype_x  (0 = float32, 1 = bfloat16)
//   dt    [b, l, h]     float32
//   A, D  [h]           float32
//   B, C  [b, l, n]     dtype_bc (0 = float32, 1 = bfloat16)
// l must be a multiple of chunk; chunk <= 256, p <= 64, n <= 128.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               void* y, int b, int l, int h, int p, int n,
                               int chunk, int dtype_x, int dtype_bc,
                               void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      l % chunk != 0 || chunk > kMaxChunk || p > kMaxP || n > kMaxN ||
      h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_x == 0 && dtype_bc == 0)
    return launch_typed<float, float>(x, dt, A, B, C, D, y, b, l, h, p, n,
                                      chunk, st);
  if (dtype_x == 0 && dtype_bc == 1)
    return launch_typed<float, __nv_bfloat16>(x, dt, A, B, C, D, y, b, l, h,
                                              p, n, chunk, st);
  if (dtype_x == 1 && dtype_bc == 0)
    return launch_typed<__nv_bfloat16, float>(x, dt, A, B, C, D, y, b, l, h,
                                              p, n, chunk, st);
  if (dtype_x == 1 && dtype_bc == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, D, y,
                                                      b, l, h, p, n, chunk,
                                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}
