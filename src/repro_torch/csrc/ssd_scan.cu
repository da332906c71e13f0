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
// x and y are fp32 or bf16, B and C fp32 or bf16, dt / A / D fp32.
//
// What bounds it on an H100: at the serving shape (b 4, l 1024, h 80, p 64,
// n 64, chunk 256) the bytes of x, y, dt, B and C over the memory rate; the
// matrix products (Q^2/2 (n + p) per chunk and head for the intra term, 2 Q
// p n for the inter term and the state update) at the bf16 tensor-core
// rate take less than half as long.
//
// The dtype pair alone picks the kernels (the wrapper's `_kernel_variant`):
//
// * bf16 x with bf16 B and C: three launches on the tensor cores (mma.sync
//   m16n8k16, ldmatrix, cp.async; mma_bf16.cuh), Mamba-2's own SSD
//   decomposition, so that every (batch, chunk, head) runs in parallel:
//   1. `ssd_chunk_state_mma_kernel`, one block of 8 warps per (chunk, head,
//      batch): the state the chunk adds, sum_j exp(cum_last - cum_j) dt_j
//      x_j B_j^T = X^T . (scaled B), into fp32 scratch [b, chunks, h, p, n],
//      with x and B streaming through a two-stage cp.async ring in 64-row
//      slabs; and (cum_j log2(e), dt_j) of every step into scratch [b,
//      chunks, h, Q, 2], so that kernel 3 repeats neither the strided dt
//      loads nor the scan.
//   2. `ssd_state_pass_kernel`: per (batch, head) the fp32 chain over the
//      chunks, which overwrites each chunk's entry, in place, with the state
//      that enters it (zero for the first) as packed (high, low) bf16 pairs.
//   3. `ssd_chunk_scan_mma_kernel`, one block of 8 warps per (128 output
//      rows, chunk, head, batch), the last row tiles launched first (they
//      carry the most work); each warp owns 16 output rows: y = exp(cum_i)
//      C_i . state^T, plus for every 64-row tile of inputs j at or below the
//      warp's rows G = C B^T on the tensor cores, W = G exp(cum_i - cum_j)
//      dt_j on the fragments (exp only where j <= i, exactly 0 elsewhere),
//      y += W X; then y += D x, written once.  C, the packed state and (cum,
//      dt) arrive by cp.async with the first B and x tiles, which then
//      stream through a two-stage ring.  Blocks of 8 warps (against 4) cut
//      the re-reads of input tiles and of the state from L2 across row
//      tiles.
//   C B^T multiplies bf16 inputs exactly into fp32.  Each other product has
//   one operand that is not a bf16 input (W, the scaled B rows, the fp32
//   state), and that operand goes in as a bf16 high part plus a bf16 low
//   part (two products each) against exact x or C.  Rounded once to bf16,
//   W alone took y to 0.77-2.5 times the 5e-2 tolerance of the check
//   against the plain version, the scaled B rows to 1.2 times and the state
//   to 0.7 times, against 0.13-0.15 with all three split, in a float64
//   emulation at Zamba2-2.7B's and Mamba-2-130M's widths
//   (tests/emulate_bf16_roundings.py).  The state stays fp32 across
//   chunks.  Limits: chunk a multiple of 16 up to 256, p a
//   multiple of 8 up to 64 (x rows are 16-byte runs; shared x tiles are
//   padded to a multiple of 16 columns with zeros), n a multiple of 16 up
//   to 128.
// * otherwise (float32 x, or float32 B and C): `ssd_scan_kernel`, fp32 FMAs
//   on the CUDA cores.  The TPU grid is (batch, chunks) with the chunk axis
//   in order and the [h, p, n] state in VMEM.  Here one block of 256 threads
//   owns one (batch, head) and loops over the chunks itself, keeping that
//   head's [p, n] state in shared memory; blocks never talk to each other.
//   A chunk of up to 256 steps does not fit in shared memory at once (x, B
//   and C of a 256-step chunk are 192 KB in fp32), so the chunk is tiled by
//   64 rows: for each 64-row tile of outputs i, the inter term comes first,
//   then every 64-row tile of inputs j at or below the diagonal adds its
//   intra term through a [64, 64] weight tile W = (C B^T) * exp(cum_i -
//   cum_j) held in shared memory.  exp is evaluated only where j <= i (the
//   TPU kernel takes exp of every pair and masks afterwards, which can
//   overflow to inf; here a masked pair never computes one).  The state is
//   updated once per chunk, after all its outputs have read the old state.
//   Thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 r and columns tx +
//   16 c of each tile; odd row pitches keep the shared-memory walks free of
//   bank conflicts.  Limits: Q <= 256, p <= 64, n <= 128.
// In both, the prefix sum of dt * A is one warp's scan (8 steps per lane,
// then shuffles), and a ragged l is padded by the caller with dt = 0
// (ops.ssd_scan), as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

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

// cum[i] = unit * sum_{t<=i} dts[t] * a_h for i < Q (Q <= 256): the
// inclusive prefix sum by one warp (lane = threadIdx.x), 8 steps per lane
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* dts,
                                             float a_h, float unit, int Q) {
  const int lane = threadIdx.x;
  float local[8];
  float run = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = lane * 8 + e;
    run += i < Q ? dts[i] * a_h : 0.0f;
    local[e] = run;
  }
  float scan = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, scan, off);
    if (lane >= off) scan += up;
  }
  const float offset = scan - run;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = lane * 8 + e;
    if (i < Q) cum[i] = (local[e] + offset) * unit;
  }
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
    if (tid < 32) chunk_cumsum(cum, dts, a_h, 1.0f, Q);
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

// ---- bf16 x, bf16 B and C: tensor cores ------------------------------------

constexpr int kStateWarps = 8;        // chunk-state block
constexpr int kScanWarps = 8;         // scan block: 16 output rows per warp
constexpr int kRows = 64;             // rows of a streamed tile
constexpr int kOutRows = 16 * kScanWarps;  // output rows of a scan block
constexpr int kPassThreads = 256;
// 16 x 16 state items per warp: [64, 128] in 32 items at most
constexpr int kMaxItems = 32 / kStateWarps;

using repro_mma::bf16;

// p rounded up to 16: the columns of a shared x tile (zeros past p)
__host__ __device__ __forceinline__ int padded_p(int p) {
  return (p + 15) & ~15;
}

// rows [0, rows) of a global matrix of `width_b`-byte rows (row stride
// `stride_b` bytes; the first `cols_b` bytes of a row are read, a multiple
// of 16) -> shared rows of pitch `pitch_b` bytes, by 16-byte cp.async; rows
// at or past `valid` and bytes at or past `cols_b` are zeros
__device__ __forceinline__ void cp_rows(void* dst, int pitch_b,
                                        const void* src, long long stride_b,
                                        int rows, int valid, int cols_b,
                                        int width_b) {
  const int chunks = width_b / 16;
  auto* d = static_cast<unsigned char*>(dst);
  auto* s = static_cast<const unsigned char*>(src);
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    const bool ok = r < valid && c * 16 < cols_b;
    repro_mma::cp_async_16(d + r * pitch_b + c * 16,
                           ok ? s + r * stride_b + c * 16 : s, ok);
  }
}

// x as a packed (high, low) bf16 pair: high in the low 16 bits
__device__ __forceinline__ unsigned pack_split(float x) {
  const bf16 hi = __float2bfloat16(x);
  const bf16 lo = __float2bfloat16(x - __bfloat162float(hi));
  return static_cast<unsigned>(__bfloat16_as_ushort(hi)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(lo)) << 16);
}

size_t state_smem_bytes(int p, int n, int Q) {
  return sizeof(bf16) * static_cast<size_t>(kRows) *
             (2 * (padded_p(p) + 8) + 3 * (n + 8))
         + sizeof(float) * 2 * Q;
}

// 1. The state chunk c adds: S = X^T . (B scaled by exp(cum_last - cum_j)
// dt_j), [p, n] fp32 -> states[b, c, h]; and (cum_j log2(e), dt_j) of every
// step -> cumdt[b, c, h].  Block (c, h, b); the chunk streams through in
// 64-row slabs (x and B in a two-stage cp.async ring).
__global__ void __launch_bounds__(32 * kStateWarps)
ssd_chunk_state_mma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           const bf16* __restrict__ Bm,
                           float* __restrict__ states,
                           float2* __restrict__ cumdt, int L, int H, int p,
                           int n, int Q) {
  using namespace repro_mma;
  const int PX = padded_p(p);
  const int xp = PX + 8, bp = n + 8;   // row pitches (elements)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [2][64][xp]
  bf16* Bs = Xs + 2 * kRows * xp;       // [2][64][bp]: B, then scaled high
  bf16* Bl = Bs + 2 * kRows * bp;       // [64][bp]: scaled low part
  float* dts = reinterpret_cast<float*>(Bl + kRows * bp);
  float* cum2 = dts + Q;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const long long t0 = static_cast<long long>(b) * L + c * Q;
  const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
  const bf16* xb = x + (t0 * H + h) * p;
  const long long xs = static_cast<long long>(H) * p;   // x row stride
  const bf16* bb = Bm + t0 * n;
  auto load_slab = [&](int stage, int j0) {
    cp_rows(Xs + stage * kRows * xp, 2 * xp, xb + j0 * xs, 2 * xs, kRows,
            Q - j0, 2 * p, 2 * PX);
    cp_rows(Bs + stage * kRows * bp, 2 * bp, bb + j0 * n, 2 * n, kRows,
            Q - j0, 2 * n, 2 * n);
  };
  load_slab(0, 0);
  cp_async_commit();

  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    dts[i] = dt[(t0 + i) * H + h];
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(cum2, dts, A[h], kLog2e, Q);
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    cumdt[bch * Q + i] = make_float2(cum2[i], dts[i]);
  const float last = cum2[Q - 1];

  // [p, n] in 16 x 16 items (m-tile of p, two n-tiles of n): warp w owns
  // items w, w + kStateWarps, ...; item i is m-tile i % (PX / 16), n group
  // i / (PX / 16)
  const int MT = PX / 16;
  const int n_items = MT * (n / 16);
  float acc[kMaxItems][2][4];
#pragma unroll
  for (int s = 0; s < kMaxItems; ++s)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0.0f;

  const int n_slabs = (Q + kRows - 1) / kRows;
  for (int sl = 0; sl < n_slabs; ++sl) {
    const int st = sl & 1, j0 = sl * kRows;
    const int rows = min(kRows, Q - j0);
    if (sl + 1 < n_slabs) {             // next slab into the other stage
      load_slab(st ^ 1, j0 + kRows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this slab landed
    bf16* Bt = Bs + st * kRows * bp;
    const bf16* Xt = Xs + st * kRows * xp;
    // B_j exp(cum_last - cum_j) dt_j as high (in place) + low bf16 parts
    for (int i = threadIdx.x; i < kRows * (n / 2); i += blockDim.x) {
      const int r = i / (n / 2), k = 2 * (i % (n / 2));
      const float w =
          r < rows ? exp2f(last - cum2[j0 + r]) * dts[j0 + r] : 0.0f;
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bt + r * bp + k));
      split_bf16(v.x * w, v.y * w,
                 *reinterpret_cast<unsigned*>(Bt + r * bp + k),
                 *reinterpret_cast<unsigned*>(Bl + r * bp + k));
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxItems; ++s) {
      const int item = warp + kStateWarps * s;
      if (item >= n_items) continue;
      const int m0 = (item % MT) * 16, n0 = (item / MT) * 16;
      for (int k0 = 0; k0 < rows; k0 += 16) {
        unsigned a[4], bh[4], bl[4];
        ldsm_x4_trans(a, a_rows_km(Xt, xp, k0, m0, lane));
        ldsm_x4_trans(bh, b_rows_kn(Bt, bp, k0, n0, lane));
        ldsm_x4_trans(bl, b_rows_kn(Bl, bp, k0, n0, lane));
        mma_16816(acc[s][0], a, bh[0], bh[1]);
        mma_16816(acc[s][1], a, bh[2], bh[3]);
        mma_16816(acc[s][0], a, bl[0], bl[1]);
        mma_16816(acc[s][1], a, bl[2], bl[3]);
      }
    }
    __syncthreads();                    // this stage and Bl are free
  }

  float* out = states + bch * p * n;
#pragma unroll
  for (int s = 0; s < kMaxItems; ++s) {
    const int item = warp + kStateWarps * s;
    if (item >= n_items) continue;
    const int m0 = (item % MT) * 16, n0 = (item / MT) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pp = m0 + g + 8 * r;
      if (pp >= p) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<float2*>(out + pp * n + n0 + nt * 8 + 2 * t4) =
            make_float2(acc[s][nt][2 * r], acc[s][nt][2 * r + 1]);
    }
  }
}

// 2. The fp32 chain over the chunks of one (batch, head): entry c of
// `states` becomes the state entering chunk c (zero for the first), in
// place, as packed (high, low) bf16 pairs.  Block (element group, h, b).
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float2* __restrict__ cumdt, int nc, int H,
                      int pn, int Q) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float carry = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
    float* at = states + bch * pn + e;
    const float add = *at;
    *reinterpret_cast<unsigned*>(at) = pack_split(carry);
    carry = exp2f(cumdt[bch * Q + Q - 1].x) * carry + add;
  }
}

size_t scan_smem_bytes(int p, int n) {
  const int xp = padded_p(p) + 8, bp = n + 8;
  return sizeof(bf16) * (static_cast<size_t>(kOutRows) * bp +
                         2 * kRows * (bp + xp))
         + sizeof(unsigned) * static_cast<size_t>(padded_p(p)) * (n + 8)
         + sizeof(float2) * kMaxChunk;
}

// 3. y for kOutRows rows of one (chunk, head, batch): the inter term from
// the state entering the chunk, the intra term 64-row input tile by tile,
// then D x.  Block (row tile and chunk, h, b).
__global__ void __launch_bounds__(32 * kScanWarps)
ssd_chunk_scan_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const float* __restrict__ D,
                          const unsigned* __restrict__ states,
                          const float2* __restrict__ cumdt,
                          bf16* __restrict__ y, int L, int H, int p, int n,
                          int Q, int nc) {
  using namespace repro_mma;
  const int PX = padded_p(p);
  const int NP = PX / 16;               // 16-column groups of y
  const int xp = PX + 8, bp = n + 8, sp = n + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [kOutRows][bp]
  bf16* Bs = Cs + kOutRows * bp;        // [2][64][bp]
  bf16* Xs = Bs + 2 * kRows * bp;       // [2][64][xp]
  unsigned* Ss = reinterpret_cast<unsigned*>(Xs + 2 * kRows * xp);
                                        // [PX][sp] state (high, low) pairs
  float2* cd = reinterpret_cast<float2*>(Ss + PX * sp);  // [Q] (cum, dt)

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_tiles = (Q + kOutRows - 1) / kOutRows;
  // the last row tiles first: they carry the most work
  const int tile = n_tiles - 1 - blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = tile * kOutRows;       // first output row (in the chunk)
  const int last_jt = (min(i0 + kOutRows, Q) - 1) / kRows;  // input tiles
  const int wr0 = i0 + warp * 16;       // the warp's first row
  const int row[2] = {wr0 + g, wr0 + g + 8};
  const bool active = wr0 < Q;
  const long long t0 = static_cast<long long>(b) * L + c * Q;
  const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
  const bf16* xb = x + (t0 * H + h) * p;
  const long long xs = static_cast<long long>(H) * p;   // x row stride
  const bf16* bb = Bm + t0 * n;
  auto load_tile = [&](int stage, int j0) {
    cp_rows(Bs + stage * kRows * bp, 2 * bp, bb + j0 * n, 2 * n, kRows,
            Q - j0, 2 * n, 2 * n);
    cp_rows(Xs + stage * kRows * xp, 2 * xp, xb + j0 * xs, 2 * xs, kRows,
            Q - j0, 2 * p, 2 * PX);
  };

  cp_rows(Cs, 2 * bp, Cm + (t0 + i0) * n, 2 * n, kOutRows, Q - i0, 2 * n,
          2 * n);
  cp_rows(cd, 16, cumdt + bch * Q, 16, Q / 2, Q / 2, 16, 16);
  if (c > 0)
    cp_rows(Ss, 4 * sp, states + bch * p * n, 4 * n, PX, p, 4 * n, 4 * n);
  load_tile(0, 0);
  cp_async_commit();

  float acc[8][4];                      // y: 16 rows x PX columns per warp
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int jt = 0; jt <= last_jt; ++jt) {
    const int st = jt & 1;
    if (jt < last_jt) {                 // next B/x tile into the other stage
      load_tile(st ^ 1, (jt + 1) * kRows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // this stage (and C, state, cum) ready
    const bf16* Bt = Bs + st * kRows * bp;
    const bf16* Xt = Xs + st * kRows * xp;
    const int j0 = jt * kRows;

    // a warp whose rows all lie before the tile's first row keeps nothing
    if (active && j0 <= wr0 + 15) {
      float ci[2];                      // cum of the warp's rows, log2 units
#pragma unroll
      for (int r = 0; r < 2; ++r) ci[r] = cd[row[r]].x;
      if (jt == 0 && c > 0) {
        // inter: y = exp(cum_i) C_i . state^T, the state's high and low
        // parts unpacked from its (high, low) pairs
        for (int k0 = 0; k0 < n; k0 += 16) {
          unsigned a[4];
          ldsm_x4(a, a_rows(Cs, bp, warp * 16, k0, lane));
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= 2 * NP) continue;
            const unsigned* sr = Ss + (nt * 8 + g) * sp + k0 + 2 * t4;
            const uint2 w0 = *reinterpret_cast<const uint2*>(sr);
            const uint2 w1 = *reinterpret_cast<const uint2*>(sr + 8);
            mma_16816(acc[nt], a, __byte_perm(w0.x, w0.y, 0x5410),
                      __byte_perm(w1.x, w1.y, 0x5410));
            mma_16816(acc[nt], a, __byte_perm(w0.x, w0.y, 0x7632),
                      __byte_perm(w1.x, w1.y, 0x7632));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= exp2f(ci[e >> 1]);
      }

      // 16-row groups of this j tile at or below the warp's last row
      const int nk = min(4, (wr0 + 15 - j0) / 16 + 1);
      // G = C_i . B_j^T: rows i, columns j
      float w[8][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[jn][e] = 0.0f;
      for (int k0 = 0; k0 < n; k0 += 16) {
        unsigned a[4];
        ldsm_x4(a, a_rows(Cs, bp, warp * 16, k0, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= nk) continue;
          unsigned bk[4];
          ldsm_x4(bk, b_rows_nk(Bt, bp, np * 16, k0, lane));
          mma_16816(w[2 * np], a, bk[0], bk[1]);
          mma_16816(w[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      // W = G exp(cum_i - cum_j) dt_j where j <= i, exactly 0 elsewhere
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + jn * 8 + 2 * t4 + (e & 1);
          float v = 0.0f;
          if (j <= row[e >> 1]) {
            const float2 cj = cd[j];
            v = w[jn][e] * exp2f(ci[e >> 1] - cj.x) * cj.y;
          }
          w[jn][e] = v;
        }
      // y += W X: W (high and low bf16 parts) from the fragments, X by
      // ldmatrix.trans
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt >= nk) continue;
        unsigned wh[4], wl[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // a_q: n-tile 2kt + q/2, rows q%2
          const int jn = 2 * kt + q / 2, e = 2 * (q % 2);
          split_bf16(w[jn][e], w[jn][e + 1], wh[q], wl[q]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= NP) continue;
          unsigned bx[4];
          ldsm_x4_trans(bx, b_rows_kn(Xt, xp, kt * 16, np * 16, lane));
          mma_16816(acc[2 * np], wh, bx[0], bx[1]);
          mma_16816(acc[2 * np + 1], wh, bx[2], bx[3]);
          mma_16816(acc[2 * np], wl, bx[0], bx[1]);
          mma_16816(acc[2 * np + 1], wl, bx[2], bx[3]);
        }
      }
    }
    if (jt < last_jt) __syncthreads();  // this stage is free for reuse
  }

  // y += D x, written once
  if (!active) return;
  const float d_h = D[h];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((t0 + row[r]) * H + h) * p + 2 * t4;
    const bf16* xr = x + at;
    bf16* yr = y + at;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt * 8 >= p) continue;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + nt * 8));
      *reinterpret_cast<unsigned*>(yr + nt * 8) =
          pack_bf16(acc[nt][2 * r] + d_h * xv.x,
                    acc[nt][2 * r + 1] + d_h * xv.y);
    }
  }
}

int launch_mma(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, void* y, void* states,
               void* cumdt, int b, int l, int h, int p, int n, int chunk,
               cudaStream_t stream) {
  if (p % 8 != 0 || n % 16 != 0 || chunk % 16 != 0 || states == nullptr ||
      cumdt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = l / chunk;
  const size_t shm_state = state_smem_bytes(p, n, chunk);
  const size_t shm_scan = scan_smem_bytes(p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shm_state));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shm_scan));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* xb = static_cast<const bf16*>(x);
  float2* cd = static_cast<float2*>(cumdt);
  ssd_chunk_state_mma_kernel<<<dim3(nc, h, b), 32 * kStateWarps, shm_state,
                               stream>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(B), static_cast<float*>(states), cd, l, h, p,
      n, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int pn = p * n;
  ssd_state_pass_kernel<<<dim3((pn + kPassThreads - 1) / kPassThreads, h, b),
                          kPassThreads, 0, stream>>>(
      static_cast<float*>(states), cd, nc, h, pn, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (chunk + kOutRows - 1) / kOutRows;
  ssd_chunk_scan_mma_kernel<<<dim3(n_tiles * nc, h, b), 32 * kScanWarps,
                              shm_scan, stream>>>(
      xb, static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<const float*>(D), static_cast<const unsigned*>(states), cd,
      static_cast<bf16*>(y), l, h, p, n, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernels on `stream`; returns a CUDA error code as an int
// (0 = every launch was accepted).  All pointers are device pointers to
// contiguous arrays:
//   x, y    [b, l, h, p]         dtype_x  (0 = float32, 1 = bfloat16)
//   dt      [b, l, h]            float32
//   A, D    [h]                  float32
//   B, C    [b, l, n]            dtype_bc (0 = float32, 1 = bfloat16)
//   states  [b, l / chunk, h, p, n]     float32 scratch } used only by the
//   cumdt   [b, l / chunk, h, chunk, 2] float32 scratch } tensor-core path
// l must be a multiple of chunk; chunk <= 256, p <= 64, n <= 128.  bf16 x
// with bf16 B and C runs the tensor-core kernels (x, B, C 16-byte aligned;
// chunk and n multiples of 16, p a multiple of 8, which the wrapper checks);
// every other pair the FMA kernel.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               void* y, void* states, void* cumdt, int b,
                               int l, int h, int p, int n, int chunk,
                               int dtype_x, int dtype_bc, void* stream) {
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
    return launch_mma(x, dt, A, B, C, D, y, states, cumdt, b, l, h, p, n,
                      chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
