// compose_policy: the composition engine's policy kernels (B7).
//
// Replaces the jitted XLA policy kernels of the reference's fused sweep
// executor (src/repro/compose/executor.py: `_rf_fused`, `_ra_grouped`,
// `_ra_ungrouped`; per-chunk twins in compose/jax_engine.py).  C candidate
// device sets of up to D (<= 16) devices each, cheapest device first, are
// evaluated against one subpartition's L lifetimes in float64:
//
//   policy_rf_kernel            refresh-free.  One warp per candidate, one
//                               lane per device slot: the cummax of the
//                               retentions, a binary search (side="right")
//                               into the value-sorted lifetimes and into the
//                               sorted per-address max-lifetimes, energy from
//                               prefix-sum differences plus the fallback
//                               device's tail, pick counts from position
//                               differences.
//   policy_ra_grouped_kernel    refresh-aware with address groups, the
//   + policy_ra_join_kernel     C*D*L hot loop.  Per lifetime and candidate:
//                               the device minimum of the Algorithm-1 energy
//                               (summed into a per-block partial), and per
//                               device the refresh term, summed per address.
//                               Each address picks the device of least
//                               summed energy; picks are counted per (c, d).
//   policy_ra_ungrouped_kernel  refresh-aware without addresses: the argmin
//                               device of every lifetime (int8 picks) and the
//                               selected energy (per-block partials).
//
// Every kernel evaluates the energy through one function, `energy_fj`, in
// the reference's separable form
//     E_w*bits + E_r*read_bits + (E_r + E_w)*refresh_bits
// with every product and sum rounded on its own (`__dmul_rn`/`__dadd_rn`:
// no contraction into FMAs), so a kernel and the plain PyTorch version in
// kernels/compose_policy/kernel.py give bit-equal per-lifetime and
// per-address energies.  Refresh counts are max(ceil(lt / ret) - 1, 0) with
// an IEEE division (`__ddiv_rn`), never a reciprocal multiply: a reciprocal
// moves counts at exact-retention boundaries.  Ties in a device choice go to
// the lowest index.  Padded device slots (d >= n_dev[c]) are never read.
//
// What bounds them on an H100.  The grouped pass does about 8 fp64
// operations per (candidate, device, lifetime) plus the division, which is a
// long instruction sequence: operations, at 34 TFLOP/s fp64 outside the
// tensor cores.  The refresh-free kernel is a few binary searches per
// candidate; its launch dominates.
//
// Design of the grouped pass.  The lifetimes come sorted by address (one
// segment per address, segment ids `seg`).  A block owns a range of kRange
// consecutive lifetimes and a tile of kTile candidates: it stages the
// range's lt, read_bits, bits and seg in shared memory once (coalesced) and
// walks the tile's candidates over it, so the trace is read once per tile.
// A thread walks kPerThread consecutive lifetimes in order, keeping the open
// segment's per-device refresh sums in registers: a segment that starts and
// ends inside its chunk is decided there.  A segment that crosses chunks is
// carried by a block-wide scan of "transfers" (pass, add): the open sum
// leaving a chunk is `pass ? in + add : add`, with pass true only for a
// chunk that lies wholly inside one segment.  The thread where a crossing
// segment ends adds the carry to its head piece and decides it, unless the
// segment entered the range from before: then the range keeps it as its head
// summary, and the segment open at the range's end as its tail summary.  The
// second launch, the join, does the same over the ranges' summaries, one
// block per candidate, each thread a contiguous run of ranges.  Every sum is
// taken in an order fixed by the layout (no floating-point atomics), so a
// result is bit-equal from run to run; the pick counts are integers, summed
// per block in shared memory and added to device memory with one 64-bit
// atomic per (block, candidate, device).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 16;

// refresh-aware grouped pass: threads a block, lifetimes a thread
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kRange = kThreads * kPerThread;   // lifetimes a block range
constexpr int kStride = kPerThread + 1;         // padded shared row
constexpr int kTile = 16;                       // candidates a block
// the join: one block per candidate
constexpr int kJoinThreads = 128;
constexpr int kJoinWarps = kJoinThreads / 32;
// ungrouped pass
constexpr int kUThreads = 256;
constexpr int kUWarps = kUThreads / 32;
constexpr int kUPerThread = 8;
constexpr int kUBlock = kUThreads * kUPerThread;
// refresh-free: warps (candidates) a block
constexpr int kRfThreads = 128;

__device__ __forceinline__ double refresh_count(double lt, double ret) {
  // intervals the lifetime spans beyond its first; SRAM's infinite
  // retention gives ceil(0) - 1 -> 0
  return fmax(ceil(__ddiv_rn(lt, ret)) - 1.0, 0.0);
}

// The Algorithm-1 energy (fJ) of `bits` written once, read `read_bits /
// bits` times and refreshed `refresh_bits / bits` times on one device.
__device__ __forceinline__ double energy_fj(double bits, double read_bits,
                                            double refresh_bits, double rf,
                                            double wf) {
  return __dadd_rn(__dadd_rn(__dmul_rn(wf, bits), __dmul_rn(rf, read_bits)),
                   __dmul_rn(__dadd_rn(rf, wf), refresh_bits));
}

// first index i of the ascending a[0..n) with a[i] > x (side="right")
__device__ __forceinline__ long long upper_bound(const double* a,
                                                 long long n, double x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// transfers and their scans
// ---------------------------------------------------------------------------
// A transfer maps the open sum entering a stretch of lifetimes to the one
// leaving it: out = pass ? in + add : add.  Composing an earlier E with a
// later F gives (E.pass && F.pass, F.pass ? E.add + F.add : F.add).

template <int DM>
__device__ __forceinline__ void warp_inclusive(bool& pass, double (&add)[DM],
                                               int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool up_pass = __shfl_up_sync(kFull, static_cast<int>(pass), off);
    double up[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) up[d] = __shfl_up_sync(kFull, add[d], off);
    if (lane >= off) {
      if (pass) {
#pragma unroll
        for (int d = 0; d < DM; ++d) add[d] = __dadd_rn(up[d], add[d]);
      }
      pass = pass && up_pass;
    }
  }
}

// Block-wide scan of every thread's transfer (pass, add).  On return
// (pass, add) is the composition through this thread (inclusive) and
// (xpass, xadd) the composition of the threads before it (exclusive; the
// identity for thread 0).  Every thread of the block calls it; it holds two
// __syncthreads().  s_pass[WARPS], s_add[WARPS * DM] are scratch.
template <int DM, int WARPS>
__device__ __forceinline__ void block_scan(bool& pass, double (&add)[DM],
                                           bool& xpass, double (&xadd)[DM],
                                           int* s_pass, double* s_add) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_inclusive<DM>(pass, add, lane);
  if (lane == 31) {
    s_pass[warp] = pass;
#pragma unroll
    for (int d = 0; d < DM; ++d) s_add[warp * DM + d] = add[d];
  }
  xpass = __shfl_up_sync(kFull, static_cast<int>(pass), 1);
#pragma unroll
  for (int d = 0; d < DM; ++d) xadd[d] = __shfl_up_sync(kFull, add[d], 1);
  if (lane == 0) {
    xpass = true;
#pragma unroll
    for (int d = 0; d < DM; ++d) xadd[d] = 0.0;
  }
  __syncthreads();
  bool wpass = true;
  for (int w = 0; w < warp; ++w) wpass = wpass && s_pass[w];
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    double wadd = 0.0;               // the warps before this one, in order
    for (int w = 0; w < warp; ++w)
      wadd = s_pass[w] ? __dadd_rn(wadd, s_add[w * DM + d])
                       : s_add[w * DM + d];
    add[d] = pass ? __dadd_rn(wadd, add[d]) : add[d];
    xadd[d] = xpass ? __dadd_rn(wadd, xadd[d]) : xadd[d];
  }
  pass = wpass && pass;
  xpass = wpass && xpass;
  __syncthreads();
}

// Address `a` with per-device refresh sums `rsum` picks its least-energy
// device (lowest index on ties); counted in the block's shared counters.
template <int DM>
__device__ __forceinline__ void decide(int a, const double (&rsum)[DM],
                                       int nd, const double* rf,
                                       const double* wf, const double* abits,
                                       const double* arbits, unsigned* cnt) {
  const double b = abits[a], rb = arbits[a];
  double best = INFINITY;
  int pick = 0;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    if (d < nd) {
      const double v = energy_fj(b, rb, rsum[d], rf[d], wf[d]);
      if (v < best) { best = v; pick = d; }
    }
  }
  atomicAdd(&cnt[pick], 1u);
}

// ---------------------------------------------------------------------------
// refresh-free
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRfThreads) policy_rf_kernel(
    const double* __restrict__ ret, const double* __restrict__ rf,
    const double* __restrict__ wf, const int* __restrict__ n_dev, int C,
    int D, const double* __restrict__ lt_sorted, long long n_lt,
    const double* __restrict__ pbits, const double* __restrict__ prbits,
    const double* __restrict__ maxlt_sorted, long long n_addr,
    double* __restrict__ energy, long long* __restrict__ counts) {
  const int c = (blockIdx.x * kRfThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;                  // the whole warp: c is per warp
  const int nd = n_dev[c];
  const bool real = lane < nd;
  double chi = real ? ret[c * D + lane] : -INFINITY;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, chi, off);
    if (lane >= off) chi = fmax(chi, o);
  }
  // lifetimes in (chi[d-1], chi[d]] go to device d, first fit
  const long long pos = real ? upper_bound(lt_sorted, n_lt, chi) : 0;
  const long long apos =
      real && n_addr > 0 ? upper_bound(maxlt_sorted, n_addr, chi) : 0;
  long long prev = __shfl_up_sync(kFull, pos, 1);
  long long aprev = __shfl_up_sync(kFull, apos, 1);
  if (lane == 0) prev = aprev = 0;
  double e = 0.0;
  if (real)
    e = energy_fj(pbits[pos] - pbits[prev], prbits[pos] - prbits[prev], 0.0,
                  rf[c * D + lane], wf[c * D + lane]);
  const long long pos_last = __shfl_sync(kFull, pos, nd - 1);
  const long long apos_last = __shfl_sync(kFull, apos, nd - 1);
  double sum = 0.0;
  for (int d = 0; d < nd; ++d) sum = __dadd_rn(sum, __shfl_sync(kFull, e, d));
  if (lane == 0) {
    // lifetimes beyond every retention bill the fallback (last) device
    const int fb = c * D + nd - 1;
    const double tail = energy_fj(pbits[n_lt] - pbits[pos_last],
                                  prbits[n_lt] - prbits[pos_last], 0.0,
                                  rf[fb], wf[fb]);
    energy[c] = __dmul_rn(__dadd_rn(sum, tail), 1e-15);
  }
  if (lane < D) {
    long long k = real ? apos - aprev : 0;
    if (lane == nd - 1) k += n_addr - apos_last;
    counts[c * D + lane] = k;
  }
}

// ---------------------------------------------------------------------------
// refresh-aware, grouped by address
// ---------------------------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(kThreads) policy_ra_grouped_kernel(
    const double* __restrict__ ret, const double* __restrict__ rf,
    const double* __restrict__ wf, const int* __restrict__ n_dev, int C,
    int D, const double* __restrict__ lt, const double* __restrict__ rb,
    const double* __restrict__ bits, const int* __restrict__ seg,
    long long L, const double* __restrict__ abits,
    const double* __restrict__ arbits, long long n_ranges,
    double* __restrict__ energy_part, double* __restrict__ head_piece,
    double* __restrict__ tail_piece,
    unsigned long long* __restrict__ counts) {
  __shared__ double s_lt[kThreads * kStride];
  __shared__ double s_rb[kThreads * kStride];
  __shared__ double s_bits[kThreads * kStride];
  __shared__ int s_seg[kThreads * kStride];
  __shared__ double s_ret[kTile][DM], s_rf[kTile][DM], s_wf[kTile][DM];
  __shared__ int s_nd[kTile];
  __shared__ unsigned s_cnt[kTile][DM];
  __shared__ int s_pass[kWarps];
  __shared__ double s_add[kWarps * DM];
  __shared__ double s_e[kWarps];
  __shared__ int s_edge[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = blockIdx.x;
  const long long start = r * kRange;
  const int n = static_cast<int>(min(static_cast<long long>(kRange),
                                     L - start));
  const int c0 = blockIdx.y * kTile;
  const int nc = min(kTile, C - c0);

  for (int i = tid; i < n; i += kThreads) {
    const int slot = (i / kPerThread) * kStride + i % kPerThread;
    s_lt[slot] = lt[start + i];
    s_rb[slot] = rb[start + i];
    s_bits[slot] = bits[start + i];
    s_seg[slot] = seg[start + i];
  }
  if (tid == 0) {
    s_edge[0] = start > 0 ? seg[start - 1] : -1;
    s_edge[1] = start + n < L ? seg[start + n] : -1;
  }
  for (int i = tid; i < nc * DM; i += kThreads) {
    const int ci = i / DM, d = i % DM, c = c0 + ci;
    const bool real = d < D;
    s_ret[ci][d] = real ? ret[c * D + d] : 0.0;
    s_rf[ci][d] = real ? rf[c * D + d] : 0.0;
    s_wf[ci][d] = real ? wf[c * D + d] : 0.0;
    s_cnt[ci][d] = 0;
  }
  for (int i = tid; i < nc; i += kThreads) s_nd[i] = n_dev[c0 + i];
  __syncthreads();

  // this thread's chunk and how its segments meet its neighbours'
  const int row = tid * kStride;
  const int my_n = max(0, min(kPerThread, n - tid * kPerThread));
  int first_seg = -1, last_seg = -1;
  bool cont_in = false, cont_out = false;
  if (my_n > 0) {
    first_seg = s_seg[row];
    last_seg = s_seg[row + my_n - 1];
    // the last lifetime of the chunk before (that thread's chunk is full)
    const int prev = tid == 0 ? s_edge[0]
                              : s_seg[row - kStride + kPerThread - 1];
    const int next = tid * kPerThread + my_n < n ? s_seg[row + kStride]
                                                 : s_edge[1];
    cont_in = prev == first_seg;
    cont_out = next == last_seg;
  }
  const bool through = cont_in && cont_out && first_seg == last_seg;
  const bool range_in = n > 0 && s_edge[0] == s_seg[0];
  const int last_t = (n - 1) / kPerThread;

  for (int ci = 0; ci < nc; ++ci) {
    const int c = c0 + ci;
    const int nd = s_nd[ci];
    const double* crf = s_rf[ci];
    const double* cwf = s_wf[ci];
    double cur[DM], head[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) cur[d] = head[d] = 0.0;
    double e_acc = 0.0;
    bool first_piece = true;
    int cur_seg = first_seg;
    for (int k = 0; k < my_n; ++k) {
      const int slot = row + k;
      const int s = s_seg[slot];
      if (s != cur_seg) {              // the piece before closes here
        if (first_piece && cont_in) {
#pragma unroll
          for (int d = 0; d < DM; ++d) head[d] = cur[d];
        } else {
          decide<DM>(cur_seg, cur, nd, crf, cwf, abits, arbits, s_cnt[ci]);
        }
#pragma unroll
        for (int d = 0; d < DM; ++d) cur[d] = 0.0;
        first_piece = false;
        cur_seg = s;
      }
      const double l = s_lt[slot], b = s_bits[slot], rbv = s_rb[slot];
      double emin = INFINITY;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < nd) {
          const double rbits = __dmul_rn(refresh_count(l, s_ret[ci][d]), b);
          emin = fmin(emin, energy_fj(b, rbv, rbits, crf[d], cwf[d]));
          cur[d] = __dadd_rn(cur[d], rbits);
        }
      }
      e_acc = __dadd_rn(e_acc, emin);
    }
    // the chunk's transfer: through chunks pass their sum on, a chunk
    // whose last segment goes on hands it over as a new open sum
    bool pass = true;                  // an empty chunk is the identity
    if (my_n > 0) {
      pass = false;
      if (first_piece && cont_in) {
        if (through) {
          pass = true;
        } else {                       // the entering segment closes here
#pragma unroll
          for (int d = 0; d < DM; ++d) { head[d] = cur[d]; cur[d] = 0.0; }
        }
      } else if (!cont_out) {
        decide<DM>(cur_seg, cur, nd, crf, cwf, abits, arbits, s_cnt[ci]);
#pragma unroll
        for (int d = 0; d < DM; ++d) cur[d] = 0.0;
      }
    }
    bool xpass;
    double xadd[DM];
    block_scan<DM, kWarps>(pass, cur, xpass, xadd, s_pass, s_add);
    if (my_n > 0 && cont_in && !through) {
      // the segment entering this chunk ends in it
#pragma unroll
      for (int d = 0; d < DM; ++d) head[d] = __dadd_rn(xadd[d], head[d]);
      if (xpass && range_in) {         // it entered the range from before
        double* out = head_piece + (c * n_ranges + r) * D;
        for (int d = 0; d < nd; ++d) out[d] = head[d];
      } else {
        decide<DM>(first_seg, head, nd, crf, cwf, abits, arbits, s_cnt[ci]);
      }
    }
    if (tid == last_t && s_edge[1] == last_seg) {
      // the segment open at the range's end; a range inside one segment
      // leaves its whole sum as the head piece
      double* out = (pass && range_in ? head_piece : tail_piece) +
                    (c * n_ranges + r) * D;
      for (int d = 0; d < nd; ++d) out[d] = cur[d];
    }
    // the block's energy partial, in a fixed order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e_acc = __dadd_rn(e_acc, __shfl_down_sync(kFull, e_acc, off));
    if (lane == 0) s_e[warp] = e_acc;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t = __dadd_rn(t, s_e[w]);
      energy_part[c * n_ranges + r] = t;
    }
  }
  __syncthreads();
  for (int i = tid; i < nc * DM; i += kThreads) {
    const int ci = i / DM, d = i % DM;
    if (s_cnt[ci][d])
      atomicAdd(&counts[(c0 + ci) * D + d],
                static_cast<unsigned long long>(s_cnt[ci][d]));
  }
}

// The ranges' summaries, joined per candidate: each thread composes a run
// of ranges, a block scan carries the open sums between runs, and each
// thread walks its run again to close the segments that end there.
template <int DM>
__global__ void __launch_bounds__(kJoinThreads) policy_ra_join_kernel(
    const double* __restrict__ rf, const double* __restrict__ wf,
    const int* __restrict__ n_dev, int D, const int* __restrict__ seg,
    long long L, const double* __restrict__ abits,
    const double* __restrict__ arbits, long long n_ranges,
    const double* __restrict__ head_piece,
    const double* __restrict__ tail_piece,
    unsigned long long* __restrict__ counts) {
  __shared__ double s_rf[DM], s_wf[DM];
  __shared__ unsigned s_cnt[DM];
  __shared__ int s_pass[kJoinWarps];
  __shared__ double s_add[kJoinWarps * DM];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int nd = n_dev[c];
  if (tid < DM) {
    s_rf[tid] = tid < nd ? rf[c * D + tid] : 0.0;
    s_wf[tid] = tid < nd ? wf[c * D + tid] : 0.0;
    s_cnt[tid] = 0;
  }
  __syncthreads();
  const long long per = (n_ranges + kJoinThreads - 1) / kJoinThreads;
  const long long r0 = min(n_ranges, tid * per);
  const long long r1 = min(n_ranges, r0 + per);
  const double* heads = head_piece + c * n_ranges * D;
  const double* tails = tail_piece + c * n_ranges * D;

  // a range's flags, from the segment ids at its edges
  auto flags = [&](long long q, int& first, bool& cin, bool& cout,
                   bool& thr) {
    const long long s0 = q * kRange;
    const long long s1 = min(s0 + kRange, L);
    first = seg[s0];
    const int last = seg[s1 - 1];
    cin = s0 > 0 && seg[s0 - 1] == first;
    cout = s1 < L && seg[s1] == last;
    thr = cin && cout && first == last;
  };

  bool pass = true;
  double add[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) add[d] = 0.0;
  for (long long q = r0; q < r1; ++q) {
    int first;
    bool cin, cout, thr;
    flags(q, first, cin, cout, thr);
    if (thr) {
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < nd) add[d] = __dadd_rn(add[d], heads[q * D + d]);
    } else {
      pass = false;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        add[d] = cout && d < nd ? tails[q * D + d] : 0.0;
    }
  }
  bool xpass;
  double open[DM];
  block_scan<DM, kJoinWarps>(pass, add, xpass, open, s_pass, s_add);
  for (long long q = r0; q < r1; ++q) {
    int first;
    bool cin, cout, thr;
    flags(q, first, cin, cout, thr);
    if (thr) {
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < nd) open[d] = __dadd_rn(open[d], heads[q * D + d]);
      continue;
    }
    if (cin) {                         // a segment from before ends here
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < nd) open[d] = __dadd_rn(open[d], heads[q * D + d]);
      decide<DM>(first, open, nd, s_rf, s_wf, abits, arbits, s_cnt);
    }
#pragma unroll
    for (int d = 0; d < DM; ++d)
      open[d] = cout && d < nd ? tails[q * D + d] : 0.0;
  }
  __syncthreads();
  if (tid < nd && s_cnt[tid])
    atomicAdd(&counts[c * D + tid],
              static_cast<unsigned long long>(s_cnt[tid]));
}

// ---------------------------------------------------------------------------
// refresh-aware, one choice per lifetime
// ---------------------------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(kUThreads) policy_ra_ungrouped_kernel(
    const double* __restrict__ ret, const double* __restrict__ rf,
    const double* __restrict__ wf, const int* __restrict__ n_dev, int C,
    int D, const double* __restrict__ lt, const double* __restrict__ rb,
    const double* __restrict__ bits, long long L, long long n_blocks,
    double* __restrict__ energy_part, signed char* __restrict__ picks) {
  __shared__ double s_ret[kTile][DM], s_rf[kTile][DM], s_wf[kTile][DM];
  __shared__ int s_nd[kTile];
  __shared__ double s_e[kUWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long blk = blockIdx.x;
  const long long start = blk * kUBlock;
  const int c0 = blockIdx.y * kTile;
  const int nc = min(kTile, C - c0);
  for (int i = tid; i < nc * DM; i += kUThreads) {
    const int ci = i / DM, d = i % DM, c = c0 + ci;
    const bool real = d < D;
    s_ret[ci][d] = real ? ret[c * D + d] : 0.0;
    s_rf[ci][d] = real ? rf[c * D + d] : 0.0;
    s_wf[ci][d] = real ? wf[c * D + d] : 0.0;
  }
  for (int i = tid; i < nc; i += kUThreads) s_nd[i] = n_dev[c0 + i];
  double l[kUPerThread], rbv[kUPerThread], b[kUPerThread];
#pragma unroll
  for (int k = 0; k < kUPerThread; ++k) {
    const long long i = start + k * kUThreads + tid;   // coalesced
    const bool in = i < L;
    l[k] = in ? lt[i] : 0.0;
    rbv[k] = in ? rb[i] : 0.0;
    b[k] = in ? bits[i] : 0.0;
  }
  __syncthreads();
  for (int ci = 0; ci < nc; ++ci) {
    const int c = c0 + ci;
    const int nd = s_nd[ci];
    double e_acc = 0.0;
#pragma unroll
    for (int k = 0; k < kUPerThread; ++k) {
      const long long i = start + k * kUThreads + tid;
      if (i >= L) continue;
      double best = INFINITY;
      int pick = 0;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < nd) {
          const double rbits =
              __dmul_rn(refresh_count(l[k], s_ret[ci][d]), b[k]);
          const double v = energy_fj(b[k], rbv[k], rbits, s_rf[ci][d],
                                     s_wf[ci][d]);
          if (v < best) { best = v; pick = d; }
        }
      }
      picks[c * L + i] = static_cast<signed char>(pick);
      e_acc = __dadd_rn(e_acc, best);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e_acc = __dadd_rn(e_acc, __shfl_down_sync(kFull, e_acc, off));
    if (lane == 0) s_e[warp] = e_acc;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int w = 0; w < kUWarps; ++w) t = __dadd_rn(t, s_e[w]);
      energy_part[c * n_blocks + blk] = t;
    }
    __syncthreads();
  }
}

template <int DM>
cudaError_t launch_grouped(const void* ret, const void* rf, const void* wf,
                           const void* n_dev, int C, int D, const void* lt,
                           const void* rb, const void* bits, const void* seg,
                           long long L, const void* abits,
                           const void* arbits, long long n_ranges,
                           void* energy_part, void* head_piece,
                           void* tail_piece, void* counts, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n_ranges), (C + kTile - 1) / kTile);
  policy_ra_grouped_kernel<DM><<<grid, kThreads, 0, st>>>(
      static_cast<const double*>(ret), static_cast<const double*>(rf),
      static_cast<const double*>(wf), static_cast<const int*>(n_dev), C, D,
      static_cast<const double*>(lt), static_cast<const double*>(rb),
      static_cast<const double*>(bits), static_cast<const int*>(seg), L,
      static_cast<const double*>(abits), static_cast<const double*>(arbits),
      n_ranges, static_cast<double*>(energy_part),
      static_cast<double*>(head_piece), static_cast<double*>(tail_piece),
      static_cast<unsigned long long*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  policy_ra_join_kernel<DM><<<C, kJoinThreads, 0, st>>>(
      static_cast<const double*>(rf), static_cast<const double*>(wf),
      static_cast<const int*>(n_dev), D, static_cast<const int*>(seg), L,
      static_cast<const double*>(abits), static_cast<const double*>(arbits),
      n_ranges, static_cast<const double*>(head_piece),
      static_cast<const double*>(tail_piece),
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch_ungrouped(const void* ret, const void* rf, const void* wf,
                             const void* n_dev, int C, int D, const void* lt,
                             const void* rb, const void* bits, long long L,
                             long long n_blocks, void* energy_part,
                             void* picks, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n_blocks), (C + kTile - 1) / kTile);
  policy_ra_ungrouped_kernel<DM><<<grid, kUThreads, 0, st>>>(
      static_cast<const double*>(ret), static_cast<const double*>(rf),
      static_cast<const double*>(wf), static_cast<const int*>(n_dev), C, D,
      static_cast<const double*>(lt), static_cast<const double*>(rb),
      static_cast<const double*>(bits), L, n_blocks,
      static_cast<double*>(energy_part), static_cast<signed char*>(picks));
  return cudaGetLastError();
}

bool shapes_ok(int C, int D) {
  return C > 0 && D >= 1 && D <= kMaxDevices &&
         (C + kTile - 1) / kTile <= 65535;
}

}  // namespace

extern "C" int compose_policy_max_devices() { return kMaxDevices; }
extern "C" int compose_policy_range_lifetimes() { return kRange; }
extern "C" int compose_policy_thread_lifetimes() { return kPerThread; }
extern "C" int compose_policy_ungrouped_block() { return kUBlock; }

// Every launcher runs on `stream` and returns a CUDA error code (0 when the
// launches were accepted).  ret, rf, wf: [C, D] float64; n_dev: [C] int32,
// 1 <= n_dev[c] <= D <= 16.

// lt_sorted [n_lt], pbits/prbits [n_lt + 1], maxlt_sorted [n_addr] float64;
// energy [C] float64 (J), counts [C, D] int64.
extern "C" int compose_policy_rf_launch(
    const void* ret, const void* rf, const void* wf, const void* n_dev, int C,
    int D, const void* lt_sorted, long long n_lt, const void* pbits,
    const void* prbits, const void* maxlt_sorted, long long n_addr,
    void* energy, void* counts, void* stream) {
  if (!shapes_ok(C, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C * 32 + kRfThreads - 1) / kRfThreads;
  policy_rf_kernel<<<blocks, kRfThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ret), static_cast<const double*>(rf),
      static_cast<const double*>(wf), static_cast<const int*>(n_dev), C, D,
      static_cast<const double*>(lt_sorted), n_lt,
      static_cast<const double*>(pbits), static_cast<const double*>(prbits),
      static_cast<const double*>(maxlt_sorted), n_addr,
      static_cast<double*>(energy), static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// lt, rb (= reads * bits), bits [L] float64 sorted by address, seg [L] int32
// (dense segment ids, ascending); abits, arbits [A] float64 (per-address sums
// of bits and of read bits); n_ranges = ceil(L / range_lifetimes).  Outputs:
// energy_part [C, n_ranges] float64 (fJ), head_piece and tail_piece [C,
// n_ranges, D] float64 scratch, counts [C, D] int64, zeroed by the caller.
// Two launches: the grouped pass and the join.
extern "C" int compose_policy_ra_grouped_launch(
    const void* ret, const void* rf, const void* wf, const void* n_dev, int C,
    int D, const void* lt, const void* rb, const void* bits, const void* seg,
    long long L, const void* abits, const void* arbits, long long n_ranges,
    void* energy_part, void* head_piece, void* tail_piece, void* counts,
    void* stream) {
  if (!shapes_ok(C, D) || L <= 0 ||
      n_ranges != (L + kRange - 1) / kRange || n_ranges > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 4)
    err = launch_grouped<4>(ret, rf, wf, n_dev, C, D, lt, rb, bits, seg, L,
                            abits, arbits, n_ranges, energy_part, head_piece,
                            tail_piece, counts, st);
  else if (D <= 8)
    err = launch_grouped<8>(ret, rf, wf, n_dev, C, D, lt, rb, bits, seg, L,
                            abits, arbits, n_ranges, energy_part, head_piece,
                            tail_piece, counts, st);
  else
    err = launch_grouped<16>(ret, rf, wf, n_dev, C, D, lt, rb, bits, seg, L,
                             abits, arbits, n_ranges, energy_part, head_piece,
                             tail_piece, counts, st);
  return static_cast<int>(err);
}

// lt, rb, bits [L] float64 in the caller's order; n_blocks =
// ceil(L / ungrouped_block).  Outputs: energy_part [C, n_blocks] float64
// (fJ), picks [C, L] int8.
extern "C" int compose_policy_ra_ungrouped_launch(
    const void* ret, const void* rf, const void* wf, const void* n_dev, int C,
    int D, const void* lt, const void* rb, const void* bits, long long L,
    long long n_blocks, void* energy_part, void* picks, void* stream) {
  if (!shapes_ok(C, D) || L <= 0 ||
      n_blocks != (L + kUBlock - 1) / kUBlock || n_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 4)
    err = launch_ungrouped<4>(ret, rf, wf, n_dev, C, D, lt, rb, bits, L,
                              n_blocks, energy_part, picks, st);
  else if (D <= 8)
    err = launch_ungrouped<8>(ret, rf, wf, n_dev, C, D, lt, rb, bits, L,
                              n_blocks, energy_part, picks, st);
  else
    err = launch_ungrouped<16>(ret, rf, wf, n_dev, C, D, lt, rb, bits, L,
                               n_blocks, energy_part, picks, st);
  return static_cast<int>(err);
}
