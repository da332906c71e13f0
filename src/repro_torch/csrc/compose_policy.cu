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
//
// Refresh-aware, in three steps around the batch's R distinct finite
// retentions `ret_u` (a gain cell's retention does not depend on its area or
// energy scale, so a grid of hundreds of device slots holds a few dozen;
// `ridx[c, d]` names a slot's row, -1 for an infinite retention, which
// refreshes nothing):
//
//   policy_retention_kernel     the retention pass, once per (retention,
//   + policy_retention_join_kernel  lifetime): q = lt / ret_u[r] by one IEEE
//                               division.  With address groups, the policy's
//                               refresh bits max(ceil(q) - 1, 0) * bits,
//                               summed per address (a segmented sum over the
//                               address-sorted lifetimes, then the join);
//                               without, Algorithm 1's floor(q) * bits,
//                               summed per retention (the monolithic
//                               baselines' refresh bits; no join).
//   policy_ra_candidate_kernel  the candidate pass: each block recomputes its
//     <grouped | ungrouped>     lifetimes' refresh bits for every retention
//                               into shared memory, then every candidate's
//                               lifetime takes its least-energy device, with
//                               no division and no segment logic in the
//                               (candidate, device, lifetime) loop; energy
//                               into per-block partials, and without address
//                               groups the int8 pick of every lifetime.
//   policy_ra_decide_kernel     with address groups: each (candidate,
//                               address) picks the device of least summed
//                               energy from the per-address refresh sums;
//                               picks counted per (candidate, device).
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
// the lowest index.  Padded device slots (d >= n_dev[c]) are never used.
//
// What bounds them on an H100.  Before the retention index, every (candidate,
// device, lifetime) paid an fp64 division (about 25 fp64-pipe instructions
// of some 35) and the grouped pass kept per-slot, per-address sums for every
// candidate.  Now the division and the segmented sums run R * L times (the
// retention pass; the candidate pass recomputes the division R * L times
// more), and the (candidate, device, lifetime) loop is about 7 fp64
// operations on a row read from shared memory: operations, at 34 TFLOP/s
// fp64 outside the tensor cores.  The decide step is C * D * A of the same.
// The refresh-free kernel is a few binary searches per candidate; its
// launch dominates.
//
// Design of the retention pass.  The lifetimes come sorted by address (one
// segment per address, segment ids `seg`).  A block owns a range of kRange
// consecutive lifetimes: it stages the range's lt, bits and seg in shared
// memory once (coalesced) and walks every retention over it in turn.  A
// thread walks kPerThread consecutive lifetimes in order, keeping the open
// segment's refresh sum in a register: a segment that starts and ends inside
// its chunk is written there.  A segment that crosses chunks is carried by a
// block-wide scan of "transfers" (pass, add): the open sum leaving a chunk is
// `pass ? in + add : add`, with pass true only for a chunk that lies wholly
// inside one segment.  The thread where a crossing segment ends adds the
// carry to its head piece and writes it, unless the segment entered the
// range from before: then the range keeps it as its head summary, and the
// segment open at the range's end as its tail summary.  The second launch,
// the join, does the same over the ranges' summaries, one block per
// retention, each thread a contiguous run of ranges.  Every per-address sum
// is written exactly once.  Without address groups the pass computes only
// the floor sums, over the same ranges and chunks.
//
// Design of the candidate pass.  A block owns kCBlock = 256 lifetimes, two
// a thread, and first writes its lifetimes' refresh bits for every
// retention into its own columns of a shared table of R + 1 rows (the last
// row zero, for infinite retentions): 8 * (R + 1) * kCBlock bytes, so
// R <= 96 keeps it under 227 KB (the wrapper's caller splits larger batches
// into groups of candidates); at the wide grid (R = 24) 50 KB, four blocks
// (16 warps) an SM.  Then it walks the candidates a tile at a time, each
// device slot staged as one 32-byte record (energies, E_r + E_w, row) that
// serves both of a thread's lifetimes, and per candidate reduces the
// selected energies across the block in a fixed order.
//
// Every sum is taken in an order fixed by the layout (no floating-point
// atomics), so a result is bit-equal from run to run; the pick counts are
// integers, summed per block in shared memory and added to device memory
// with one 64-bit atomic per (block, candidate, device).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 16;

// retention pass: threads a block, lifetimes a thread
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kRange = kThreads * kPerThread;   // lifetimes a block range
constexpr int kStride = kPerThread + 1;         // padded shared row
// the join: one block per retention
constexpr int kJoinThreads = 128;
constexpr int kJoinWarps = kJoinThreads / 32;
// candidate pass: threads a block, lifetimes a thread, candidates a staged
// tile, and the retentions one launch takes
constexpr int kCThreads = 128;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCPer = 2;
constexpr int kCBlock = kCThreads * kCPer;      // lifetimes a block
constexpr int kCTile = 32;
constexpr int kMaxRetentions = 96;
// decide: addresses (threads) a block
constexpr int kDThreads = 256;
// refresh-free: warps (candidates) a block
constexpr int kRfThreads = 128;

// The Algorithm-1 energy (fJ) of `bits` written once, read `read_bits /
// bits` times and refreshed `refresh_bits / bits` times on one device;
// `rw` = E_r + E_w, rounded.
__device__ __forceinline__ double energy_fj(double bits, double read_bits,
                                            double refresh_bits, double rf,
                                            double wf, double rw) {
  return __dadd_rn(__dadd_rn(__dmul_rn(wf, bits), __dmul_rn(rf, read_bits)),
                   __dmul_rn(rw, refresh_bits));
}

__device__ __forceinline__ double energy_fj(double bits, double read_bits,
                                            double refresh_bits, double rf,
                                            double wf) {
  return energy_fj(bits, read_bits, refresh_bits, rf, wf, __dadd_rn(rf, wf));
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

__device__ __forceinline__ void warp_inclusive(bool& pass, double& add,
                                               int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool up_pass = __shfl_up_sync(kFull, static_cast<int>(pass), off);
    const double up = __shfl_up_sync(kFull, add, off);
    if (lane >= off) {
      if (pass) add = __dadd_rn(up, add);
      pass = pass && up_pass;
    }
  }
}

// Block-wide scan of every thread's transfer (pass, add).  On return
// (pass, add) is the composition through this thread (inclusive) and
// (xpass, xadd) the composition of the threads before it (exclusive; the
// identity for thread 0).  Every thread of the block calls it; it holds two
// __syncthreads().  s_pass[WARPS], s_add[WARPS] are scratch.
template <int WARPS>
__device__ __forceinline__ void block_scan(bool& pass, double& add,
                                           bool& xpass, double& xadd,
                                           int* s_pass, double* s_add) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_inclusive(pass, add, lane);
  if (lane == 31) {
    s_pass[warp] = pass;
    s_add[warp] = add;
  }
  xpass = __shfl_up_sync(kFull, static_cast<int>(pass), 1);
  xadd = __shfl_up_sync(kFull, add, 1);
  if (lane == 0) {
    xpass = true;
    xadd = 0.0;
  }
  __syncthreads();
  bool wpass = true;
  double wadd = 0.0;                 // the warps before this one, in order
  for (int w = 0; w < warp; ++w) {
    wpass = wpass && s_pass[w];
    wadd = s_pass[w] ? __dadd_rn(wadd, s_add[w]) : s_add[w];
  }
  add = pass ? __dadd_rn(wadd, add) : add;
  xadd = xpass ? __dadd_rn(wadd, xadd) : xadd;
  pass = wpass && pass;
  xpass = wpass && xpass;
  __syncthreads();
}

// the sum of a warp's values, in a fixed tree; lane 0 holds it
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;
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
// refresh-aware: the retention pass
// ---------------------------------------------------------------------------

// One block a range of kRange lifetimes, every retention in turn.  kSeg:
// address-sorted lifetimes with their segment ids; the per-address refresh
// sums `rs` [R, A] and the ranges' head and tail summaries [R, n_ranges].
// Without: floor_part [R, n_ranges], each range's sum of
// floor(lt / ret) * bits.
template <bool kSeg>
__global__ void __launch_bounds__(kThreads) policy_retention_kernel(
    const double* __restrict__ ret_u, int R, const double* __restrict__ lt,
    const double* __restrict__ bits, const int* __restrict__ seg,
    long long L, long long A, long long n_ranges, double* __restrict__ rs,
    double* __restrict__ floor_part, double* __restrict__ head_piece,
    double* __restrict__ tail_piece) {
  __shared__ double s_lt[kThreads * kStride];
  __shared__ double s_bits[kThreads * kStride];
  __shared__ int s_seg[kSeg ? kThreads * kStride : 1];
  __shared__ int s_pass[kWarps];
  __shared__ double s_add[kWarps];
  __shared__ double s_f[2][kWarps];    // by the parity of r: see below
  __shared__ int s_edge[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q = blockIdx.x;
  const long long start = q * kRange;
  const int n = static_cast<int>(min(static_cast<long long>(kRange),
                                     L - start));
  for (int i = tid; i < n; i += kThreads) {
    const int slot = (i / kPerThread) * kStride + i % kPerThread;
    s_lt[slot] = lt[start + i];
    s_bits[slot] = bits[start + i];
    if (kSeg) s_seg[slot] = seg[start + i];
  }
  if (kSeg && tid == 0) {
    s_edge[0] = start > 0 ? seg[start - 1] : -1;
    s_edge[1] = start + n < L ? seg[start + n] : -1;
  }
  __syncthreads();

  // this thread's chunk and how its segments meet its neighbours'
  const int row = tid * kStride;
  const int my_n = max(0, min(kPerThread, n - tid * kPerThread));
  int first_seg = -1, last_seg = -1;
  bool cont_in = false, cont_out = false, range_in = false;
  int last_t = 0;
  if (kSeg) {
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
    range_in = n > 0 && s_edge[0] == s_seg[0];
    last_t = (n - 1) / kPerThread;
  }
  const bool through = cont_in && cont_out && first_seg == last_seg;

  for (int r = 0; r < R; ++r) {
    const double t = ret_u[r];
    double cur = 0.0, head = 0.0, f_acc = 0.0;
    bool first_piece = true;
    int cur_seg = first_seg;
    for (int k = 0; k < my_n; ++k) {
      const int slot = row + k;
      if (kSeg) {
        const int s = s_seg[slot];
        if (s != cur_seg) {            // the piece before closes here
          if (first_piece && cont_in) head = cur;
          else rs[r * A + cur_seg] = cur;
          cur = 0.0;
          first_piece = false;
          cur_seg = s;
        }
      }
      const double b = s_bits[slot];
      const double qt = __ddiv_rn(s_lt[slot], t);   // the one division
      if (kSeg)
        cur = __dadd_rn(cur, __dmul_rn(fmax(ceil(qt) - 1.0, 0.0), b));
      else
        f_acc = __dadd_rn(f_acc, __dmul_rn(floor(qt), b));
    }
    if (kSeg) {
      // the chunk's transfer: through chunks pass their sum on, a chunk
      // whose last segment goes on hands it over as a new open sum
      bool pass = true;                // an empty chunk is the identity
      if (my_n > 0) {
        pass = false;
        if (first_piece && cont_in) {
          if (through) {
            pass = true;
          } else {                     // the entering segment closes here
            head = cur;
            cur = 0.0;
          }
        } else if (!cont_out) {
          rs[r * A + cur_seg] = cur;
          cur = 0.0;
        }
      }
      bool xpass;
      double xadd;
      block_scan<kWarps>(pass, cur, xpass, xadd, s_pass, s_add);
      if (my_n > 0 && cont_in && !through) {
        // the segment entering this chunk ends in it
        head = __dadd_rn(xadd, head);
        if (xpass && range_in) head_piece[r * n_ranges + q] = head;
        else rs[r * A + first_seg] = head;
      }
      if (tid == last_t && s_edge[1] == last_seg) {
        // the segment open at the range's end; a range inside one segment
        // leaves its whole sum as the head piece
        (pass && range_in ? head_piece : tail_piece)[r * n_ranges + q] = cur;
      }
    } else {
      // the range's floor partial; s_f alternates with r, so a warp that
      // runs ahead into r + 1 never overwrites what thread 0 still reads
      f_acc = warp_sum(f_acc);
      if (lane == 0) s_f[r & 1][warp] = f_acc;
      __syncthreads();
      if (tid == 0) {
        double s = 0.0;
        for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, s_f[r & 1][w]);
        floor_part[r * n_ranges + q] = s;
      }
    }
  }
}

// The ranges' summaries, joined per retention: each thread composes a run
// of ranges, a block scan carries the open sums between runs, and each
// thread walks its run again to write the segments that end there.
__global__ void __launch_bounds__(kJoinThreads) policy_retention_join_kernel(
    const int* __restrict__ seg, long long L, long long A,
    long long n_ranges, const double* __restrict__ head_piece,
    const double* __restrict__ tail_piece, double* __restrict__ rs) {
  __shared__ int s_pass[kJoinWarps];
  __shared__ double s_add[kJoinWarps];
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const long long per = (n_ranges + kJoinThreads - 1) / kJoinThreads;
  const long long r0 = min(n_ranges, tid * per);
  const long long r1 = min(n_ranges, r0 + per);
  const double* heads = head_piece + r * n_ranges;
  const double* tails = tail_piece + r * n_ranges;
  double* out = rs + r * A;

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
  double add = 0.0;
  for (long long q = r0; q < r1; ++q) {
    int first;
    bool cin, cout, thr;
    flags(q, first, cin, cout, thr);
    if (thr) {
      add = __dadd_rn(add, heads[q]);
    } else {
      pass = false;
      add = cout ? tails[q] : 0.0;
    }
  }
  bool xpass;
  double open;
  block_scan<kJoinWarps>(pass, add, xpass, open, s_pass, s_add);
  for (long long q = r0; q < r1; ++q) {
    int first;
    bool cin, cout, thr;
    flags(q, first, cin, cout, thr);
    if (thr) {
      open = __dadd_rn(open, heads[q]);
      continue;
    }
    if (cin) out[first] = __dadd_rn(open, heads[q]);   // ends here
    open = cout ? tails[q] : 0.0;
  }
}

// ---------------------------------------------------------------------------
// refresh-aware: the candidate pass
// ---------------------------------------------------------------------------

// A device slot of a staged candidate: its energies, E_r + E_w, and the
// offset of its retention's row in the refresh table (32 bytes, read as two
// 16-byte loads).
struct __align__(16) Slot {
  double rf, wf, rw;
  int row;
};

// One block kCBlock lifetimes (in the caller's order; a thread the two at
// tid and tid + kCThreads), every candidate.  ridx [C, D] int32 rows into
// ret_u (-1: infinite retention).  kPicks: the int8 pick of every
// (candidate, lifetime) [C, L].  energy_part [C, n_blocks] (fJ).  Dynamic
// shared memory: 8 * (R + 1) * kCBlock bytes.
template <int DM, bool kPicks>
__global__ void __launch_bounds__(kCThreads) policy_ra_candidate_kernel(
    const double* __restrict__ ret_u, int R, const int* __restrict__ ridx,
    const double* __restrict__ rf, const double* __restrict__ wf,
    const int* __restrict__ n_dev, int C, int D,
    const double* __restrict__ lt, const double* __restrict__ rb,
    const double* __restrict__ bits, long long L, long long n_blocks,
    double* __restrict__ energy_part, signed char* __restrict__ picks) {
  extern __shared__ double s_rbits[];  // [R + 1][kCBlock], row R zero
  __shared__ Slot s_slot[kCTile][DM];
  __shared__ int s_nd[kCTile];
  __shared__ double s_e[kCTile][kCWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long blk = blockIdx.x;
  const long long i0 = blk * kCBlock + tid, i1 = i0 + kCThreads;
  const bool in0 = i0 < L, in1 = i1 < L;
  const double b0 = in0 ? bits[i0] : 0.0, b1 = in1 ? bits[i1] : 0.0;
  const double rb0 = in0 ? rb[i0] : 0.0, rb1 = in1 ? rb[i1] : 0.0;
  {
    // this thread's lifetimes' refresh bits for every retention: its own
    // two columns, so no other thread reads them and no barrier is needed
    const double l0 = in0 ? lt[i0] : 0.0, l1 = in1 ? lt[i1] : 0.0;
    for (int r = 0; r < R; ++r) {
      const double t = ret_u[r];
      s_rbits[r * kCBlock + tid] =
          __dmul_rn(fmax(ceil(__ddiv_rn(l0, t)) - 1.0, 0.0), b0);
      s_rbits[r * kCBlock + tid + kCThreads] =
          __dmul_rn(fmax(ceil(__ddiv_rn(l1, t)) - 1.0, 0.0), b1);
    }
    s_rbits[R * kCBlock + tid] = 0.0;
    s_rbits[R * kCBlock + tid + kCThreads] = 0.0;
  }
  const double* col = s_rbits + tid;

  for (int c0 = 0; c0 < C; c0 += kCTile) {
    const int nc = min(kCTile, C - c0);
    __syncthreads();                   // the tile before is done with s_*
    for (int k = tid; k < nc * DM; k += kCThreads) {
      const int ci = k / DM, d = k % DM, c = c0 + ci;
      const bool real = d < D;
      const double f_r = real ? rf[c * D + d] : 0.0;
      const double f_w = real ? wf[c * D + d] : 0.0;
      const int rr = real ? ridx[c * D + d] : -1;
      Slot sl;
      sl.rf = f_r;
      sl.wf = f_w;
      sl.rw = __dadd_rn(f_r, f_w);
      sl.row = (rr < 0 ? R : rr) * kCBlock;
      s_slot[ci][d] = sl;
    }
    for (int k = tid; k < nc; k += kCThreads) s_nd[k] = n_dev[c0 + k];
    __syncthreads();
    for (int ci = 0; ci < nc; ++ci) {
      const int nd = s_nd[ci];
      double best0 = INFINITY, best1 = INFINITY;
      int pick0 = 0, pick1 = 0;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < nd) {
          const Slot sl = s_slot[ci][d];
          const double v0 = energy_fj(b0, rb0, col[sl.row], sl.rf, sl.wf,
                                      sl.rw);
          const double v1 = energy_fj(b1, rb1, col[sl.row + kCThreads],
                                      sl.rf, sl.wf, sl.rw);
          if (v0 < best0) { best0 = v0; pick0 = d; }
          if (v1 < best1) { best1 = v1; pick1 = d; }
        }
      }
      if (kPicks) {
        signed char* out = picks + static_cast<long long>(c0 + ci) * L;
        if (in0) out[i0] = static_cast<signed char>(pick0);
        if (in1) out[i1] = static_cast<signed char>(pick1);
      }
      const double e = warp_sum(__dadd_rn(in0 ? best0 : 0.0,
                                          in1 ? best1 : 0.0));
      if (lane == 0) s_e[ci][warp] = e;
    }
    __syncthreads();
    if (tid < nc) {
      double t = 0.0;
      for (int w = 0; w < kCWarps; ++w) t = __dadd_rn(t, s_e[tid][w]);
      energy_part[(c0 + tid) * n_blocks + blk] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// refresh-aware: the decision per address
// ---------------------------------------------------------------------------

// One block kDThreads addresses, every candidate: the address picks the
// device of least energy_fj(abits, arbits, rs[ridx[c, d], a]), lowest index
// on ties; counts [C, D] int64, zeroed by the caller.
template <int DM>
__global__ void __launch_bounds__(kDThreads) policy_ra_decide_kernel(
    const int* __restrict__ ridx, const double* __restrict__ rf,
    const double* __restrict__ wf, const int* __restrict__ n_dev, int C,
    int D, const double* __restrict__ rs, long long A,
    const double* __restrict__ abits, const double* __restrict__ arbits,
    unsigned long long* __restrict__ counts) {
  __shared__ double s_rf[kCTile][DM], s_wf[kCTile][DM], s_rw[kCTile][DM];
  __shared__ long long s_row[kCTile][DM];
  __shared__ int s_nd[kCTile];
  __shared__ unsigned s_cnt[kCTile][DM];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long a = static_cast<long long>(blockIdx.x) * kDThreads + tid;
  const bool in = a < A;
  const double b = in ? abits[a] : 0.0;
  const double rbv = in ? arbits[a] : 0.0;
  for (int c0 = 0; c0 < C; c0 += kCTile) {
    const int nc = min(kCTile, C - c0);
    __syncthreads();                   // the tile before is counted
    for (int k = tid; k < nc * DM; k += kDThreads) {
      const int ci = k / DM, d = k % DM, c = c0 + ci;
      const bool real = d < D;
      const double f_r = real ? rf[c * D + d] : 0.0;
      const double f_w = real ? wf[c * D + d] : 0.0;
      const int rr = real ? ridx[c * D + d] : -1;
      s_rf[ci][d] = f_r;
      s_wf[ci][d] = f_w;
      s_rw[ci][d] = __dadd_rn(f_r, f_w);
      s_row[ci][d] = rr < 0 ? -1 : rr * A;
      s_cnt[ci][d] = 0;
    }
    for (int k = tid; k < nc; k += kDThreads) s_nd[k] = n_dev[c0 + k];
    __syncthreads();
    for (int ci = 0; ci < nc; ++ci) {
      const int nd = s_nd[ci];
      double best = INFINITY;
      int pick = 0;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < nd) {
          const long long off = s_row[ci][d];
          const double rsum = off < 0 || !in ? 0.0 : __ldg(rs + off + a);
          const double v = energy_fj(b, rbv, rsum, s_rf[ci][d], s_wf[ci][d],
                                     s_rw[ci][d]);
          if (v < best) { best = v; pick = d; }
        }
      }
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (d < nd) {
          const unsigned m = __ballot_sync(kFull, in && pick == d);
          if (lane == 0 && m) atomicAdd(&s_cnt[ci][d], __popc(m));
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < nc * DM; k += kDThreads) {
      const int ci = k / DM, d = k % DM;
      if (s_cnt[ci][d])
        atomicAdd(&counts[(c0 + ci) * D + d],
                  static_cast<unsigned long long>(s_cnt[ci][d]));
    }
  }
}

template <int DM, bool kPicks>
cudaError_t launch_candidates(const void* ret_u, int R, const void* ridx,
                              const void* rf, const void* wf,
                              const void* n_dev, int C, int D, const void* lt,
                              const void* rb, const void* bits, long long L,
                              long long n_blocks, void* energy_part,
                              void* picks, cudaStream_t st) {
  const size_t smem = sizeof(double) * (R + 1) * kCBlock;
  auto* kernel = policy_ra_candidate_kernel<DM, kPicks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_blocks), kCThreads, smem, st>>>(
      static_cast<const double*>(ret_u), R, static_cast<const int*>(ridx),
      static_cast<const double*>(rf), static_cast<const double*>(wf),
      static_cast<const int*>(n_dev), C, D, static_cast<const double*>(lt),
      static_cast<const double*>(rb), static_cast<const double*>(bits), L,
      n_blocks, static_cast<double*>(energy_part),
      static_cast<signed char*>(picks));
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch_decide(const void* ridx, const void* rf, const void* wf,
                          const void* n_dev, int C, int D, const void* rs,
                          long long A, const void* abits, const void* arbits,
                          void* counts, cudaStream_t st) {
  const long long blocks = (A + kDThreads - 1) / kDThreads;
  policy_ra_decide_kernel<DM><<<static_cast<unsigned>(blocks), kDThreads, 0,
                                st>>>(
      static_cast<const int*>(ridx), static_cast<const double*>(rf),
      static_cast<const double*>(wf), static_cast<const int*>(n_dev), C, D,
      static_cast<const double*>(rs), A, static_cast<const double*>(abits),
      static_cast<const double*>(arbits),
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

bool shapes_ok(int C, int D) {
  return C > 0 && D >= 1 && D <= kMaxDevices;
}

}  // namespace

extern "C" int compose_policy_max_devices() { return kMaxDevices; }
extern "C" int compose_policy_range_lifetimes() { return kRange; }
extern "C" int compose_policy_thread_lifetimes() { return kPerThread; }
extern "C" int compose_policy_candidate_block() { return kCBlock; }
extern "C" int compose_policy_max_retentions() { return kMaxRetentions; }

// Every launcher runs on `stream` and returns a CUDA error code (0 when the
// launches were accepted).  rf, wf: [C, D] float64; n_dev: [C] int32,
// 1 <= n_dev[c] <= D <= 16; ret_u [R] float64, the distinct finite
// retentions; ridx [C, D] int32, rows into ret_u or -1.

// ret, rf, wf [C, D]; lt_sorted [n_lt], pbits/prbits [n_lt + 1],
// maxlt_sorted [n_addr] float64; energy [C] float64 (J), counts [C, D]
// int64.
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

// lt, bits [L] float64 (sorted by address when seg is given); seg [L] int32
// dense segment ids 0..A-1, ascending, or null; n_ranges = ceil(L /
// range_lifetimes).  With seg, two launches (the pass and the join) and the
// outputs rs [R, A] float64 (every entry written) and head_piece, tail_piece
// [R, n_ranges] float64 scratch; floor_part is not read.  Without, one
// launch and floor_part [R, n_ranges] float64; the other outputs are not
// read.
extern "C" int compose_policy_retention_launch(
    const void* ret_u, int R, const void* lt, const void* bits,
    const void* seg, long long L, long long A, long long n_ranges, void* rs,
    void* floor_part, void* head_piece, void* tail_piece, void* stream) {
  if (R < 1 || L <= 0 || (seg ? A <= 0 || !rs || !head_piece || !tail_piece
                               : !floor_part) ||
      n_ranges != (L + kRange - 1) / kRange || n_ranges > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_ranges);
  const double* u = static_cast<const double*>(ret_u);
  const double* l = static_cast<const double*>(lt);
  const double* b = static_cast<const double*>(bits);
  const int* s = static_cast<const int*>(seg);
  double* out = static_cast<double*>(rs);
  double* fp = static_cast<double*>(floor_part);
  double* hp = static_cast<double*>(head_piece);
  double* tp = static_cast<double*>(tail_piece);
  if (!seg) {
    policy_retention_kernel<false><<<grid, kThreads, 0, st>>>(
        u, R, l, b, nullptr, L, 0, n_ranges, nullptr, fp, nullptr, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  policy_retention_kernel<true><<<grid, kThreads, 0, st>>>(
      u, R, l, b, s, L, A, n_ranges, out, nullptr, hp, tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  policy_retention_join_kernel<<<R, kJoinThreads, 0, st>>>(
      s, L, A, n_ranges, hp, tp, out);
  return static_cast<int>(cudaGetLastError());
}

// lt, rb (= reads * bits), bits [L] float64; R <= max_retentions; n_blocks
// = ceil(L / candidate_block).  Outputs: energy_part [C, n_blocks] float64
// (fJ); with want_picks, picks [C, L] int8 (else null).
extern "C" int compose_policy_ra_candidates_launch(
    const void* ret_u, int R, const void* ridx, const void* rf,
    const void* wf, const void* n_dev, int C, int D, const void* lt,
    const void* rb, const void* bits, long long L, long long n_blocks,
    int want_picks, void* energy_part, void* picks, void* stream) {
  if (!shapes_ok(C, D) || R < 0 || R > kMaxRetentions || L <= 0 ||
      n_blocks != (L + kCBlock - 1) / kCBlock ||
      n_blocks > 0x7fffffffLL || (want_picks && !picks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CANDIDATES(DM, P)                                                   \
  launch_candidates<DM, P>(ret_u, R, ridx, rf, wf, n_dev, C, D, lt, rb,     \
                           bits, L, n_blocks, energy_part, picks, st)
  cudaError_t err;
  if (want_picks)
    err = D <= 4 ? CANDIDATES(4, true)
        : D <= 8 ? CANDIDATES(8, true) : CANDIDATES(16, true);
  else
    err = D <= 4 ? CANDIDATES(4, false)
        : D <= 8 ? CANDIDATES(8, false) : CANDIDATES(16, false);
#undef CANDIDATES
  return static_cast<int>(err);
}

// rs [R, A] float64 (the retention pass's per-address refresh sums); abits,
// arbits [A] float64 (per-address sums of bits and of read bits).  Output:
// counts [C, D] int64, zeroed by the caller.
extern "C" int compose_policy_ra_decide_launch(
    const void* ridx, const void* rf, const void* wf, const void* n_dev,
    int C, int D, const void* rs, long long A, const void* abits,
    const void* arbits, void* counts, void* stream) {
  if (!shapes_ok(C, D) || A <= 0 ||
      (A + kDThreads - 1) / kDThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 4)
    err = launch_decide<4>(ridx, rf, wf, n_dev, C, D, rs, A, abits, arbits,
                           counts, st);
  else if (D <= 8)
    err = launch_decide<8>(ridx, rf, wf, n_dev, C, D, rs, A, abits, arbits,
                           counts, st);
  else
    err = launch_decide<16>(ridx, rf, wf, n_dev, C, D, rs, A, abits, arbits,
                            counts, st);
  return static_cast<int>(err);
}
