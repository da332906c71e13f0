// lifetime_scan: segmented lifetime extraction + histogram over an event
// stream sorted by (address, time).
//
// Replaces the Pallas TPU kernel `_lifetime_kernel`
// (src/repro/kernels/lifetime_scan/kernel.py, entered through
// `lifetime_scan_sorted`).  Same contract: a segment starts at a new address
// or at a write; a segment with at least one read is a live lifetime of
// (last read - first event) cycles, one with none is an orphan; live
// lifetimes are binned against integer edges; stats = (live, orphans,
// sum_lt, max_lt, reads, writes, 0, 0).  Everything is exact int64.
//
// What bounds it on an H100: bytes.  Each event is read once (8 B time +
// 8 B address + 1 B write flag = 17 B) and a few integer operations are done
// per event, so the least time is N * 17 B over the memory rate (about
// 0.057 ms for the 11.2 M events of one full-depth TinyLlama subpartition at
// 3.35 TB/s).
//
// A segment is described by its first and its last event: every event of a
// segment after its first is a read at the same address (anything else
// would be a boundary), so
//     n_reads   = (last - first) + (first event is a read ? 1 : 0)
//     lifetime  = t[last] - t[first]            (events are time-sorted)
// and a segment closes at the next boundary (or at the end of the stream).
// A segment's start travels as a key, (first << 1) | (first is a read), and
// its time.
//
// Design: ranges streamed in order, as the TPU kernel walks its grid.
// * Each block owns one contiguous range of the stream, cut into eight
//   contiguous slices, one per warp.  A warp walks its slice in order, 256
//   events per step, each lane taking 8 consecutive events with 16-byte
//   loads of t and addr and one 8-byte load of the 8 flags.  A lane takes
//   its left neighbour (time and address) from the lane before it by a
//   shuffle, lane 0 from the previous step's lane 31 (only the first event
//   of a slice reads its neighbour from global memory).
// * The segment still open at the end of a step (its start key and time)
//   is carried to the next step in registers, as the TPU kernel carries it
//   across grid steps in SMEM.  Within a step, a lane's first boundary
//   closes the segment opened by the nearest earlier lane with a boundary
//   (a ballot and one shuffle) or, failing one, the carry.  There is no
//   block barrier inside the loop.
// * A slice's first segment has its start in an earlier slice when the
//   carry is still unknown: the slice records where it ends (its head) and
//   the start of the segment open at its end (its tail).  At the end the
//   block joins its eight slices in shared memory into one summary of the
//   range; the last block to finish (a __threadfence and an atomic ticket)
//   joins the ranges' summaries with a block-wide max-scan and closes the
//   segments that cross ranges, then the stream's last segment.  Nothing
//   walks back through the stream: a segment that spans every range costs
//   one summary per range.  A call is one memset (outputs and ticket) and
//   one kernel launch.
// * Aggregation: the histogram is privatised in shared memory (32-bit
//   counts; a block's range is kept below 2**31 events), one shared atomic
//   per live lifetime (matching equal bins across the warp first was
//   slower); the bin comes from a table indexed by the lifetime's bit
//   length and one or two compares, not a full binary search.  The stats
//   stay in registers; each block flushes once with 64-bit atomics.
//   Integer atomics commute, so the result is exact and the same from run
//   to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEvents = 8;                      // consecutive events per lane
constexpr long long kStep = 32 * kEvents;       // events per warp and step
// three blocks of 256 threads per SM (80 registers a thread): 24 warps
// streaming; four (64 registers) spill
constexpr int kBlocksPerSm = 3;
constexpr unsigned kFullMask = 0xffffffffu;

// Where a segment starts: (index << 1) | (first event is a read), and its
// time.  key < 0: the start lies before the part of the stream seen here.
struct Start {
  long long key;
  long long t;
};

// What a slice or a range leaves for the join: the last event of the
// segment that entered it and closed inside it (head_end < 0: none), and
// the start of the segment still open at its end (tail_key < 0: the range
// holds no boundary and passes the entering segment through).
struct Summary {
  long long head_end;
  long long head_end_t;
  long long tail_key;
  long long tail_t;
};

struct Acc {
  unsigned live = 0, orphans = 0, writes = 0, events = 0;
  long long sum = 0, max = 0;
};

// Closes the segment from `s` to event `end`; true and its lifetime if it
// is live, false (an orphan) if it holds no read.
__device__ __forceinline__ bool close_segment(Start s, long long end,
                                              long long end_t, Acc& acc,
                                              long long& lt) {
  const long long n_reads = (end - (s.key >> 1)) + (s.key & 1);
  if (n_reads > 0) {
    lt = end_t - s.t;
    ++acc.live;
    acc.sum += lt;
    acc.max = lt > acc.max ? lt : acc.max;
    return true;
  }
  ++acc.orphans;
  return false;
}

// The block's histogram in shared memory, and how a lifetime finds its bin
// k (edges[k] <= lt < edges[k + 1]): pos = the number of edges <= lt lies
// in [lo[m], hi[m]], where m is the bit length of lt (the table is built per
// block from the edges), and a binary search over that interval ends it,
// in one or two steps for log-spaced edges.
struct Hist {
  const long long* edges;         // [n_bins + 1]
  const int* lo;                  // [64]
  const int* hi;                  // [64]
  unsigned* counts;               // [n_bins]
  int n_bins;

  __device__ __forceinline__ void add(long long lt) const {
    int l = 0, h = n_bins + 1;
    if (lt >= 0) {
      const int m = 64 - __clzll(lt);
      l = lo[m];
      h = hi[m];
    }
    while (l < h) {
      const int mid = (l + h + 1) >> 1;
      if (edges[mid - 1] <= lt) l = mid; else h = mid - 1;
    }
    if (l >= 1 && l <= n_bins) atomicAdd(&counts[l - 1], 1u);
  }
};

// The number of edges <= x (an upper bound over the n_bins + 1 edges).
__device__ __forceinline__ int edges_at_most(long long x,
                                             const long long* s_edges,
                                             int n_bins) {
  int lo = 0, hi = n_bins + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_edges[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One lane's events of one step: kEvents consecutive events from i0, nv of
// them inside the slice (the rest are zero and not looked at).
struct Step {
  long long t[kEvents], a[kEvents];
  unsigned wm;                    // bit j: event j is a write
  int nv;
  long long i0;
};

__device__ __forceinline__ Step load_step(const long long* __restrict__ t,
                                          const long long* __restrict__ addr,
                                          const unsigned char* __restrict__ w,
                                          long long base, long long w1,
                                          int lane, bool vec) {
  Step s;
  s.i0 = base + lane * kEvents;
  const long long left = w1 - s.i0;
  s.nv = left <= 0 ? 0 : (left < kEvents ? int(left) : kEvents);
  s.wm = 0;
  if (vec && s.nv == kEvents) {
    const longlong2* tp = reinterpret_cast<const longlong2*>(t + s.i0);
    const longlong2* ap = reinterpret_cast<const longlong2*>(addr + s.i0);
#pragma unroll
    for (int k = 0; k < kEvents / 2; ++k) {
      const longlong2 x = __ldg(tp + k), y = __ldg(ap + k);
      s.t[2 * k] = x.x;
      s.t[2 * k + 1] = x.y;
      s.a[2 * k] = y.x;
      s.a[2 * k + 1] = y.y;
    }
    const unsigned long long wb =
        __ldg(reinterpret_cast<const unsigned long long*>(w + s.i0));
#pragma unroll
    for (int j = 0; j < kEvents; ++j)
      if ((wb >> (8 * j)) & 0xffull) s.wm |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < kEvents; ++j) {
      s.t[j] = j < s.nv ? __ldg(t + s.i0 + j) : 0;
      s.a[j] = j < s.nv ? __ldg(addr + s.i0 + j) : 0;
      if (j < s.nv && __ldg(w + s.i0 + j)) s.wm |= 1u << j;
    }
  }
  return s;
}

__device__ __forceinline__ Summary load_summary(const Summary* p) {
  // written by other blocks in this launch: read through L2, not L1
  const long long* q = reinterpret_cast<const long long*>(p);
  return {__ldcg(q), __ldcg(q + 1), __ldcg(q + 2), __ldcg(q + 3)};
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lifetime_scan_kernel(const long long* __restrict__ t,
                     const long long* __restrict__ addr,
                     const unsigned char* __restrict__ w,
                     const long long* __restrict__ edges,
                     long long n, int n_bins, long long slice,
                     bool vec,
                     unsigned long long* __restrict__ hist,
                     long long* __restrict__ stats,
                     unsigned long long* __restrict__ ticket,
                     Summary* __restrict__ ranges) {
  // dynamic shared memory: edges [n_bins + 1] then histogram [n_bins]
  extern __shared__ long long smem[];
  long long* s_edges = smem;
  unsigned* s_hist = reinterpret_cast<unsigned*>(smem + n_bins + 1);
  __shared__ int s_lo[64], s_hi[64];   // bin search interval by bit length
  __shared__ Summary s_slice[kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int k = tid; k <= n_bins; k += kThreads) s_edges[k] = edges[k];
  for (int k = tid; k < n_bins; k += kThreads) s_hist[k] = 0u;
  __syncthreads();
  if (tid < 64) {   // lifetimes of bit length tid: 0, or [2^(tid-1), 2^tid)
    const long long lo = tid ? 1ll << (tid - 1) : 0;
    const long long hi = tid ? static_cast<long long>((1ull << tid) - 1) : 0;
    s_lo[tid] = edges_at_most(lo, s_edges, n_bins);
    s_hi[tid] = edges_at_most(hi, s_edges, n_bins);
  }
  __syncthreads();
  const Hist block_hist{s_edges, s_lo, s_hi, s_hist, n_bins};

  Acc acc;

  // ---- this warp's slice, in order --------------------------------------
  const long long w0 = (static_cast<long long>(blockIdx.x) * kWarps + warp)
                       * slice;
  const long long w1 = w0 + slice < n ? w0 + slice : n;
  Start carry{-1, 0};             // the segment open before the next step
  long long head_end = -1, head_end_t = 0;      // held by one lane at most
  long long prev_t = 0, prev_a = 0;  // event before lane 0's first event
  if (w0 < w1 && w0 > 0) {
    prev_t = __ldg(t + w0 - 1);
    prev_a = __ldg(addr + w0 - 1);
  }
  for (long long base = w0; base < w1; base += kStep) {
    const Step cur = load_step(t, addr, w, base, w1, lane, vec);
    const long long i0 = cur.i0;
    const int nv = cur.nv;
    const unsigned wm = cur.wm;
    const long long (&tv)[kEvents] = cur.t;
    const long long (&av)[kEvents] = cur.a;

    // left neighbour of this lane's first event
    long long nb_t = __shfl_up_sync(kFullMask, tv[kEvents - 1], 1);
    long long nb_a = __shfl_up_sync(kFullMask, av[kEvents - 1], 1);
    if (lane == 0) {
      nb_t = prev_t;
      nb_a = prev_a;
    }

    unsigned bm = 0;              // bit j: event j starts a segment
#pragma unroll
    for (int j = 0; j < kEvents; ++j) {
      const long long before = j ? av[j - 1] : nb_a;
      if (j < nv && (i0 + j == 0 || ((wm >> j) & 1u) || av[j] != before))
        bm |= 1u << j;
    }

    // the start of this lane's last segment
    Start mine{-1, 0};
#pragma unroll
    for (int j = 0; j < kEvents; ++j)
      if ((bm >> j) & 1u) {
        mine.key = ((i0 + j) << 1) | (((wm >> j) & 1u) ? 0 : 1);
        mine.t = tv[j];
      }

    // the segment open before this lane's first event: the last one begun
    // by an earlier lane of this step, else the carry
    const unsigned bal = __ballot_sync(kFullMask, bm != 0u);
    const unsigned earlier = bal & ((1u << lane) - 1u);
    const int src = earlier ? 31 - __clz(earlier) : lane;
    Start open{__shfl_sync(kFullMask, mine.key, src),
               __shfl_sync(kFullMask, mine.t, src)};
    if (!earlier) open = carry;

    // each boundary after event 0 closes the segment before it
    long long lts[kEvents];
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kEvents; ++j) {
      lts[j] = 0;
      if ((bm >> j) & 1u) {
        const long long i = i0 + j;
        const long long end_t = j ? tv[j - 1] : nb_t;
        if (i > 0) {
          if (open.key >= 0) {
            if (close_segment(open, i - 1, end_t, acc, lts[j]))
              live |= 1u << j;
          } else {        // began before this slice: left to the joins
            head_end = i - 1;
            head_end_t = end_t;
          }
        }
        open.key = (i << 1) | (((wm >> j) & 1u) ? 0 : 1);
        open.t = tv[j];
      }
    }
    acc.events += nv;
    acc.writes += __popc(wm);

    if (bal) {
      const int last = 31 - __clz(bal);
      carry.key = __shfl_sync(kFullMask, mine.key, last);
      carry.t = __shfl_sync(kFullMask, mine.t, last);
    }
    prev_t = __shfl_sync(kFullMask, tv[kEvents - 1], 31);
    prev_a = __shfl_sync(kFullMask, av[kEvents - 1], 31);

#pragma unroll
    for (int j = 0; j < kEvents; ++j)
      if ((live >> j) & 1u) block_hist.add(lts[j]);
  }

  // ---- the warp's summary, then the block's ------------------------------
  const unsigned has_head = __ballot_sync(kFullMask, head_end >= 0);
  if (has_head) {
    const int h = __ffs(has_head) - 1;
    head_end = __shfl_sync(kFullMask, head_end, h);
    head_end_t = __shfl_sync(kFullMask, head_end_t, h);
  }
  if (lane == 0)
    s_slice[warp] = {has_head ? head_end : -1, head_end_t, carry.key,
                     carry.t};
  __syncthreads();

  const int n_blocks = gridDim.x;
  if (tid == 0) {
    // join the slices in order: a slice's head closes the segment open at
    // the end of the slices before it, if the range holds its start
    Summary range{-1, 0, -1, 0};
    for (int k = 0; k < kWarps; ++k) {
      const Summary& s = s_slice[k];
      if (s.head_end >= 0) {
        if (range.tail_key >= 0) {
          long long lt;
          if (close_segment({range.tail_key, range.tail_t}, s.head_end,
                            s.head_end_t, acc, lt))
            block_hist.add(lt);
        } else {
          range.head_end = s.head_end;
          range.head_end_t = s.head_end_t;
        }
      }
      if (s.tail_key >= 0) {
        range.tail_key = s.tail_key;
        range.tail_t = s.tail_t;
      }
    }
    ranges[blockIdx.x] = range;
    __threadfence();              // the summary is visible before the ticket
    s_last = atomicAdd(ticket, 1ull) == static_cast<unsigned long long>(
                                           n_blocks - 1);
  }
  __syncthreads();

  // ---- the last block joins the ranges -----------------------------------
  if (s_last) {
    __threadfence();
    int prev_q = -1;              // the last range with a boundary so far
    for (int g = 0; g < n_blocks; g += kThreads) {
      const int r = g + tid;
      const Summary s = r < n_blocks ? load_summary(ranges + r)
                                     : Summary{-1, 0, -1, 0};
      // inclusive max-scan of (range holds a boundary ? r : -1)
      int incl = s.tail_key >= 0 ? r : -1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl = up > incl ? up : incl;
      }
      const int up1 = __shfl_up_sync(kFullMask, incl, 1);
      if (lane == 31) s_scan[warp] = incl;
      __syncthreads();
      int excl = prev_q;
      for (int k = 0; k < warp; ++k)
        excl = s_scan[k] > excl ? s_scan[k] : excl;
      if (lane > 0) excl = up1 > excl ? up1 : excl;
      if (r < n_blocks && s.head_end >= 0 && excl >= 0) {
        const Summary q = load_summary(ranges + excl);
        long long lt;
        if (close_segment({q.tail_key, q.tail_t}, s.head_end, s.head_end_t,
                          acc, lt))
          block_hist.add(lt);
      }
      for (int k = 0; k < kWarps; ++k)
        prev_q = s_scan[k] > prev_q ? s_scan[k] : prev_q;
      __syncthreads();            // s_scan is rewritten by the next group
    }
    // the stream's last segment closes at its last event
    if (tid == 0 && prev_q >= 0) {
      const Summary q = load_summary(ranges + prev_q);
      long long lt;
      if (close_segment({q.tail_key, q.tail_t}, n - 1, __ldg(t + n - 1),
                        acc, lt))
        block_hist.add(lt);
    }
  }

  // ---- one flush per block -----------------------------------------------
  __syncthreads();                // all shared-memory histogram updates
  for (int k = tid; k < n_bins; k += kThreads) {
    const unsigned c = s_hist[k];
    if (c) atomicAdd(&hist[k], static_cast<unsigned long long>(c));
  }
  unsigned long long live = acc.live, orphans = acc.orphans,
                     writes = acc.writes, events = acc.events;
  long long sum = acc.sum, mx = acc.max;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    live += __shfl_down_sync(kFullMask, live, off);
    orphans += __shfl_down_sync(kFullMask, orphans, off);
    writes += __shfl_down_sync(kFullMask, writes, off);
    events += __shfl_down_sync(kFullMask, events, off);
    sum += __shfl_down_sync(kFullMask, sum, off);
    const long long m = __shfl_down_sync(kFullMask, mx, off);
    mx = m > mx ? m : mx;
  }
  if (lane == 0) {
    unsigned long long* ustats = reinterpret_cast<unsigned long long*>(stats);
    if (live) atomicAdd(&ustats[0], live);
    if (orphans) atomicAdd(&ustats[1], orphans);
    if (sum) atomicAdd(&ustats[2], static_cast<unsigned long long>(sum));
    if (mx) atomicMax(&stats[3], mx);
    if (events - writes) atomicAdd(&ustats[4], events - writes);
    if (writes) atomicAdd(&ustats[5], writes);
  }
}

size_t shared_bytes(int n_bins) {
  return (static_cast<size_t>(n_bins) + 1) * sizeof(long long)
         + static_cast<size_t>(n_bins) * sizeof(unsigned);
}

}  // namespace

// The launch's grid for `n` events: each warp's slice (`*slice` events,
// whole steps, as few as fill one wave of at most `max_blocks` blocks and
// no more than the device holds at once) and the number of blocks, each
// owning a range of eight slices.  Returns a CUDA error code as an int.
extern "C" int lifetime_scan_grid(long long n, int n_bins, int max_blocks,
                                  long long* slice, int* blocks) {
  *slice = kStep;
  *blocks = 0;
  if (n <= 0) return 0;
  // blocks the device holds at once, for the last (device, n_bins) asked
  static int known_device = -1, known_bins = -1;
  static long long known_resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != known_device || n_bins != known_bins) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lifetime_scan_kernel, kThreads, shared_bytes(n_bins));
    if (err != cudaSuccess) return static_cast<int>(err);
    known_resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    known_device = device;
    known_bins = n_bins;
  }
  long long cap = known_resident;
  if (max_blocks > 0 && max_blocks < cap) cap = max_blocks;
  const long long steps = (n + kStep - 1) / kStep;
  *slice = (steps + cap * kWarps - 1) / (cap * kWarps) * kStep;
  if (*slice * kWarps >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit shared counts
  *blocks = static_cast<int>((n + *slice * kWarps - 1) / (*slice * kWarps));
  return 0;
}

// Launches the kernel on `stream`; returns a CUDA error code as an int
// (0 = the launch was accepted).  All pointers are device pointers:
//   t, addr   int64 [n]        events sorted by (addr, time)
//   w         uint8 [n]        1 = write
//   edges     int64 [n_bins+1] ascending integer bin edges
//   out       int64 [n_bins + 8 + 1 + 4 * max_blocks]: hist [n_bins],
//             stats [8], the last block's ticket, then one summary per
//             block range; one memset on `stream` zeroes hist, stats and
//             the ticket before the kernel
// The grid is `lifetime_scan_grid`'s.
extern "C" int lifetime_scan_launch(const void* t, const void* addr,
                                    const void* w, const void* edges,
                                    long long n, int n_bins, void* out,
                                    int max_blocks, void* stream) {
  if (n <= 0) return 0;
  long long slice = 0;
  int blocks = 0;
  const int err = lifetime_scan_grid(n, n_bins, max_blocks, &slice, &blocks);
  if (err != 0) return err;
  const bool vec = (reinterpret_cast<unsigned long long>(t) % 16 == 0) &&
                   (reinterpret_cast<unsigned long long>(addr) % 16 == 0) &&
                   (reinterpret_cast<unsigned long long>(w) % 8 == 0);
  long long* hist = static_cast<long long*>(out);
  long long* stats = hist + n_bins;
  long long* ticket = stats + 8;
  const cudaError_t zero = cudaMemsetAsync(
      hist, 0, (static_cast<size_t>(n_bins) + 9) * sizeof(long long),
      static_cast<cudaStream_t>(stream));
  if (zero != cudaSuccess) return static_cast<int>(zero);
  lifetime_scan_kernel<<<blocks, kThreads, shared_bytes(n_bins),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(t), static_cast<const long long*>(addr),
      static_cast<const unsigned char*>(w),
      static_cast<const long long*>(edges), n, n_bins, slice, vec,
      reinterpret_cast<unsigned long long*>(hist), stats,
      reinterpret_cast<unsigned long long*>(ticket),
      reinterpret_cast<Summary*>(ticket + 1));
  return static_cast<int>(cudaGetLastError());
}
