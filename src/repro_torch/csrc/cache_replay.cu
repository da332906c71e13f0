// cache_replay: set-parallel LRU write-back cache replay of one cache level.
//
// Replaces the jitted XLA scan `_simulate_cache_sets`
// (src/repro/backends/cachesim.py, called from
// `_simulate_cache_set_parallel`).  Same contract: accesses to different
// sets of a set-associative cache are independent, so each set replays its
// own accesses in stream order against a ways-wide state; the victim of a
// fill is the least recently touched way, untouched ways in index order
// first (the reference's unique keys `clock * ways + way` over initial keys
// 0..ways-1); under no-write-allocate only reads allocate.  One int64 per
// access:
//     (evict_addr + 1) << 3 | evict_dirty << 2 | fill << 1 | hit
// with evict_addr = -1 when nothing valid was evicted.  Everything is exact.
//
// Layout (built by `kernels/cache_replay/ops.py`): the stream stably sorted
// by set, `packed = line_addr * 2 + is_write` (line addresses in [0, 2^59)),
// with each set's offset and count.  There is no padding to a common length
// and no fallback.  The output is written in the same sorted layout.  The
// wrapper picks one of two designs by the write policy alone; neither is a
// fallback for the other.
//
// Write-allocate: the split replay.  Every access touches its set, so the
// lines resident at any point of a set's stream, in LRU order, are the last
// `ways` distinct lines accessed before it (fewer while the set has seen
// fewer: the other ways are invalid).  Hit, fill and the evicted line
// depend only on that ordered list, since an invalid way is always taken
// before a valid one and way indices never show in the output.  Only the
// dirty bits depend on history, and they are carried symbolically.  So the
// sorted stream is cut into chunks of S consecutive accesses (a chunk may
// hold the end of one set and the start of others; each piece lies in one
// set), and the chunks replay in parallel:
//   1. `split_summary_kernel`: each chunk's last piece, walked backwards,
//      gives its last min(ways, distinct) distinct lines, most recent
//      first; a warp folds its tile of 32 chunks into one list.
//   2. `split_replay_kernel`: a tile's incoming list comes from a walk back
//      over earlier tiles' lists (combine(older, newer) = newer, then
//      older's lines not in it, cut to `ways`; the walk stops at a full
//      list or one that starts at a set's first access), then each chunk's
//      incoming stack from a rescan of the tile.  Each lane then replays
//      one chunk from its stack: way k starts as stack position k, its
//      dirty bit "incoming bit k" until a write or a fill makes it
//      concrete.  Evicting a still-symbolic line writes the word with bit 2
//      clear and records (step, k).  The chunk ends with its transfer: per
//      position of its out-stack (the next chunk's incoming stack), a
//      concrete bit or a pointer to an incoming position; a warp composes
//      its tile's transfers into one.
//   3. `split_resolve_kernel`: a tile's incoming dirty bits come from a
//      walk back over earlier tiles' transfers until none is left
//      symbolic; a rescan of the tile carries them chunk to chunk and sets
//      bit 2 of each deferred word whose incoming bit is 1.
// What bounds it: bytes.  The stream is read twice (a chunk's last piece in
// phase 1, usually only its last few distinct lines; the whole chunk in
// phase 2, staged through shared memory by cp.async as below, a lane per
// chunk) and the words written once, besides scratch of about 100 bytes a
// chunk.  The chain is S steps of the replay (tag compare, least stamp,
// update, about 270 ns a step on an H100 with one warp an SM) plus the
// walks over tiles, which stop at the first full list: a skewed stream is
// no longer one chain.  S is chosen by the wrapper (`split_length` in
// kernel.py) from n, ways, the SM count and the replay kernel's resident
// warps an SM: just enough accesses a chunk that one chunk a lane fills
// every resident warp of the card once, and at least 4 * ways, so that a
// chunk's lists (at most `ways` lines) stay small beside its replay.
// n_sets does not enter: chunks cut across sets.
//
// No-write-allocate: the per-set chain.  A write miss there does not
// touch its set, so which lines are resident depends on whether earlier
// writes hit, and the last `ways` distinct lines are not the state: no cut
// is exact without replaying everything before it.  One thread replays
// each set, one warp (32 sets) per block, so the sets spread over as many
// SMs as possible.  The set's tags (int64), LRU stamps (int32: the step
// index, initial stamps k - ways) and dirty bits (one word) live in
// registers; `ways` is a template parameter for the 8 and 16 ways of the
// default hierarchy, and a 32-wide instance takes any 1..32 ways (its
// unused ways hold stamp INT_MAX and tag -1, so they are never matched and
// never chosen).  A step is branch-free.  Its bound is the longest set's
// access count times the time of one step: a stream skewed onto one set is
// one chain there.
//
// Memory stays off the chain in both: a warp stages its chains' accesses
// in rounds through shared memory.  While it replays round c, the copies
// of round c + 1 are in flight (cp.async, one 8-byte word a lane, each
// chain's words contiguous, so one copy instruction covers a chain's round
// coalesced).  Results leave, chain by chain, as coalesced stores after
// the round.  Read straight from global memory, even several steps ahead,
// a warp's 8-byte loads fall in 32 different lines and a step waits about
// a memory round trip.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;     // one warp per block, one set per lane
constexpr int kChunk = 32;       // accesses per set staged per round
constexpr int kStride = kChunk + 1;   // padded shared row (8-byte words)
constexpr int kMaxWays = 32;     // dirty bits and one-hot ways in one word
constexpr unsigned kFullMask = 0xffffffffu;

// least of the N stamps at s[0..N): a pairwise tree, log2(N) deep
template <int N>
struct Least {
  static __device__ __forceinline__ int of(const int* s) {
    return min(Least<N / 2>::of(s), Least<N - N / 2>::of(s + N / 2));
  }
};
template <>
struct Least<1> {
  static __device__ __forceinline__ int of(const int* s) { return s[0]; }
};

// One access `v` (= line * 2 + is_write) at step j against the set's state.
template <int WAYS>
__device__ __forceinline__ long long replay_step(
    long long v, int j, long long (&tag)[WAYS], int (&stamp)[WAYS],
    unsigned& dirty, bool write_allocate) {
  const long long a = v >> 1;
  const bool w = (v & 1) != 0;
  unsigned match = 0, lru = 0;
  const int least = Least<WAYS>::of(stamp);     // stamps are unique
  long long victim = -1;
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    match |= (tag[k] == a ? 1u : 0u) << k;
    const bool is_lru = stamp[k] == least;
    lru |= (is_lru ? 1u : 0u) << k;
    victim = is_lru ? tag[k] : victim;
  }
  const bool hit = match != 0;
  const bool fill = !hit && (write_allocate || !w);
  const unsigned way = hit ? match : lru;          // one-hot
  const bool way_dirty = (dirty & way) != 0;
  const long long evict = fill ? victim : -1;      // -1: the way was invalid
  const bool evict_dirty = fill && way_dirty && victim >= 0;
  const unsigned touched = (hit || fill) ? way : 0u;
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    const bool sel = (touched >> k) & 1u;
    tag[k] = sel ? a : tag[k];
    stamp[k] = sel ? j : stamp[k];
  }
  dirty = (dirty & ~touched) | ((w || (way_dirty && hit)) ? touched : 0u);
  return ((evict + 1) << 3) | (static_cast<long long>(evict_dirty) << 2) |
         (static_cast<long long>(fill) << 1) | static_cast<long long>(hit);
}

__device__ __forceinline__ void copy_word_async(long long* dst,
                                                const long long* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

template <int WAYS>
__global__ void __launch_bounds__(kThreads)
cache_replay_kernel(const long long* __restrict__ packed,
                    const long long* __restrict__ offsets,
                    const long long* __restrict__ counts,
                    long long* __restrict__ out, int n_sets, int ways,
                    bool write_allocate) {
  __shared__ long long staged[2][kThreads * kStride];
  __shared__ long long results[kThreads * kStride];
  __shared__ long long set_offset[kThreads];
  __shared__ int set_count[kThreads];
  const int lane = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int sets = min(kThreads, n_sets - first);
  const int n = lane < sets ? static_cast<int>(counts[first + lane]) : 0;
  set_offset[lane] = lane < sets ? offsets[first + lane] : 0;
  set_count[lane] = n;      // the wrapper keeps every count below 2^31
  const int rounds =
      static_cast<int>((__reduce_max_sync(kFullMask, static_cast<unsigned>(n))
                        + kChunk - 1) / kChunk);
  __syncwarp();

  // lane l copies access c * kChunk + l of every set of the block
  auto stage = [&](int c) {
    long long* buf = staged[c & 1];
    const int j = c * kChunk + lane;
    for (int s = 0; s < sets; ++s)
      if (j < set_count[s])
        copy_word_async(buf + s * kStride + lane,
                        packed + set_offset[s] + j);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  long long tag[WAYS];
  int stamp[WAYS];
  unsigned dirty = 0;
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    tag[k] = -1;
    stamp[k] = k < ways ? k - ways : INT_MAX;
  }
  if (rounds > 0) stage(0);
  for (int c = 0; c < rounds; ++c) {
    if (c + 1 < rounds) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();
    const long long* in = staged[c & 1] + lane * kStride;
    long long* res = results + lane * kStride;
    const int steps = min(kChunk, n - c * kChunk);
#pragma unroll 2
    for (int u = 0; u < steps; ++u)
      res[u] = replay_step<WAYS>(in[u], c * kChunk + u, tag, stamp, dirty,
                                 write_allocate);
    __syncwarp();
    const int j = c * kChunk + lane;
    for (int s = 0; s < sets; ++s)
      if (j < set_count[s])
        out[set_offset[s] + j] = results[s * kStride + lane];
    __syncwarp();           // staged[c & 1] and results are reused next
  }
}

template <int WAYS>
cudaError_t launch(const void* packed, const void* offsets,
                   const void* counts, void* out, int n_sets, int ways,
                   bool write_allocate, cudaStream_t stream) {
  const int blocks = (n_sets + kThreads - 1) / kThreads;
  cache_replay_kernel<WAYS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const long long*>(packed),
      static_cast<const long long*>(offsets),
      static_cast<const long long*>(counts), static_cast<long long*>(out),
      n_sets, ways, write_allocate);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The split replay (write-allocate).

namespace {

constexpr int kTile = 32;          // chunks a tile: one warp, one chunk a lane
constexpr int kRound = 16;         // accesses a chunk staged per round
constexpr int kRoundStride = kRound + 1;   // padded shared row (8-byte words)
constexpr int kConst = 0x40;       // transfer code: concrete bit in bit 0;
                                   // codes below 32 point at a position
constexpr int kHead = 1 << 8;      // meta: the chunk starts a set
constexpr int kComplete = 1 << 9;  // meta: the list starts at a set start
constexpr int kLenMask = 0xff;

struct Scratch {
  long long* summary;        // [chunks * ways] last piece's distinct lines
  long long* tile_list;      // [tiles * ways] a tile's folded list
  int* meta;                 // [chunks] len | kHead | kComplete
  int* tile_meta;            // [tiles] len | kComplete
  unsigned* deferred;        // [chunks] incoming positions evicted symbolic
  int* defer_step;           // [chunks * ways] the step of each of them
  unsigned char* xfer;       // [chunks * 32] transfer codes
  unsigned char* tile_xfer;  // [tiles * 32] a tile's composed transfer
};

inline long long align8(long long b) {
  return (b + 7) & ~7LL;
}

// Carves one byte buffer into the scratch arrays (8-byte aligned parts);
// returns the bytes they take.
inline long long carve(unsigned char* base,
                                           long long chunks, long long tiles,
                                           int ways, Scratch* s) {
  long long at = 0;
  auto take = [&](long long bytes) {
    unsigned char* p = base ? base + at : nullptr;
    at += align8(bytes);
    return p;
  };
  unsigned char* summary = take(chunks * ways * 8);
  unsigned char* tile_list = take(tiles * ways * 8);
  unsigned char* meta = take(chunks * 4);
  unsigned char* tile_meta = take(tiles * 4);
  unsigned char* deferred = take(chunks * 4);
  unsigned char* defer_step = take(chunks * ways * 4);
  unsigned char* xfer = take(chunks * kTile);
  unsigned char* tile_xfer = take(tiles * kTile);
  if (s) {
    s->summary = reinterpret_cast<long long*>(summary);
    s->tile_list = reinterpret_cast<long long*>(tile_list);
    s->meta = reinterpret_cast<int*>(meta);
    s->tile_meta = reinterpret_cast<int*>(tile_meta);
    s->deferred = reinterpret_cast<unsigned*>(deferred);
    s->defer_step = reinterpret_cast<int*>(defer_step);
    s->xfer = xfer;
    s->tile_xfer = tile_xfer;
  }
  return at;
}

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ long long set_of(long long v, int n_sets) {
  return static_cast<long long>(static_cast<unsigned long long>(v >> 1) %
                                static_cast<unsigned long long>(n_sets));
}

// combine(older, newer) of two lists held a position a lane (lengths lo,
// ln; uniform): newer's lines, then older's lines not among them, cut to
// `ways`.  `slot` is the warp's 32 words of shared memory.
__device__ long long combine_lists(long long older, int lo, long long newer,
                                   int ln, int ways, int& len,
                                   long long* slot) {
  const int lane = threadIdx.x & 31;
  if (ln >= ways || lo == 0) {
    len = ln;
    return newer;
  }
  bool dup = false;
  for (int k = 0; k < ln; ++k)
    dup |= __shfl_sync(kFullMask, newer, k) == older;
  const bool keep = lane < lo && !dup;
  const unsigned kept = __ballot_sync(kFullMask, keep);
  const int dest = ln + __popc(kept & ((1u << lane) - 1u));
  if (lane < ln) slot[lane] = newer;
  if (keep && dest < ways) slot[dest] = older;
  __syncwarp();
  len = min(ways, ln + __popc(kept));
  const long long r = lane < len ? slot[lane] : -1;
  __syncwarp();                    // slot is reused by the next call
  return r;
}

// A transfer (or a dirty bit) held a position a lane, then `t` after it:
// position i takes t's concrete bit or, for a pointer, f at that position.
__device__ __forceinline__ int then(int f, int t) {
  const int lane = threadIdx.x & 31;
  const int g = __shfl_sync(kFullMask, f, (t & kConst) ? lane : t);
  return (t & kConst) ? t : g;
}

// Phase 1: each lane the summary of one chunk, then the tile's folded list.
template <int WAYS>
__global__ void __launch_bounds__(kTile)
split_summary_kernel(const long long* __restrict__ packed,
                     const long long* __restrict__ offsets, long long n,
                     int n_sets, int ways, int S, long long chunks,
                     Scratch sc) {
  __shared__ long long rows[kTile * WAYS];
  __shared__ int row_meta[kTile];
  __shared__ long long slot[32];
  const int lane = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long g = base + lane;
  const int here = static_cast<int>(lmin(kTile, chunks - base));
  long long list[WAYS];
#pragma unroll
  for (int k = 0; k < WAYS; ++k) list[k] = -1;
  int len = 0, meta = 0;
  if (g < chunks) {
    const long long start = g * S;
    const long long end = min(n, start + S);
    const bool head = offsets[set_of(packed[start], n_sets)] == start;
    const long long piece =
        max(start, offsets[set_of(packed[end - 1], n_sets)]);
    // walk the last piece backwards, four loads in flight
    for (long long i = end - 1; i >= piece && len < ways; i -= 4) {
      long long v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = i - u >= piece ? packed[i - u] : -2;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long a = v[u] >> 1;
        bool seen = v[u] < 0 || len >= ways;
#pragma unroll
        for (int k = 0; k < WAYS; ++k) seen |= list[k] == a;
        if (!seen) {
#pragma unroll
          for (int k = 0; k < WAYS; ++k) list[k] = k == len ? a : list[k];
          ++len;
        }
      }
    }
    meta = len | (head ? kHead : 0) | (head || piece > start ? kComplete : 0);
#pragma unroll
    for (int k = 0; k < WAYS; ++k)
      if (k < ways) sc.summary[g * ways + k] = list[k];
    sc.meta[g] = meta;
  }
#pragma unroll
  for (int k = 0; k < WAYS; ++k) rows[lane * WAYS + k] = list[k];
  row_meta[lane] = meta;
  __syncwarp();
  long long cur = -1;
  int cur_len = 0, complete = 0;
  for (int r = 0; r < here; ++r) {
    const int m = row_meta[r];
    const long long e = lane < ways ? rows[r * WAYS + lane] : -1;
    if (m & kComplete) {
      cur = e;
      cur_len = m & kLenMask;
    } else {
      cur = combine_lists(cur, cur_len, e, m & kLenMask, ways, cur_len,
                          slot);
    }
    complete |= m & kComplete;
  }
  if (lane < ways) sc.tile_list[blockIdx.x * static_cast<long long>(ways) +
                                lane] = cur;
  if (lane == 0) sc.tile_meta[blockIdx.x] = cur_len | complete;
}

// One access `v` at step j of a chunk, under write-allocate, with the
// state's dirty bits either concrete (`dirty`) or symbolic (`sym`: way k
// still carries incoming position k's bit).
template <int WAYS>
__device__ __forceinline__ long long split_step(
    long long v, int j, long long (&tag)[WAYS], int (&stamp)[WAYS],
    unsigned& dirty, unsigned& sym, unsigned& deferred, int* defer_step) {
  const long long a = v >> 1;
  const bool w = (v & 1) != 0;
  unsigned match = 0, lru = 0;
  const int least = Least<WAYS>::of(stamp);     // stamps are unique
  long long victim = -1;
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    match |= (tag[k] == a ? 1u : 0u) << k;
    const bool is_lru = stamp[k] == least;
    lru |= (is_lru ? 1u : 0u) << k;
    victim = is_lru ? tag[k] : victim;
  }
  const bool hit = match != 0;
  const unsigned way = hit ? match : lru;          // one-hot
  const bool way_dirty = (dirty & way) != 0;
  const bool way_sym = (sym & way) != 0;
  const bool evicts = !hit && victim >= 0;
  const long long evict = hit ? -1 : victim;       // -1: the way was invalid
  if (evicts && way_sym) {                         // its bit is not known yet
    deferred |= way;
    defer_step[__ffs(way) - 1] = j;
  }
  const bool evict_dirty = evicts && !way_sym && way_dirty;
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    const bool sel = (way >> k) & 1u;
    tag[k] = sel ? a : tag[k];
    stamp[k] = sel ? j : stamp[k];
  }
  dirty = (dirty & ~way) | ((w || (way_dirty && hit)) ? way : 0u);
  sym &= (hit && !w) ? ~0u : ~way;                 // a read hit keeps it
  return ((evict + 1) << 3) | (static_cast<long long>(evict_dirty) << 2) |
         (static_cast<long long>(!hit) << 1) | static_cast<long long>(hit);
}

// An empty state for `ways` of a WAYS-wide instance, or way k holding
// incoming stack position k < m: valid stamps -1 - k (position 0 most
// recent), invalid ones below every valid one, unused ones never chosen.
template <int WAYS>
__device__ __forceinline__ void split_init(long long (&tag)[WAYS],
                                           int (&stamp)[WAYS],
                                           const long long* stack, int m,
                                           int ways) {
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    tag[k] = k < m ? stack[k] : -1;
    stamp[k] = k < m ? -1 - k : (k < ways ? k - 2 * ways - 1 : INT_MAX);
  }
}

// Phase 2: incoming stacks, then one chunk a lane replayed from its stack;
// each chunk's transfer and deferred evictions, the tile's transfer.
template <int WAYS>
__global__ void __launch_bounds__(kTile)
split_replay_kernel(const long long* __restrict__ packed,
                    const long long* __restrict__ offsets,
                    const long long* __restrict__ counts,
                    long long* __restrict__ out, long long n, int n_sets,
                    int ways, int S, long long chunks, Scratch sc) {
  __shared__ long long staged[2][kTile * kRoundStride];
  __shared__ long long stack[kTile * WAYS];
  __shared__ int stack_len[kTile];
  __shared__ int row_meta[kTile];
  __shared__ unsigned char codes[kTile * kTile];
  __shared__ long long chunk_start[kTile];
  __shared__ int chunk_count[kTile];
  __shared__ long long slot[32];
  const int lane = threadIdx.x;
  const int tile = blockIdx.x;
  const long long base = static_cast<long long>(tile) * kTile;
  const int here = static_cast<int>(lmin(kTile, chunks - base));
  const long long g = base + lane;

  // the tile's incoming list: a walk back over the earlier tiles' lists
  long long cur = -1;
  int cur_len = 0;
  for (int t = tile - 1; t >= 0; --t) {
    const int m = sc.tile_meta[t];
    const long long e =
        lane < ways ? sc.tile_list[t * static_cast<long long>(ways) + lane]
                    : -1;
    cur = combine_lists(e, m & kLenMask, cur, cur_len, ways, cur_len, slot);
    if ((m & kComplete) || cur_len >= ways) break;
  }
  // each chunk's incoming stack: a rescan of the tile's summaries
  long long* rows = &staged[0][0];   // free until the replay stages
  for (int i = lane; i < here * ways; i += kTile)
    rows[i] = sc.summary[base * ways + i];
  row_meta[lane] = g < chunks ? sc.meta[g] : 0;
  stack_len[lane] = 0;
  __syncwarp();
  for (int r = 0; r < here; ++r) {
    const int m = row_meta[r];
    if (!(m & kHead)) {
      if (lane < ways) stack[r * WAYS + lane] = cur;
      if (lane == 0) stack_len[r] = cur_len;
    }
    const long long e = lane < ways ? rows[r * ways + lane] : -1;
    if (m & kComplete) {
      cur = e;
      cur_len = m & kLenMask;
    } else {
      cur = combine_lists(cur, cur_len, e, m & kLenMask, ways, cur_len,
                          slot);
    }
  }
  const long long start = g * S;
  const int count =
      g < chunks ? static_cast<int>(lmin(S, n - start)) : 0;
  chunk_start[lane] = start;
  chunk_count[lane] = count;
  __syncwarp();

  long long tag[WAYS];
  int stamp[WAYS];
  const int m0 = stack_len[lane];
  split_init<WAYS>(tag, stamp, stack + lane * WAYS, m0, ways);
  unsigned dirty = 0, deferred = 0;
  unsigned sym = m0 >= 32 ? ~0u : (1u << m0) - 1u;
  int* defer_step = sc.defer_step + g * ways;
  // the local step at which the next set starts inside the chunk
  int next_set = count;
  if (count > 0) {
    const long long s0 = set_of(packed[start], n_sets);
    next_set = static_cast<int>(
        lmin(count, offsets[s0] + counts[s0] - start));
  }
  const int rounds = (S + kRound - 1) / kRound;
  const int half = lane >> 4, col = lane & (kRound - 1);

  // lanes 0-15 copy word c * kRound + col of the even chunks, 16-31 of the
  // odd ones: each copy instruction covers two chunks' rounds coalesced
  auto stage = [&](int c) {
    long long* buf = staged[c & 1];
    const int j = c * kRound + col;
    for (int s = half; s < here; s += 2)
      if (j < chunk_count[s])
        copy_word_async(buf + s * kRoundStride + col,
                        packed + chunk_start[s] + j);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  __syncwarp();                      // rows (staged) are no longer read
  if (rounds > 0) stage(0);
  for (int c = 0; c < rounds; ++c) {
    if (c + 1 < rounds) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();
    long long* io = staged[c & 1] + lane * kRoundStride;
    const int steps = min(kRound, count - c * kRound);
    for (int u = 0; u < steps; ++u) {
      const int j = c * kRound + u;
      const long long v = io[u];
      if (j == next_set) {           // a set starts inside the chunk
        split_init<WAYS>(tag, stamp, stack + lane * WAYS, 0, ways);
        dirty = sym = 0;
        next_set = static_cast<int>(lmin(
            count, j + counts[set_of(v, n_sets)]));
      }
      io[u] = split_step<WAYS>(v, j, tag, stamp, dirty, sym, deferred,
                               defer_step);
    }
    __syncwarp();
    const int j = c * kRound + col;
    for (int s = half; s < here; s += 2)
      if (j < chunk_count[s])
        out[chunk_start[s] + j] = staged[c & 1][s * kRoundStride + col];
    __syncwarp();                    // staged[c & 1] is reused next
  }

  // the chunk's transfer: its out-stack (valid ways by stamp, most recent
  // first), each position a concrete bit or an incoming position
  unsigned char* row = codes + lane * kTile;
  for (int i = 0; i < kTile; ++i) row[i] = kConst;
#pragma unroll
  for (int k = 0; k < WAYS; ++k) {
    if (tag[k] < 0) continue;
    int rank = 0;
#pragma unroll
    for (int q = 0; q < WAYS; ++q)
      rank += (tag[q] >= 0 && stamp[q] > stamp[k]) ? 1 : 0;
    row[rank] = static_cast<unsigned char>(
        (sym >> k) & 1u ? k : kConst | ((dirty >> k) & 1u));
  }
  if (g < chunks) sc.deferred[g] = deferred;
  __syncwarp();
  for (int r = 0; r < here; ++r)
    sc.xfer[(base + r) * kTile + lane] = codes[r * kTile + lane];
  // the tile's transfer: its chunks' transfers composed in order
  int f = codes[lane];
  for (int r = 1; r < here; ++r) f = then(f, codes[r * kTile + lane]);
  sc.tile_xfer[static_cast<long long>(tile) * kTile + lane] =
      static_cast<unsigned char>(f);
}

// Phase 3: each chunk's incoming dirty bits, and bit 2 of its deferred
// evictions whose bit is 1.
__global__ void __launch_bounds__(kTile)
split_resolve_kernel(long long* __restrict__ out, int ways, int S,
                     long long chunks, Scratch sc) {
  __shared__ unsigned char codes[kTile * kTile];
  __shared__ unsigned deferred[kTile];
  const int lane = threadIdx.x;
  const int tile = blockIdx.x;
  const long long base = static_cast<long long>(tile) * kTile;
  const int here = static_cast<int>(lmin(kTile, chunks - base));
  // the tile's incoming bits: earlier tiles' transfers composed backwards
  // until no position is left symbolic (the first chunk of the stream
  // starts a set, so the walk ends by tile 0)
  int f = kConst;
  for (int t = tile - 1; t >= 0; --t) {
    const int e = sc.tile_xfer[static_cast<long long>(t) * kTile + lane];
    f = t == tile - 1 ? e : then(e, f);
    if (!__any_sync(kFullMask, !(f & kConst))) break;
  }
  if (!(f & kConst)) f = kConst;     // not reached: see above
  for (int r = 0; r < here; ++r)
    codes[r * kTile + lane] = sc.xfer[(base + r) * kTile + lane];
  deferred[lane] = base + lane < chunks ? sc.deferred[base + lane] : 0u;
  __syncwarp();
  for (int r = 0; r < here; ++r) {
    if ((deferred[r] >> lane) & 1u && (f & 1)) {
      const long long g = base + r;
      out[g * S + sc.defer_step[g * ways + lane]] |= 4;
    }
    f = then(f, codes[r * kTile + lane]);
  }
}

template <int WAYS>
cudaError_t launch_split(const long long* packed, const long long* offsets,
                         const long long* counts, long long* out,
                         unsigned char* scratch, long long n, int n_sets,
                         int ways, int S, cudaStream_t stream) {
  const long long chunks = (n + S - 1) / S;
  const long long tiles = (chunks + kTile - 1) / kTile;
  Scratch sc;
  carve(scratch, chunks, tiles, ways, &sc);
  const dim3 grid(static_cast<unsigned>(tiles));
  split_summary_kernel<WAYS><<<grid, kTile, 0, stream>>>(
      packed, offsets, n, n_sets, ways, S, chunks, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_replay_kernel<WAYS><<<grid, kTile, 0, stream>>>(
      packed, offsets, counts, out, n, n_sets, ways, S, chunks, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_resolve_kernel<<<grid, kTile, 0, stream>>>(out, ways, S, chunks, sc);
  return cudaGetLastError();
}

}  // namespace

// The widest `ways` a launch takes.
extern "C" int cache_replay_max_ways() { return kMaxWays; }

// Replays every set of one level on `stream`; returns a CUDA error code (0
// when the launch was accepted).  packed, out: [n] int64 in the set-sorted
// layout; offsets, counts: [n_sets] int64.
extern "C" int cache_replay_launch(const void* packed, const void* offsets,
                                   const void* counts, void* out, int n_sets,
                                   int ways, int write_allocate,
                                   void* stream) {
  if (n_sets <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wa = write_allocate != 0;
  cudaError_t err;
  switch (ways) {
    case 8:
      err = launch<8>(packed, offsets, counts, out, n_sets, ways, wa, st);
      break;
    case 16:
      err = launch<16>(packed, offsets, counts, out, n_sets, ways, wa, st);
      break;
    default:
      if (ways < 1 || ways > kMaxWays)
        return static_cast<int>(cudaErrorInvalidValue);
      err = launch<kMaxWays>(packed, offsets, counts, out, n_sets, ways, wa,
                             st);
  }
  return static_cast<int>(err);
}

// Bytes of scratch the split replay of n accesses in chunks of S needs.
extern "C" long long cache_replay_split_scratch_bytes(long long n, int ways,
                                                      int S) {
  const long long chunks = (n + S - 1) / S;
  return carve(nullptr, chunks, (chunks + kTile - 1) / kTile, ways, nullptr);
}

// Warps of the split replay kernel that one SM of the current device holds
// at once for `ways` (one warp a block), or minus a CUDA error code.
extern "C" int cache_replay_split_resident_warps(int ways) {
  int blocks = 0;
  cudaError_t err;
  switch (ways) {
    case 8:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, split_replay_kernel<8>, kTile, 0);
      break;
    case 16:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, split_replay_kernel<16>, kTile, 0);
      break;
    default:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, split_replay_kernel<kMaxWays>, kTile, 0);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The split replay of one level under write-allocate on `stream`, in
// chunks of S accesses (three launches); returns a CUDA error code (0 when
// every launch was accepted).  packed, out: [n] int64 in the set-sorted
// layout; offsets, counts: [n_sets] int64; scratch:
// cache_replay_split_scratch_bytes(n, ways, S) bytes, 8-byte aligned.
extern "C" int cache_replay_split_launch(const void* packed,
                                         const void* offsets,
                                         const void* counts, void* out,
                                         void* scratch, long long n,
                                         int n_sets, int ways, int S,
                                         void* stream) {
  if (n <= 0) return 0;
  if (ways < 1 || ways > kMaxWays || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const long long*>(packed);
  auto o = static_cast<const long long*>(offsets);
  auto c = static_cast<const long long*>(counts);
  auto r = static_cast<long long*>(out);
  auto s = static_cast<unsigned char*>(scratch);
  cudaError_t err;
  switch (ways) {
    case 8:
      err = launch_split<8>(p, o, c, r, s, n, n_sets, ways, S, st);
      break;
    case 16:
      err = launch_split<16>(p, o, c, r, s, n, n_sets, ways, S, st);
      break;
    default:
      err = launch_split<kMaxWays>(p, o, c, r, s, n, n_sets, ways, S, st);
  }
  return static_cast<int>(err);
}
