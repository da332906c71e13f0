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
// and no fallback for a skewed stream: a stream that lands in one set is one
// long chain.  The output is written in the same sorted layout.
//
// What bounds it on an H100: on paper, bytes (8 B read and 8 B written per
// access; about 0.028 ms for the 5.9 M accesses of the full-depth TinyLlama
// L1 stream).  In fact the dependent chain: a set's accesses are a
// recurrence, so the time is the longest set's access count times the time
// of one step (tag compare, victim, state update).  With 128 L1 sets there
// are only 128 chains (47,193 steps for the longest at that shape), far too
// few threads to hide that time.
//
// Design: one thread per set, one warp (32 sets) per block, so the sets
// spread over as many SMs as possible.  The set's tags (int64), LRU stamps
// (int32: the step index, initial stamps k - ways) and dirty bits (one
// word) live in registers; `ways` is a template parameter for the 8 and 16
// ways of the default hierarchy, and a 32-wide instance takes any 1..32
// ways (its unused ways hold stamp INT_MAX and tag -1, so they are never
// matched and never chosen).  A step is branch-free.
//
// Memory stays off the chain: the warp stages its sets' accesses in rounds
// of kChunk per set through shared memory.  While it replays round c, the
// copies of round c + 1 are in flight (cp.async, one 8-byte word a lane,
// each set's kChunk words contiguous, so one copy instruction covers one
// set's round coalesced).  Results go to shared memory and leave, set by
// set, as coalesced stores after the round.  Read straight from global
// memory, even several steps ahead, a warp's 8-byte loads fall in 32
// different lines and a step waits about a memory round trip.

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
