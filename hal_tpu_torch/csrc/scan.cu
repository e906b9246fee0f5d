// cumsum_i32 / cummax_i32: inclusive int32 prefix sum and running max of a
// 1-D array, one templated single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016).
//
// Replaces the Pallas blocked scans of hal_tpu/ops/pallas_kernels.py:166-208
// (_make_scan over _scan_kernel: _cumsum_i32_p :186 behind cumsum_i32, and
// _cummax_i32_p :185 behind cummax_i32), which the segment mapper runs in
// every expansion (segmap_jax._expand_owner): cumsum over the per-fragment
// piece counts, cummax over the scatter-max owner marks (length = the
// level's capacity, 1,310,720 slots at bench scale).
//
// Why the TPU design does not carry over: the TPU walks its grid in order on
// one core and carries the running value from block to block in one SMEM
// word (pallas_kernels.py:125-143).  Hopper's blocks run in parallel on 132
// SMs in no fixed order, so no carry can pass from block to block by
// program order.  Here each block instead publishes its tile's value in a
// status word in device memory and reads its predecessors' words.
//
// What bounds it on an H100: one read and one write of every element (8 B
// per element against the 3.35 TB/s HBM rate), plus latency that does not
// shrink with n: the launch, the tile-index atomic, and the look-back of the
// tiles that start together, which walks back 32 tiles per L2 round trip
// until it meets a published prefix.  At the mapper's 1,310,720 elements
// (80 tiles) the latency dominates; large tiles keep the tile count low.
//
// Design, one launch per call:
//   1. Dynamic tile order.  A block takes its tile index from an atomicAdd on
//      a 64-bit counter (word 0 of the status buffer), minus tile_base, the
//      number of tiles that earlier calls on this status buffer consumed.  The
//      buffer belongs to one stream, whose calls run in order, so the counter
//      equals tile_base when a call starts and is never reset.  A tile's
//      predecessors took their indices earlier and are therefore already
//      running, so the look-back below cannot wait on a block that has not
//      been scheduled, however the blocks are placed on the SMs.
//   2. A tile is kThreads x kItems consecutive elements; each warp owns
//      32 x kItems of them as chunks of 128, and lane l holds elements
//      4l..4l+3 of every chunk, so each access of the warp is one coalesced
//      512-byte run: 16-byte vector loads and stores when the tile is full
//      and both pointers are 16-byte aligned, scalar ones otherwise.  A
//      ragged tail is filled with the operator's identity in registers only.
//      Each chunk is scanned in the lane (4 items) and across the warp by
//      shuffles, with a running carry from chunk to chunk; the 8 warp totals
//      are scanned by warp 0.
//   3. Per-tile status, one 64-bit word written by one store, so flag and
//      value cannot tear: bits 63..34 the call's epoch, bits 33..32 the flag
//      (1 = tile aggregate, 2 = inclusive prefix), bits 31..0 the value as
//      uint32 (zero-extended, so a negative value never reaches the flag or
//      epoch bits).  Written with st.release.gpu, read with ld.acquire.gpu.
//      A word of another epoch reads as "not published"; the host hands every
//      call a new epoch, so the status array is never cleared between calls.
//   4. Warp-wide look-back: lane k of warp 0 reads tile - 1 - k; the warp
//      waits until every word in its window is published, a ballot finds the
//      nearest inclusive prefix, and the lanes up to it combine their values
//      (sums in uint32, so they wrap).  With no prefix in the window, the
//      window's 32 aggregates are combined and the window slides back.  One
//      word per lane: an acquire load holds back the loads after it, so more
//      words per lane cost a round trip each (measured slower, PERF.md).
//   5. Each element is written once: out = prefix of the tiles before, of the
//      warps, chunks and lanes before, and the lane's own running value.
// out may alias x: a block holds all its inputs in registers before it writes
// any output, and reads no other tile's elements, only status words.
// The running max uses the true identity INT32_MIN, so the result equals
// torch.cummax for every input (the TPU kernel's identity was -(2^31)+1;
// the mapper's marks are >= 0, so the two agree there).  Sums wrap modulo
// 2^32 like the TPU's.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// elements per thread: 64 was fastest of 8, 16, 32 and 64 at the mapper's
// 1,310,720 and at 2^24 (PERF.md); fewer tiles, fewer look-back steps
constexpr int kItems = 64;
constexpr int kTile = kThreads * kItems;
constexpr int kChunks = kItems / 4;  // 128-element chunks per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagAggregate = 1ull;
constexpr unsigned long long kFlagPrefix = 2ull;
constexpr unsigned kMaxPolls = 1u << 24;

struct SumOp {
  __device__ static int32_t identity() { return 0; }
  __device__ static int32_t apply(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);  // wraps, no signed overflow
  }
};

struct MaxOp {
  __device__ static int32_t identity() { return INT_MIN; }
  __device__ static int32_t apply(int32_t a, int32_t b) { return a > b ? a : b; }
};

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned long long flag,
                                                   int32_t value) {
  return ((unsigned long long)epoch << 34) | (flag << 32) |
         (unsigned long long)(uint32_t)value;
}

template <class Op>
__device__ __forceinline__ int32_t warp_reduce(int32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = Op::apply(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Exclusive prefix of tile t (t >= 1) from its predecessors' status words,
// run by all 32 lanes of one warp; every lane returns the same value.
template <class Op>
__device__ int32_t look_back(const unsigned long long* status, long long t,
                             unsigned epoch) {
  const int lane = threadIdx.x & 31;
  int32_t excl = Op::identity();
  for (long long top = t - 1;; top -= 32) {
    const long long j = top - lane;
    unsigned long long w = 0;
    bool ready;
    unsigned polls = 0;
    do {  // spin until every predecessor in the window has published
      if (j >= 0) {
        w = load_acquire(status + j);
        ready = (unsigned)(w >> 34) == epoch;
      } else {
        ready = true;  // before tile 0: never reached past tile 0's prefix
      }
      // predecessors are running and publish without waiting, so a wait
      // this long means a corrupt state: fault instead of hanging the card
      if (++polls == kMaxPolls) __trap();
    } while (!__all_sync(kFull, ready));
    const bool prefix = j >= 0 && ((w >> 32) & 3ull) == kFlagPrefix;
    const unsigned prefixes = __ballot_sync(kFull, prefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    const int32_t mine =
        (lane <= stop && j >= 0) ? (int32_t)(uint32_t)w : Op::identity();
    excl = Op::apply(excl, warp_reduce<Op>(mine));
    if (prefixes) return excl;
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int32_t* in, int32_t* out, long long n,
            unsigned long long* state, unsigned long long tile_base,
            unsigned epoch) {
  __shared__ long long s_tile;
  __shared__ int32_t s_warp[kWarps];  // exclusive prefix of each warp
  __shared__ int32_t s_excl;          // exclusive prefix of the tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  unsigned long long* status = state + 1;

  if (tid == 0) s_tile = (long long)(atomicAdd(state, 1ull) - tile_base);
  __syncthreads();
  const long long t = s_tile;
  if (t < 0 || t * kTile >= n) return;  // only on a corrupt counter
  // warp wid owns 32 * kItems consecutive elements; in chunk c, lane l holds
  // the 4 elements at seg + 128 c + 4 l (one coalesced 16-byte access)
  const long long seg = t * kTile + (long long)wid * 32 * kItems + 4 * lane;

  int32_t v[kItems];
  const bool vec = t * kTile + kTile <= n &&
                   ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int4 q = *reinterpret_cast<const int4*>(in + seg + 128 * c);
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long g = seg + 128 * c + q;
        v[4 * c + q] = g < n ? in[g] : Op::identity();
      }
  }

  // scan each chunk across the warp, carrying the running total from chunk
  // to chunk: the 4 items in the lane, then the lane totals by shuffles
  int32_t carry = Op::identity();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int q = 1; q < 4; ++q) v[4 * c + q] = Op::apply(v[4 * c + q - 1], v[4 * c + q]);
    int32_t x = v[4 * c + 3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = Op::apply(x, y);
    }
    int32_t x_excl = __shfl_up_sync(kFull, x, 1);
    const int32_t pre = lane == 0 ? carry : Op::apply(carry, x_excl);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[4 * c + q] = Op::apply(pre, v[4 * c + q]);
    carry = Op::apply(carry, __shfl_sync(kFull, x, 31));
  }
  if (lane == 0) s_warp[wid] = carry;
  __syncthreads();

  if (wid == 0) {
    int32_t w = lane < kWarps ? s_warp[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = Op::apply(w, y);
    }
    const int32_t aggregate = __shfl_sync(kFull, w, kWarps - 1);
    const int32_t w_excl = __shfl_up_sync(kFull, w, 1);
    if (lane < kWarps) s_warp[lane] = lane == 0 ? Op::identity() : w_excl;
    int32_t excl = Op::identity();
    if (t == 0) {
      if (lane == 0) store_release(status, pack(epoch, kFlagPrefix, aggregate));
    } else {
      if (lane == 0)
        store_release(status + t, pack(epoch, kFlagAggregate, aggregate));
      excl = look_back<Op>(status, t, epoch);
      if (lane == 0)
        store_release(status + t,
                      pack(epoch, kFlagPrefix, Op::apply(excl, aggregate)));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();

  const int32_t pre = Op::apply(s_excl, s_warp[wid]);
#pragma unroll
  for (int k = 0; k < kItems; ++k) v[k] = Op::apply(pre, v[k]);
  if (vec) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      *reinterpret_cast<int4*>(out + seg + 128 * c) =
          make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long g = seg + 128 * c + q;
        if (g < n) out[g] = v[4 * c + q];
      }
  }
}

template <class Op>
int scan(const void* x, void* out, long long n, void* state,
         unsigned long long tile_base, unsigned epoch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (epoch == 0 || epoch >= (1u << 30)) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  scan_kernel<Op><<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, (unsigned long long*)state,
      tile_base, epoch);
  return (int)cudaGetLastError();
}

}  // namespace

// Elements per tile (one block).  Host function, no device work.
extern "C" long long hal_scan_tile() { return kTile; }

// x, out: n int32 on the device (out may alias x).  state: 64-bit words,
// zeroed when first allocated and owned by `stream`: word 0 the tile counter,
// then one status word per tile, at least ceil(n / hal_scan_tile()).
// tile_base: tiles that earlier calls with this state consumed; epoch: in
// [1, 2^30), different from the epoch of every earlier call since the state
// was last zeroed.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int hal_cumsum_i32(const void* x, void* out, long long n,
                              void* state, unsigned long long tile_base,
                              unsigned epoch, void* stream) {
  return scan<SumOp>(x, out, n, state, tile_base, epoch, stream);
}

extern "C" int hal_cummax_i32(const void* x, void* out, long long n,
                              void* state, unsigned long long tile_base,
                              unsigned epoch, void* stream) {
  return scan<MaxOp>(x, out, n, state, tile_base, epoch, stream);
}
