// searchsorted_right: out[i] = #{j : grid[j] <= key(q[i])} for a sorted int32
// grid, i.e. searchsorted(grid, key(q), side='right').  key is the identity
// for int32 queries; for int64 queries of a uint32-range level it clamps to
// [0, 2^32 - 1] and subtracts 2^31 (the order-preserving bias under which the
// level stores its grid as int32), and the result is written as int64.
//
// Replaces the Pallas compare-count kernel of hal_tpu/ops/pallas_kernels.py
// (_kernel / _searchsorted_right_p / searchsorted_right), which the segment
// mapper calls twice per tree level (segmap_jax._split_hop).  On the TPU it
// compares every query with every grid entry held in VMEM, so its work is
// O(n * q) and its grid must fit VMEM: that is why segmap_jax stops using it
// past 65,536 entries (_PALLAS_GRID_LIMIT) and pages larger grids.  Neither
// limit holds here.  The port takes this kernel up to 64 * kTreeCap entries
// (2,097,088), which covers the bench-scale levels (~1.2M segments).
//
// What bounds it on an H100: the queries and results cross HBM once (8 bytes
// a query for int32, 16 for int64); that is the bound PERF.md states.  The
// grid (at most 8 MB) stays in the 50 MB L2, so what each query costs beyond
// its bytes is L2 sectors, read by loads that no two lanes share (one L1
// wavefront per lane), and the dependent steps of its search.  A plain
// binary search (this kernel's first version) shares only the top ~10
// probes between queries; its last probes land on distinct 32-byte sectors
// that L1 cannot hold, ~4-5 L2 sectors and ~17 dependent loads per query.
//
// Design: an implicit B-tree whose nodes are 32-byte sectors.
//   fences8[k]  = grid[8k]   one entry per sector of the grid,
//   fences64[k] = grid[64k]  one entry per sector of fences8.
// The top of the tree is fences8 when it has at most kTreeCap entries (grids
// up to 262,136), else fences64.  The caller builds it once per grid
// (segmap_torch caches it on each Level) as a perfect binary search tree in
// breadth-first (Eytzinger) order, padded with INT32_MAX to 2^h - 1 keys:
// tree[1] is the root, the children of tree[k] are tree[2k] and tree[2k+1].
// Each block stages the tree in shared memory with one bulk asynchronous
// copy (cp.async.bulk, completion on an mbarrier).  Blocks are persistent
// (as many as fit on the SMs), so each stages the tree once and then walks
// its queries.  Per query: h steps k = 2k + (tree[k] <= v), after which
// k - 2^h counts the keys <= v; with fences64 on top, one sector of fences8
// from L2; then exactly one sector of the grid (two 16-byte loads), counted
// in registers.  That is 1 or 2 L2 sectors per query.
//
// Why breadth-first: step t of the descent reads tree[2^t .. 2^(t+1)), so the
// first five steps of a warp's 32 queries fall in distinct banks or
// broadcast, and later ones on random banks.  A sorted table probed by
// binary search puts every probe of a middle step on one bank (the probes
// are multiples of a power of two apart): up to 32-way conflicts, which
// made a sorted-table version of this kernel hardly faster than the plain
// binary search.
//
// One query per thread, so that adjacent threads read adjacent queries and
// write adjacent results; a block walks its queries with a grid stride.
// Measured on one H100 (bench_searchsorted.py, PERF.md): four
// queries per thread left the last pass of the persistent loop part empty
// and was slower at every timed shape.  Calls with fewer queries than the
// SMs' threads take smaller blocks, so that every SM gets some.
//
// Edges: sectors are grid-relative, so the grid and fences8 must be 16-byte
// aligned (the wrapper copies a misaligned grid view first); a partial last
// sector is read element by element, never past n.  The INT32_MAX padding
// of the tree counts only for a key equal to INT32_MAX, and the count is
// clamped to the real keys.
//
// The TPU kernel counts a grid padded with INT32_MAX to a multiple of 2048;
// the two agree on every key below INT32_MAX.  A key equal to INT32_MAX would
// also count the TPU kernel's padding; the mapper never asks one, since
// coordinates stay below 2^31 - 2 (int32 path) or 2^32 - 2 before the 2^31
// bias (uint32-range path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;    // the largest block
constexpr int kMinThreads = 64;   // the smallest block of a small call
constexpr int kTreeLog = 15;      // the largest tree: 2^15 words (128 KB)
constexpr int kTreeCap = (1 << kTreeLog) - 1;  // keys of the largest tree
constexpr int kSmemHead = 16;     // the mbarrier, padded to 16 bytes

__device__ __forceinline__ int32_t key_of(int32_t q) { return q; }

__device__ __forceinline__ int32_t key_of(long long q) {
  q = q < 0 ? 0 : (q > 0xFFFFFFFFLL ? 0xFFFFFFFFLL : q);
  return (int32_t)(q - 2147483648LL);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits until the mbarrier at bar completes its first phase (the tree's
// bulk copy has landed).
__device__ __forceinline__ void wait_staged(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// Loads the 8 entries p[base .. base + 8) where they lie below n (base < n).
__device__ __forceinline__ void load_sector(const int32_t* __restrict__ p,
                                            int base, int n, int4& a,
                                            int4& b) {
  if (base + 8 <= n) {
    const int4* v = reinterpret_cast<const int4*>(p + base);
    a = __ldg(v);
    b = __ldg(v + 1);
  } else {
    int e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = base + j < n ? __ldg(p + base + j) : 0;
    a = make_int4(e[0], e[1], e[2], e[3]);
    b = make_int4(e[4], e[5], e[6], e[7]);
  }
}

// #{entries <= v} among the first `lim` (>= 1) entries of a loaded sector.
__device__ __forceinline__ int sector_count(int4 a, int4 b, int32_t v,
                                            int lim) {
  return (a.x <= v) + ((lim > 1) & (a.y <= v)) + ((lim > 2) & (a.z <= v)) +
         ((lim > 3) & (a.w <= v)) + ((lim > 4) & (b.x <= v)) +
         ((lim > 5) & (b.y <= v)) + ((lim > 6) & (b.z <= v)) +
         ((lim > 7) & (b.w <= v));
}

// Tree words (2^h, at least 4 so that the bulk copy is a multiple of 16
// bytes) for a top level of m keys; h = bit length of m.
inline int tree_words(int m, int& h) {
  h = 0;
  while ((1 << h) <= m) ++h;
  return (1 << h) < 4 ? 4 : (1 << h);
}

// kTwoLevel: the tree holds fences64 (m keys), else fences8 (m = n8).
template <typename Q, bool kTwoLevel>
__global__ void __launch_bounds__(kThreads)
    searchsorted_right_kernel(const int32_t* __restrict__ grid, int n,
                              const int32_t* __restrict__ f8, int n8,
                              const int32_t* __restrict__ tree, int m, int h,
                              int words, const Q* __restrict__ q,
                              Q* __restrict__ out, long long nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* t = reinterpret_cast<int32_t*>(smem + kSmemHead);

  const uint32_t bytes = (uint32_t)words * 4u;
  const uint32_t bar_a = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_a),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(t)),
        "l"(tree), "r"(bytes), "r"(bar_a)
        : "memory");
  }

  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the first key is in flight while the tree arrives
  const int32_t first = i < nq ? key_of(q[i]) : 0;
  wait_staged(bar_a);
  for (bool head = true; i < nq; i += stride, head = false) {
    const int32_t v = head ? first : key_of(q[i]);
    // descent of the staged tree: h steps for every query, so a warp never
    // diverges here; s = #{top-level keys <= v}
    int k = 1;
    for (int d = 0; d < h; ++d) k = 2 * k + (t[k] <= v);
    const int s = min(k - (1 << h), m);
    int sec = s > 0 ? s - 1 : 0;  // sector of fences8 or of the grid
    int4 a, b;
    if (kTwoLevel) {  // one sector of fences8 narrows the grid sector
      load_sector(f8, 8 * sec, n8, a, b);
      const int c = sector_count(a, b, v, n8 - 8 * sec);
      sec = c > 0 ? 8 * sec + c - 1 : 0;
    }
    load_sector(grid, 8 * sec, n, a, b);
    out[i] = s == 0 ? 0 : 8 * sec + sector_count(a, b, v, n - 8 * sec);
  }
}

template <typename Q, bool kTwoLevel>
int launch(const int32_t* grid, int n, const int32_t* f8, int n8,
           const int32_t* tree, int m, const Q* q, Q* out, long long nq,
           cudaStream_t stream) {
  auto kernel = searchsorted_right_kernel<Q, kTwoLevel>;
  int h = 0;
  const int words = tree_words(m, h);
  const int bytes = kSmemHead + words * 4;
  // per instantiation: the shared-memory opt-in, once per device; the
  // resident blocks for the last (device, tree size) asked (the mapper asks
  // few sizes)
  static unsigned long long opted_in = 0;  // bit d: done on device d
  static int last_dev = -1, last_bytes = -1, last_blocks = 0, last_sms = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemHead + (kTreeCap + 1) * 4);
    if (e != cudaSuccess) return (int)e;
    opted_in |= bit;
  }
  if (dev != last_dev || bytes != last_bytes) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  bytes);
    last_dev = dev;
    last_bytes = bytes;
    last_blocks = sms * (per_sm > 0 ? per_sm : 1);
    last_sms = sms;
  }
  // fewer queries than the SMs' threads: smaller blocks, one or so per SM
  long long threads = kThreads;
  if (nq < (long long)last_sms * kThreads) {
    threads = ((nq + last_sms - 1) / last_sms + 31) / 32 * 32;
    if (threads < kMinThreads) threads = kMinThreads;
  }
  long long blocks = (nq + threads - 1) / threads;
  if (blocks > last_blocks) blocks = last_blocks;
  kernel<<<(unsigned)blocks, (unsigned)threads, bytes, stream>>>(
      grid, n, f8, n8, tree, m, h, words, q, out, nq);
  return (int)cudaGetLastError();
}

template <typename Q>
int dispatch(const void* grid, int n, const void* f8, const void* tree,
             const void* q, void* out, long long nq, void* stream) {
  const int n8 = (n + 7) / 8;
  const int n64 = (n + 63) / 64;
  const int32_t* g = (const int32_t*)grid;
  const int32_t* t8 = (const int32_t*)f8;
  const int32_t* tr = (const int32_t*)tree;
  if (n8 <= kTreeCap)
    return launch<Q, false>(g, n, t8, n8, tr, n8, (const Q*)q, (Q*)out, nq,
                            (cudaStream_t)stream);
  if (n64 <= kTreeCap)
    return launch<Q, true>(g, n, t8, n8, tr, n64, (const Q*)q, (Q*)out, nq,
                           (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The most keys the staged tree holds; grids of at most 64 * this many.
extern "C" int hal_searchsorted_tree_cap() { return kTreeCap; }

// grid: n >= 1 sorted int32, 16-byte aligned; f8 = grid[::8] (16-byte
// aligned); tree: the top level (grid[::8] when it has at most kTreeCap
// entries, else grid[::64]) as a breadth-first perfect tree of
// max(2^h, 4) words (tree[0] unused), 16-byte aligned.  q, out: nq int32
// (q_i64 = 0) or nq int64 (q_i64 = 1: uint32-range queries, biased in
// registers).  stream: a cudaStream_t.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int hal_searchsorted_right(const void* grid, int n, const void* f8,
                                      const void* tree, const void* q,
                                      void* out, long long nq, int q_i64,
                                      void* stream) {
  if (nq <= 0) return (int)cudaGetLastError();
  if (q_i64)
    return dispatch<long long>(grid, n, f8, tree, q, out, nq, stream);
  return dispatch<int32_t>(grid, n, f8, tree, q, out, nq, stream);
}
