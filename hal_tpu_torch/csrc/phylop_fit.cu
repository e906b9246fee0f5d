// phylop_fit: the phyloP likelihood-ratio fits of a batch of column
// patterns, all of a call's golden-section searches in one launch;
// phylop_lnl: the same likelihood at given scales, for checks.
//
// Replaces DevicePhyloP._build_jit of hal_tpu/phylop_jax.py:166-203, which
// is an XLA program (not a Pallas kernel): the pruning of _lnl (:106-135)
// traced once over the model tree, inside the golden search of _golden
// (:137-156, a lax.fori_loop of 50 iterations with two likelihood
// evaluations each), inside the subtree fit's 4 alternating rounds
// (:183-201).  Eager PyTorch would run that as ~8 launches per tree edge
// per evaluation; this kernel runs it as one launch per call.
//
// Per pattern and evaluation, each tree edge applies P(t) to its child's
// partial L in the rate matrix's eigenbasis, as I + U (e - 1) Uinv:
//     w = max(L + U @ ((2^(lam2 * t) - 1) * (Uinv @ L)), 0),   t = bl * scale
//                                               (* sub on subtree edges),
// with lam2 = lam * log2(e) folded on the host, and multiplies w into its
// parent's partial.  Each internal node then scales its partial by 2^-e, e
// the binary exponent of its largest state (frexp's: the largest state
// lands in [0.5, 1), so every w stays <= 1 as in the reference), and adds
// e to an integer log scale; the result is
//     log(max(bg . root, tiny)) + k * ln2,   k the sum of the e's.
// That is the likelihood of phylop_jax._lnl, which forms U (e * Uinv @ L)
// and divides each partial by its largest state, adding its log.  Here the
// power-of-two scaling is exact and the scale sum an integer, so no
// division and no log is rounded per node; and e - 1 is computed to a few
// ulp of itself (expm1_2), so a short branch's small entries of w carry no
// cancellation: JAX's form sums O(1) terms to an entry of O(t), losing
// ~1e-7 / t of it, which is what the float32 plain version
// (hal_tpu_torch.ops.phylop_fit.lnl_plain, JAX's arithmetic) is off by
// against float64 (up to 2.3e-5 relative on a 9-leaf tree).  The golden
// step uses uncontracted (_rn) arithmetic so that it rounds as the plain
// version.
//
// What bounds it on an H100: instruction issue.  A call reads each code
// once and writes 3 floats a pattern, while a pattern's fit is 100
// (subtree: 900) walks of the tree.  A first, simple design (one point a
// walk, JAX's arithmetic) issued ~69k instructions per evaluation of the
// 241-leaf tree (its SASS, counted by bench_phylop_fit.py --sass: an
// IEEE division per state and node, a logf per node, expf's range
// reduction, a 5-way select per leaf edge, the slot array in local memory)
// at ~83% of the issue rate.  This design issues ~40% fewer:
//   * both points of a golden iteration in one walk: one read of each
//     program entry, code and leaf table serves two independent chains of
//     arithmetic, each rounded as if evaluated alone (kChains = 2);
//   * power-of-two normalisation (above): a compare, two integer ops and
//     four exact multiplies per node instead of four divisions and a logf;
//   * e - 1 on the MUFU: 2^y - 1 by ex2.approx.ftz for y <= -1/8 (two
//     instructions; the ftz only flushes terms below 2^-126 of -1) and a
//     degree-5 polynomial above, with log2(e) folded into lam2 on the host;
//     state 3 carries the rate matrix's eigenvalue 0 (eigh puts it last; the
//     host sets its lam2 to 0, FitProgram.exp2_rates), so its e - 1 is 0
//     and it is skipped whole, its row of Uinv and column of U included;
//   * the five leaf columns Uinv @ L_c and the five L_c (c = 4: missing, L
//     = 1) are float4 tables in shared memory indexed by the code, one
//     conflict-free 16-byte load each per leaf edge (each code's entry
//     spans its own four banks); each leaf's code is loaded one edge ahead;
//   * internal partials live in dynamic shared memory, float4 slots laid
//     out [slot][chain][thread] (a warp's 16-byte loads and stores cover
//     512 consecutive bytes), sized at launch from n_slots; the host orders
//     the walk so that each node's child subtrees are visited largest slot
//     need first (Sethi-Ullman: 5 slots for a 241-leaf tree where JAX's
//     postorder needs 14) while each node's own edges keep JAX's child
//     order, so the products are JAX's;
//   * the model (U, Uinv, lam2, bg) is a __grid_constant__ argument, read
//     as constant-bank operands of the FMAs.
// Launch shapes: one thread runs one pattern's whole fit with both chains
// (kChains = 2); when a call's patterns do not fill the card, two
// neighbouring lanes take one pattern, one chain each, and trade f with
// __shfl_xor_sync (kChains = 1).  Both round alike, so both give the same
// bits.  Nodes with one child (left when species are pruned) and with more
// than two children are edges like any other: a node's partial starts at 1,
// each edge multiplies its w in, and the last one normalises and stores it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// the dynamic shared memory: the program and a zero sentinel, the two leaf
// tables, then the slots (smem_bytes)
extern __shared__ int4 phylop_smem[];

namespace {

constexpr int kMaxSlots = 32;
constexpr int kThreads = 128;
constexpr long long kMaxPatterns = 1 << 30;  // two lanes each in an int
constexpr int kGoldenIters = 50;   // phylop_jax.GOLDEN_ITERS
constexpr int kSubtreeIters = 4;   // phylop_jax.SUBTREE_ITERS
constexpr float kScaleLo = 1e-6f;  // phylop.SCALE_LO
constexpr float kScaleHi = 20.0f;  // phylop.SCALE_HI
// ln 2 = kLn2Hi + kLn2Lo, each the nearest float
constexpr float kLn2Hi = 0.693147182464599609375f;
constexpr float kLn2Lo = -1.904654323148236e-09f;

// edge flags (ops/phylop_fit.py's FLAG_*)
constexpr int kInSub = 1;   // the branch carries the subtree scale
constexpr int kLeaf = 2;    // the child is a leaf: .x is its code row
constexpr int kLast = 8;    // the last edge of its parent: normalise, store

// the model as the host packs it (ops/phylop_fit.py's model_words)
struct Model {
  float U[16];     // row-major
  float Uinv[16];  // row-major
  float leaf[20];  // leaf[4 c + i] = (Uinv @ L_c)[i], c = 4: L = 1
  float lam2[4];   // lam * log2(e); lam2[3] = 0, the unit state
  float bg[4];
  float tiny;
};
constexpr int kModelWords = 61;
static_assert(sizeof(Model) == kModelWords * sizeof(float), "Model layout");

__device__ __forceinline__ float ex2(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// 2^y - 1 for y <= 0: for y > -1/8, y times the Taylor polynomial of
// (2^y - 1) / y to degree 4 (truncation 7e-9 relative, ~1 ulp in all);
// below, ex2 - 1 (an exact subtraction; ex2's 2 ulp of 2^y <= 0.917 are at
// most 1.5e-6 of the result, and less the longer the branch)
__device__ __forceinline__ float expm1_2(float y) {
  const float q = fmaf(y, fmaf(y, fmaf(y, fmaf(y, 1.3333558146428441e-03f,
      9.6181291076284769e-03f), 5.5504108664821576e-02f),
      2.4022650695910069e-01f), 6.9314718055994529e-01f);
  return y > -0.125f ? __fmul_rn(y, q) : __fsub_rn(ex2(y), 1.f);
}

// scales L by 2^-e, e the binary exponent of its largest state (the largest
// state lands in [0.5, 1)), and returns e.  Every state is >= 0 and, being a
// product of w <= 1 (up to rounding), < 2.  A largest state of 0 or below
// 2^-126 (its exponent field 0) is left as it is, e = 0: an all-zero
// partial as the reference's guard leaves it, a subnormal one unscaled
// (exactly, and consistent with k).
__device__ __forceinline__ int normalise(float (&L)[4]) {
  const float mx = fmaxf(fmaxf(L[0], L[1]), fmaxf(L[2], L[3]));
  const int f = __float_as_int(mx) >> 23;             // biased exponent
  const int e = f ? f - 126 : 0;
  const float s = __int_as_float((127 - e) << 23);     // 2^-e
  #pragma unroll
  for (int i = 0; i < 4; ++i) L[i] = __fmul_rn(L[i], s);
  return e;
}

__device__ __forceinline__ float4* smem4() {
  return reinterpret_cast<float4*>(phylop_smem);
}

// where one thread's program, tables and partials lie in smem (indices)
struct Walk {
  int n_edges;           // the program: smem[0, n_edges], sentinel included
  int leaf;              // Uinv @ L_c for the five codes, then the five L_c
  int slots;             // this thread's slot 0, chain 0; kThreads float4s
                         // from one (slot, chain) to the next
  int npat;              // from one leaf row of codes to the next
  const uint8_t* codes;  // this pattern's code of leaf row 0
};

// a leaf row's code of this pattern: row and npat are non-negative ints, so
// their product is one 32 x 32 -> 64-bit multiply-add onto the pointer
__device__ __forceinline__ const uint8_t* code_of(const Walk& w, int row) {
  return w.codes + (unsigned long long)(unsigned)row * (unsigned)w.npat;
}

__device__ __forceinline__ void to4(float (&x)[4], float4 v) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// the log-likelihoods of kChains points (scale[c], sub[c]) in one walk of
// the edge program; each chain rounds as it would alone.  State 3, the unit
// state (e - 1 = 0), is left out.
template <int kChains>
__device__ __forceinline__ void lnl(const Model& m, const Walk& w,
                                    const float (&scale)[kChains],
                                    const float (&sub)[kChains],
                                    float (&out)[kChains]) {
  constexpr int kStates = 3;
  float L[kChains][4];
  int k[kChains];
  #pragma unroll
  for (int c = 0; c < kChains; ++c) {
    k[c] = 0;
    #pragma unroll
    for (int i = 0; i < 4; ++i) L[c][i] = 1.f;
  }
  int4 ed = phylop_smem[0];
  int code = (ed.z & kLeaf) ? __ldg(code_of(w, ed.x)) : 0;
  #pragma unroll 2
  for (int e = 0; e < w.n_edges; ++e) {
    const int4 nx = phylop_smem[e + 1];
    const int next_code = (nx.z & kLeaf) ? __ldg(code_of(w, nx.x)) : 0;
    float child[kChains][4], v[kChains][4];
    if (ed.z & kLeaf) {
      // each chain loads the table entries itself: a load costs no more
      // than the moves that would copy them
      const int c4 = min(code, 4);
      #pragma unroll
      for (int c = 0; c < kChains; ++c) {
        to4(v[c], smem4()[w.leaf + c4]);
        to4(child[c], smem4()[w.leaf + 5 + c4]);
      }
    } else {
      #pragma unroll
      for (int c = 0; c < kChains; ++c) {
        to4(child[c], smem4()[w.slots + (ed.x * kChains + c) * kThreads]);
        const float* s = child[c];
        #pragma unroll
        for (int i = 0; i < kStates; ++i) {
          v[c][i] = fmaf(m.Uinv[4 * i + 3], s[3],
                    fmaf(m.Uinv[4 * i + 2], s[2],
                    fmaf(m.Uinv[4 * i + 1], s[1], __fmul_rn(m.Uinv[4 * i], s[0]))));
        }
      }
    }
    const float bl = __int_as_float(ed.w);
    #pragma unroll
    for (int c = 0; c < kChains; ++c) {
      float t = __fmul_rn(bl, scale[c]);
      if (ed.z & kInSub) t = __fmul_rn(t, sub[c]);
      float d[4];
      #pragma unroll
      for (int i = 0; i < kStates; ++i)
        d[i] = __fmul_rn(v[c][i], expm1_2(__fmul_rn(m.lam2[i], t)));
      float wv[4];
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = child[c][j];
        #pragma unroll
        for (int i = 0; i < kStates; ++i) x = fmaf(m.U[4 * j + i], d[i], x);
        wv[j] = fmaxf(x, 0.f);
      }
      #pragma unroll
      for (int i = 0; i < 4; ++i) L[c][i] = __fmul_rn(L[c][i], wv[i]);
    }
    if (ed.z & kLast) {
      #pragma unroll
      for (int c = 0; c < kChains; ++c) {
        k[c] += normalise(L[c]);
        smem4()[w.slots + (ed.y * kChains + c) * kThreads] =
            make_float4(L[c][0], L[c][1], L[c][2], L[c][3]);
        // the next node's partial starts at 1: its first w is multiplied
        // in exactly
        #pragma unroll
        for (int i = 0; i < 4; ++i) L[c][i] = 1.f;
      }
    }
    ed = nx;
    code = next_code;
  }
  // the root is the last node of the walk: its partial is in its slot
  const int root = phylop_smem[w.n_edges - 1].y;
  #pragma unroll
  for (int c = 0; c < kChains; ++c) {
    to4(L[c], smem4()[w.slots + (root * kChains + c) * kThreads]);
    const float r = fmaf(m.bg[3], L[c][3], fmaf(m.bg[2], L[c][2],
                    fmaf(m.bg[1], L[c][1], __fmul_rn(m.bg[0], L[c][0]))));
    const float kf = (float)k[c];
    out[c] = fmaf(kf, kLn2Hi, fmaf(kf, kLn2Lo, logf(fmaxf(r, m.tiny))));
  }
}

// golden-section maximisation over [lo, hi] of the likelihood in the scale
// (vary_sub false, the subtree scale fixed at `fixed`) or in the subtree
// scale (vary_sub true, the scale fixed): phylop_jax._golden, 50 iterations
// of two evaluations; left = f(c) > f(d), so a NaN goes right.  kChains 2:
// this thread evaluates both points; 1: the even lane of a pair evaluates c,
// the odd lane d.
template <int kChains>
__device__ __forceinline__ float golden(const Model& m, const Walk& w,
                                        bool vary_sub, float lo, float hi,
                                        float invphi, float fixed) {
  float a = lo, b = hi;
  for (int it = 0; it < kGoldenIters; ++it) {
    const float wd = __fmul_rn(invphi, __fsub_rn(b, a));
    const float c = __fsub_rn(b, wd);
    const float d = __fadd_rn(a, wd);
    float fc, fd;
    if constexpr (kChains == 2) {
      const float sc[2] = {vary_sub ? fixed : c, vary_sub ? fixed : d};
      const float ss[2] = {vary_sub ? c : fixed, vary_sub ? d : fixed};
      float f[2];
      lnl<2>(m, w, sc, ss, f);
      fc = f[0];
      fd = f[1];
    } else {
      const bool odd = threadIdx.x & 1;
      const float x = odd ? d : c;
      const float sc[1] = {vary_sub ? fixed : x};
      const float ss[1] = {vary_sub ? x : fixed};
      float f[1];
      lnl<1>(m, w, sc, ss, f);
      const float g = __shfl_xor_sync(0xffffffffu, f[0], 1);
      fc = odd ? g : f[0];
      fd = odd ? f[0] : g;
    }
    const bool left = fc > fd;
    a = left ? a : c;
    b = left ? d : b;
  }
  return __fdiv_rn(__fadd_rn(a, b), 2.f);
}

// shared memory: the program and its zero sentinel, the two leaf tables,
// then kChains slots a thread
__host__ __device__ constexpr size_t smem_bytes(int n_edges, int n_slots,
                                                int chains) {
  return ((size_t)n_edges + 1 + 10 + (size_t)n_slots * chains * kThreads)
         * sizeof(int4);
}

__device__ __forceinline__ Walk stage(const Model& m, const int4* prog,
                                      int n_edges, const uint8_t* codes,
                                      int npat, long long p) {
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x)
    phylop_smem[i] = prog[i];
  const int leaf = n_edges + 1;
  if (threadIdx.x == 0) phylop_smem[n_edges] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < 5) {
    const int c = threadIdx.x;
    const float* col = m.leaf + 4 * c;
    smem4()[leaf + c] = make_float4(col[0], col[1], col[2], col[3]);
    smem4()[leaf + 5 + c] = make_float4(c == 0 || c == 4, c == 1 || c == 4,
                                      c == 2 || c == 4, c == 3 || c == 4);
  }
  __syncthreads();
  return Walk{n_edges, leaf, leaf + 10 + (int)threadIdx.x, npat, codes + p};
}

template <int kChains>
__global__ void __launch_bounds__(kThreads)
phylop_fit_kernel(const __grid_constant__ Model m, const int4* __restrict__ prog,
                  int n_edges, const uint8_t* __restrict__ codes,
                  int npat, float lo, float hi, float invphi,
                  int subtree, float* __restrict__ null_out,
                  float* __restrict__ scale_out, float* __restrict__ sub_out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long q = kChains == 2 ? g : g >> 1;
  const bool own = q < npat && (kChains == 2 || !(threadIdx.x & 1));
  // a thread past the end walks the last pattern and writes nothing: every
  // thread reaches the staging barrier, and both lanes of every pair take
  // part in the shuffles
  const long long p = q < npat ? q : npat - 1;
  const Walk w = stage(m, prog, n_edges, codes, npat, p);
  // the searches: one, or with a subtree the null fit of the whole-tree
  // scale, then kSubtreeIters rounds of (scale, subtree scale)
  float null_scale = 1.f, scale = 1.f, sub = 1.f;
  const int n_search = subtree ? 1 + 2 * kSubtreeIters : 1;
  for (int s = 0; s < n_search; ++s) {
    if (!subtree) {
      scale = golden<kChains>(m, w, false, lo, hi, invphi, 1.f);
    } else if (s == 0) {
      null_scale = golden<kChains>(m, w, false, kScaleLo, kScaleHi, invphi,
                                   1.f);
    } else if (s & 1) {
      scale = golden<kChains>(m, w, false, kScaleLo, kScaleHi, invphi, sub);
    } else {
      sub = golden<kChains>(m, w, true, lo, hi, invphi, scale);
    }
  }
  if (own) {
    null_out[p] = null_scale;
    scale_out[p] = scale;
    sub_out[p] = sub;
  }
}

__global__ void __launch_bounds__(kThreads)
phylop_lnl_kernel(const __grid_constant__ Model m, const int4* __restrict__ prog,
                  int n_edges, const uint8_t* __restrict__ codes,
                  int npat, const float* __restrict__ scale,
                  const float* __restrict__ sub, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = q < npat ? q : npat - 1;
  const Walk w = stage(m, prog, n_edges, codes, npat, p);
  const float sc[1] = {scale[p]};
  const float ss[1] = {sub[p]};
  float f[1];
  lnl<1>(m, w, sc, ss, f);
  if (q < npat) out[p] = f[0];
}

// the dynamic shared memory of a launch; past the 48 KB default a kernel
// needs the opt-in attribute, and past the card's opt-in limit it cannot run
template <typename K>
cudaError_t prepare(K kernel, int n_edges, int n_slots, int chains,
                    size_t* smem) {
  if (n_edges < 1 || n_slots < 1 || n_slots > kMaxSlots)
    return cudaErrorInvalidValue;
  *smem = smem_bytes(n_edges, n_slots, chains);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (*smem > (size_t)limit) return cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  }
  return cudaSuccess;
}

template <int kChains>
int launch_fit(const Model& m, const void* prog, int n_edges, int n_slots,
               const void* codes, long long npat, float lo, float hi,
               float invphi, int subtree, void* null_out, void* scale_out,
               void* sub_out, cudaStream_t stream) {
  auto kernel = phylop_fit_kernel<kChains>;
  if (npat < 1 || npat > kMaxPatterns) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = prepare(kernel, n_edges, n_slots, kChains, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long threads = kChains == 2 ? npat : 2 * npat;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(
      m, (const int4*)prog, n_edges, (const uint8_t*)codes, (int)npat, lo, hi,
      invphi, subtree, (float*)null_out, (float*)scale_out, (float*)sub_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hal_phylop_max_slots() { return kMaxSlots; }

int hal_phylop_model_words() { return kModelWords; }

long long hal_phylop_max_patterns() { return kMaxPatterns; }

// the patterns one wave of the one-thread-per-pattern shape holds on the
// current device (its resident blocks on every SM), or -cudaError
long long hal_phylop_fit_wave(int n_edges, int n_slots) {
  auto kernel = phylop_fit_kernel<2>;
  size_t smem = 0;
  cudaError_t err = prepare(kernel, n_edges, n_slots, 2, &smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)per_sm * sms * kThreads;
}

// model: kModelWords floats in host memory; prog: n_edges int4 on the
// device; codes: (nleaf, npat) uint8 on the device; outputs: npat floats.
// pair_lanes: two lanes a pattern (1) or one thread (0)
int hal_phylop_fit(const float* model, const void* prog, int n_edges,
                   int n_slots, const void* codes, long long npat, float lo,
                   float hi, float invphi, int subtree, int pair_lanes,
                   void* null_out, void* scale_out, void* sub_out,
                   void* stream) {
  Model m;
  memcpy(&m, model, sizeof(Model));
  const cudaStream_t s = (cudaStream_t)stream;
  if (pair_lanes) {
    return launch_fit<1>(m, prog, n_edges, n_slots, codes, npat, lo, hi,
                         invphi, subtree, null_out, scale_out, sub_out, s);
  }
  return launch_fit<2>(m, prog, n_edges, n_slots, codes, npat, lo, hi, invphi,
                       subtree, null_out, scale_out, sub_out, s);
}

int hal_phylop_lnl(const float* model, const void* prog, int n_edges,
                   int n_slots, const void* codes, long long npat,
                   const void* scale, const void* sub, void* out,
                   void* stream) {
  Model m;
  memcpy(&m, model, sizeof(Model));
  auto kernel = phylop_lnl_kernel;
  if (npat < 1 || npat > kMaxPatterns) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = prepare(kernel, n_edges, n_slots, 1, &smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((npat + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      m, (const int4*)prog, n_edges, (const uint8_t*)codes, (int)npat,
      (const float*)scale, (const float*)sub, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
