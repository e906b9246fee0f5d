// phylop_fit: the phyloP likelihood-ratio fits of a batch of column
// patterns, one thread per pattern, all of a call's golden-section searches
// in one launch; phylop_lnl: the same likelihood at given scales, for checks.
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
// partial in the rate matrix's eigenbasis,
//     w = max(U @ (exp(lam * t) * (Uinv @ L_child)), 0),   t = bl * scale
//                                               (* sub on subtree edges),
// multiplies w into its parent's partial, and each internal node then
// divides its partial by the largest state and adds log(max) to a running
// log scale; the result is log(max(bg . root, 1e-30)) + log scale.  The
// operations and their order are those of phylop_jax._lnl in float32, and of
// the plain version hal_tpu_torch.ops.phylop_fit.lnl_plain; the golden step
// uses uncontracted (_rn) arithmetic so that it rounds as the plain version.
//
// What bounds it on an H100: arithmetic, not bytes.  A call reads each
// code once (nleaf bytes a pattern) and writes 3 floats a pattern, while a
// pattern's fit is 100 (subtree: 900) evaluations of ~49 FP32 operations per
// leaf edge, ~81 per internal edge and ~9 per node, with 4 exp per edge and
// a log per node on the special function units (16 a clock per SM against
// the FP32 units' 128 lanes, so the exps set about half the bound).
//
// Design, simple first:
//   * one thread runs one pattern's whole fit: no thread waits on another;
//   * the tree is a postorder edge program, int4 per edge (child, parent
//     slot, flags, branch length bits), staged once per block in shared
//     memory; every thread walks it in the same order, so each read of it
//     is a broadcast;
//   * the model (U, Uinv, lam, bg and the five leaf columns) is a kernel
//     argument, i.e. constant memory read as instruction operands;
//   * a leaf edge needs no partial: Uinv @ L_leaf is the precomputed column
//     Uinv[:, c], and for c = 4 (missing) Uinv @ 1;
//   * internal partials live in a per-thread slot array (local memory, kept
//     in L1/L2); the host assigns slots over the postorder so that a freed
//     child slot is reused, and every thread of a warp touches the same slot
//     at the same time, so the accesses coalesce.  kMaxSlots bounds the
//     number of partials alive at once.
// Nodes with one child (left when species are pruned) and with more than two
// children are edges like any other: the first edge of a node sets its
// partial, the last one normalises and stores it.  No --use_fast_math: exp,
// log and the divisions round as PyTorch's float32 ops do.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxSlots = 64;
constexpr int kThreads = 128;
constexpr int kGoldenIters = 50;   // phylop_jax.GOLDEN_ITERS
constexpr int kSubtreeIters = 4;   // phylop_jax.SUBTREE_ITERS
constexpr float kScaleLo = 1e-6f;  // phylop.SCALE_LO
constexpr float kScaleHi = 20.0f;  // phylop.SCALE_HI

// edge flags (ops/phylop_fit.py's FLAG_*)
constexpr int kInSub = 1;   // the branch carries the subtree scale
constexpr int kLeaf = 2;    // the child is a leaf: .x is its code row
constexpr int kFirst = 4;   // the first edge of its parent
constexpr int kLast = 8;    // the last edge of its parent: normalise, store

// the model as the host packs it (ops/phylop_fit.py's model_words)
struct Model {
  float U[16];     // row-major
  float Uinv[16];  // row-major
  float leaf[20];  // leaf[4 c + i] = (Uinv @ L_c)[i], c = 4: L = 1
  float lam[4];
  float bg[4];
  float tiny;
};
constexpr int kModelWords = 61;
static_assert(sizeof(Model) == kModelWords * sizeof(float), "Model layout");

__device__ __forceinline__ float lnl(const Model& m,
                                     const int4* __restrict__ prog,
                                     int n_edges,
                                     const uint8_t* __restrict__ codes,
                                     long long npat, long long p, float scale,
                                     float sub, float (*slots)[4]) {
  float L[4] = {1.f, 1.f, 1.f, 1.f};
  float logscale = 0.f;
  for (int e = 0; e < n_edges; ++e) {
    const int4 ed = prog[e];
    float t = __fmul_rn(__int_as_float(ed.w), scale);
    if (ed.z & kInSub) t = __fmul_rn(t, sub);
    float v[4];
    if (ed.z & kLeaf) {
      const int c = codes[(long long)ed.x * npat + p];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        // selects, not an indexed load: the code differs from lane to lane
        const float* col = m.leaf;
        v[i] = c == 0 ? col[i] : c == 1 ? col[4 + i] : c == 2 ? col[8 + i]
             : c == 3 ? col[12 + i] : col[16 + i];
      }
    } else {
      const float* s = slots[ed.x];
      const float s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = fmaf(m.Uinv[4 * i + 3], s3,
               fmaf(m.Uinv[4 * i + 2], s2,
               fmaf(m.Uinv[4 * i + 1], s1, __fmul_rn(m.Uinv[4 * i], s0))));
      }
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(v[i], expf(__fmul_rn(m.lam[i], t)));
    float w[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = fmaxf(fmaf(m.U[4 * i + 3], v[3],
                   fmaf(m.U[4 * i + 2], v[2],
                   fmaf(m.U[4 * i + 1], v[1], __fmul_rn(m.U[4 * i], v[0])))),
                   0.f);
    }
    if (ed.z & kFirst) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) L[i] = w[i];
    } else {
      #pragma unroll
      for (int i = 0; i < 4; ++i) L[i] = __fmul_rn(L[i], w[i]);
    }
    if (ed.z & kLast) {
      float mx = fmaxf(fmaxf(L[0], L[1]), fmaxf(L[2], L[3]));
      mx = mx > 0.f ? mx : 1.f;
      float* s = slots[ed.y];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        L[i] = __fdiv_rn(L[i], mx);
        s[i] = L[i];
      }
      logscale = __fadd_rn(logscale, logf(mx));
    }
  }
  // L holds the root's partial: the root is the last node of the postorder
  const float r = fmaf(m.bg[3], L[3], fmaf(m.bg[2], L[2],
                  fmaf(m.bg[1], L[1], __fmul_rn(m.bg[0], L[0]))));
  return __fadd_rn(logf(fmaxf(r, m.tiny)), logscale);
}

struct Ctx {
  const Model* m;
  const int4* prog;
  int n_edges;
  const uint8_t* codes;
  long long npat;
  long long p;
  float (*slots)[4];
  __device__ float operator()(float scale, float sub) const {
    return lnl(*m, prog, n_edges, codes, npat, p, scale, sub, slots);
  }
};

// golden-section maximisation over [lo, hi] of the likelihood in the scale
// (kSub false, the subtree scale fixed at `fixed`) or in the subtree scale
// (kSub true, the scale fixed): phylop_jax._golden, 50 iterations of two
// evaluations; left = f(c) > f(d), so a NaN goes right
template <bool kSub>
__device__ float golden(const Ctx& f, float lo, float hi, float invphi,
                        float fixed) {
  float a = lo, b = hi;
  for (int it = 0; it < kGoldenIters; ++it) {
    const float w = __fmul_rn(invphi, __fsub_rn(b, a));
    const float c = __fsub_rn(b, w);
    const float d = __fadd_rn(a, w);
    const float fc = kSub ? f(fixed, c) : f(c, fixed);
    const float fd = kSub ? f(fixed, d) : f(d, fixed);
    const bool left = fc > fd;
    a = left ? a : c;
    b = left ? d : b;
  }
  return __fdiv_rn(__fadd_rn(a, b), 2.f);
}

__device__ __forceinline__ void stage(int4* sprog, const int4* prog,
                                      int n_edges) {
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x) sprog[i] = prog[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
phylop_fit_kernel(const __grid_constant__ Model m, const int4* __restrict__ prog, int n_edges,
                  const uint8_t* __restrict__ codes, long long npat,
                  float lo, float hi, float invphi, int subtree,
                  float* __restrict__ null_out, float* __restrict__ scale_out,
                  float* __restrict__ sub_out) {
  extern __shared__ int4 sprog[];
  stage(sprog, prog, n_edges);
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npat) return;
  float slots[kMaxSlots][4];
  const Ctx f{&m, sprog, n_edges, codes, npat, p, slots};
  if (!subtree) {
    null_out[p] = 1.f;
    scale_out[p] = golden<false>(f, lo, hi, invphi, 1.f);
    sub_out[p] = 1.f;
    return;
  }
  // the subtree LRT: the null fits the whole-tree scale alone, the
  // alternative alternates (scale, subtree scale) 1-D fits
  null_out[p] = golden<false>(f, kScaleLo, kScaleHi, invphi, 1.f);
  float scale = 1.f, sub = 1.f;
  for (int r = 0; r < kSubtreeIters; ++r) {
    scale = golden<false>(f, kScaleLo, kScaleHi, invphi, sub);
    sub = golden<true>(f, lo, hi, invphi, scale);
  }
  scale_out[p] = scale;
  sub_out[p] = sub;
}

__global__ void __launch_bounds__(kThreads)
phylop_lnl_kernel(const __grid_constant__ Model m, const int4* __restrict__ prog, int n_edges,
                  const uint8_t* __restrict__ codes, long long npat,
                  const float* __restrict__ scale,
                  const float* __restrict__ sub, float* __restrict__ out) {
  extern __shared__ int4 sprog[];
  stage(sprog, prog, n_edges);
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npat) return;
  float slots[kMaxSlots][4];
  out[p] = lnl(m, sprog, n_edges, codes, npat, p, scale[p], sub[p], slots);
}

// shared memory of the staged program; past the 48 KB default a kernel
// needs the opt-in attribute
template <typename K>
cudaError_t prepare(K kernel, int n_edges, int n_slots, size_t* smem) {
  if (n_edges < 1 || n_slots < 1 || n_slots > kMaxSlots)
    return cudaErrorInvalidValue;
  *smem = (size_t)n_edges * sizeof(int4);
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int hal_phylop_max_slots() { return kMaxSlots; }

int hal_phylop_model_words() { return kModelWords; }

// model: kModelWords floats in host memory; prog: n_edges int4 on the
// device; codes: (nleaf, npat) uint8 on the device; outputs: npat floats
int hal_phylop_fit(const float* model, const void* prog, int n_edges,
                   int n_slots, const void* codes, long long npat, float lo,
                   float hi, float invphi, int subtree, void* null_out,
                   void* scale_out, void* sub_out, void* stream) {
  Model m;
  memcpy(&m, model, sizeof(Model));
  size_t smem = 0;
  cudaError_t err = prepare(phylop_fit_kernel, n_edges, n_slots, &smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((npat + kThreads - 1) / kThreads);
  phylop_fit_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      m, (const int4*)prog, n_edges, (const uint8_t*)codes, npat, lo, hi,
      invphi, subtree, (float*)null_out, (float*)scale_out, (float*)sub_out);
  return (int)cudaGetLastError();
}

int hal_phylop_lnl(const float* model, const void* prog, int n_edges,
                   int n_slots, const void* codes, long long npat,
                   const void* scale, const void* sub, void* out,
                   void* stream) {
  Model m;
  memcpy(&m, model, sizeof(Model));
  size_t smem = 0;
  cudaError_t err = prepare(phylop_lnl_kernel, n_edges, n_slots, &smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((npat + kThreads - 1) / kThreads);
  phylop_lnl_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      m, (const int4*)prog, n_edges, (const uint8_t*)codes, npat,
      (const float*)scale, (const float*)sub, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
