// The table-selection probes P1-P6 for Hopper (sm_90a), bound to Python
// with ctypes: three kernel templates, each taking the variant as a template
// parameter so that a variant compiles to the instructions it names.
//
// Replaces the Pallas probes scripts/exp_gather_kernel.py:85 (P1),
// exp_gather2d.py:71 (P2), exp_gather32.py:65 (P3), exp_gather_forms.py:33
// (P4), exp_bisect.py:30 (P5) and exp_probe_ops.py:30 (P6).  They ask how
// DFIRE should pick a pair's table entry from its d2: a 20-step select
// chain, a tournament of selects, a count of the thresholds passed and one
// indexed load, or the arithmetic slot trunc(2 sqrt(d2) - 1) and one gather.
//
//   select_reps_kernel<T, kMode>  (P1) one thread per (p, r, l) element
//     loops over the reps; per rep each warp reduces its terms in a fixed
//     tree into shared memory, every 32 reps the 8 warp sums are added in
//     order into the block's partial row, sum_rows (sum_rows.cuh) adds the
//     rows in order, and rep_acc_kernel adds the reps in order in the
//     working type.  Bound by the instruction rate: about 45-65 operations
//     an element-rep against under 1 MB of inputs.
//   receptor_loop_kernel<kMode>   (P2, P3) one thread per (p, l) loops over
//     the receptor atoms, staged in shared memory (the TPU kept them in
//     SMEM); the (R, 32, L) table (53.5 MB at P3) is read through L1/L2.
//     The chain is bound by its instructions, the gather reads one scattered
//     entry a pair.
//   gather_form_kernel<kForm>     (P4-P6) one thread per (p, l): the
//     single-shot forms' one expression, a microsecond or two, and the
//     loops whose terms are a load and an operation or two, in turn.
//   gather_form_reps_kernel<kForm> (P4-P6) the loops whose term is a
//     correctly rounded sqrt and a gather, or a 21-entry chain (8-64 reps
//     an element): one thread per (element, rep) term, so the 4,096-8,192
//     elements' 32k-524k terms fill the card where one thread an element
//     ran its reps in turn on 2 warps an SM; each element's terms are then
//     added in rep order from shared memory, so the sums are the loop's,
//     bit for bit.
//   A call is bound by the host's work, not the card's: the wrapper
//   (ops/probes.py) keeps it to the checks, one allocation and the call.
//
// Numbers follow the JAX probes: d2 and every sum with explicit
// round-to-nearest intrinsics (no contraction into FMA), sqrtf correctly
// rounded (no --use_fast_math), the slot cast truncating toward zero before
// the clip, bfloat16 rounded after every operation (computed in float, as
// PyTorch and XLA do).  Sums over r and reps run in the probes' order, so
// the plain versions (ops/probes.py) repeat them bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

#include "sum_rows.cuh"

namespace {

constexpr int kSelectThreads = 256;
constexpr int kWarps = kSelectThreads / 32;
constexpr int kBatch = 32;        // reps between two block reductions
constexpr int kK = 21;            // P1's table entries
constexpr int kNSlot = 32;        // slots of the arithmetic binning
constexpr int kMaxChain = 20;     // thresholds of a chain
constexpr int kLoopThreads = 64;
constexpr int kFormThreads = 128;
constexpr int kRepThreads = 256;   // gather_form_reps_kernel: terms a pass

enum SelectMode { kChain = 0, kTak = 1, kTourn = 2 };
enum LoopMode { kLoopSlot = 0, kLoopGather = 1, kLoopChain = 2 };
enum Form {
  kBare = 0, kSlotGather, kStaticLoop, kSliceLoop, kRowLoop, kParityLoop,
  kTouch, kChainLoop, kSqrt, kTruncCast, kScalarLoop
};

struct Thresholds {
  float v[kMaxChain];
};

// The working type: values are held in float and rounded to T after every
// operation.
template <typename T>
struct Work;
template <>
struct Work<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <>
struct Work<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// clip(int32(2 sqrt(d2) - 1), 0, 31): the cast truncates toward zero.
__device__ __forceinline__ int slot_of(float d2) {
  const float m = __fsub_rn(__fmul_rn(2.0f, sqrtf(d2)), 1.0f);
  return min(max(__float2int_rz(m), 0), kNSlot - 1);
}

// exp_gather_kernel.py's tourn_body: a tree of selects over t[LO:HI].
template <int LO, int HI>
__device__ __forceinline__ float tournament(const float (&t)[kK], const float (&s)[kK - 1],
                                            float x) {
  if constexpr (HI - LO == 1) {
    return t[LO];
  } else {
    constexpr int MID = (LO + HI) / 2;
    const float left = tournament<LO, MID>(t, s, x);
    const float right = tournament<MID, HI>(t, s, x);
    return x >= s[MID - 1] ? right : left;
  }
}

// Grid: (R L / 256) blocks per pose, pose-major; partial is
// (R L / 256, P reps), row = the block within its pose.
template <typename T, int kMode>
__global__ void __launch_bounds__(kSelectThreads)
select_reps_kernel(const T* __restrict__ d2, const T* __restrict__ tab,
                   float* __restrict__ partial, Thresholds thr, int p_count, int rl,
                   int reps, float cutoff2) {
  using W = Work<T>;
  __shared__ float s_red[kWarps][kBatch];
  const int blocks_per_pose = rl / kSelectThreads;
  const int p = blockIdx.x / blocks_per_pose;
  const int b = blockIdx.x % blocks_per_pose;
  const int e = b * kSelectThreads + threadIdx.x;   // the (r, l) element
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float s[kK - 1];
#pragma unroll
  for (int k = 0; k < kK - 1; ++k) s[k] = W::round(thr.v[k]);
  float t[kK];   // chain and tourn read every entry; tak loads one a rep
  if constexpr (kMode != kTak) {
#pragma unroll
    for (int k = 0; k < kK; ++k) t[k] = W::load(tab + (size_t)k * rl + e);
  }
  const float x0 = W::load(d2 + (size_t)p * rl + e);
  const float eps = W::round(1e-6f);
  float* part = partial + (size_t)b * p_count * reps + (size_t)p * reps;

  for (int i0 = 0; i0 < reps; i0 += kBatch) {
    const int n = min(kBatch, reps - i0);
    for (int j = 0; j < n; ++j) {
      const float di = W::round(__fmul_rn(W::round((float)(i0 + j)), eps));
      const float x = W::round(__fadd_rn(x0, di));
      float sel;
      if constexpr (kMode == kChain) {
        sel = t[0];
#pragma unroll
        for (int k = 0; k < kK - 1; ++k) sel = x >= s[k] ? W::round(__fadd_rn(sel, t[k + 1])) : sel;
      } else if constexpr (kMode == kTak) {
        int idx = 0;
#pragma unroll
        for (int k = 0; k < kK - 1; ++k) idx += x >= s[k] ? 1 : 0;
        sel = W::load(tab + (size_t)idx * rl + e);
      } else {
        sel = tournament<0, kK>(t, s, x);
      }
      float v = W::round(__fmul_rn(sel, x <= cutoff2 ? 1.0f : 0.0f));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) s_red[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < n) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum = __fadd_rn(sum, s_red[w][threadIdx.x]);
      part[i0 + threadIdx.x] = sum;
    }
    __syncthreads();
  }
}

// out[p] = the reps' totals of pose p added in order in the working type.
template <typename T>
__global__ void rep_acc_kernel(const float* __restrict__ totals, T* __restrict__ out,
                               int p_count, int reps) {
  using W = Work<T>;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_count) return;
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    acc = W::round(__fadd_rn(acc, W::round(totals[(size_t)p * reps + i])));
  }
  out[p] = W::store(acc);
}

// Grid (ceil(L / 64), P); rec (R, 3) staged in dynamic shared memory.
template <int kMode>
__global__ void __launch_bounds__(kLoopThreads)
receptor_loop_kernel(const float* __restrict__ lig, const float* __restrict__ rec,
                     const float* __restrict__ tab, float* __restrict__ out, Thresholds thr,
                     int l_count, int r_count, float cutoff2) {
  extern __shared__ float s_rec[];
  for (int k = threadIdx.x; k < 3 * r_count; k += blockDim.x) s_rec[k] = rec[k];
  __syncthreads();
  const int p = blockIdx.y;
  const int l = blockIdx.x * kLoopThreads + threadIdx.x;
  if (l >= l_count) return;
  const float* lp = lig + (size_t)p * 3 * l_count + l;
  const float lx = lp[0], ly = lp[l_count], lz = lp[2 * l_count];
  const size_t row = (size_t)l_count;
  float acc = 0.0f;
  for (int r = 0; r < r_count; ++r) {
    const float dx = __fsub_rn(lx, s_rec[3 * r]);
    const float dy = __fsub_rn(ly, s_rec[3 * r + 1]);
    const float dz = __fsub_rn(lz, s_rec[3 * r + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const float* tr = tab + (size_t)r * kNSlot * row + l;
    float term;
    if constexpr (kMode == kLoopSlot) {
      term = (float)slot_of(d2);
    } else if constexpr (kMode == kLoopGather) {
      term = __ldg(tr + slot_of(d2) * row);
    } else {
      float c = __ldg(tr);
#pragma unroll
      for (int k = 0; k < kMaxChain; ++k) {
        c = d2 >= thr.v[k] ? __fadd_rn(c, __ldg(tr + (k + 1) * row)) : c;
      }
      term = __fmul_rn(c, d2 <= cutoff2 ? 1.0f : 0.0f);
    }
    acc = __fadd_rn(acc, term);
  }
  out[(size_t)p * l_count + l] = acc;
}

struct FormArgs {
  const float* x;        // (P, L)
  const float* tab;      // (n_tab, n_slot, L) or null
  const int32_t* idx;    // (P, L) or null
  const float* rec;      // (>= reps, rec_cols) or null
  float* out;            // (P, L)
  int n, l_count, n_slot, rec_cols, reps, row;
};

// The tables' entries of one ligand column l: at(t, s) is entry s of
// table t.
struct Column {
  const float* p;      // tab + l
  size_t table, row;   // n_slot * L, L
  __device__ __forceinline__ float at(int t, int s) const { return __ldg(p + t * table + s * row); }
};

__device__ __forceinline__ Column column(const FormArgs& a, int e) {
  const size_t row = (size_t)a.l_count;
  return Column{a.tab + e % a.l_count, (size_t)a.n_slot * row, row};
}

template <int kForm>
constexpr bool kSingleShot = kForm == kBare || kForm == kSlotGather || kForm == kTouch ||
                             kForm == kSqrt || kForm == kTruncCast;
// Loop forms whose term is heavy: a correctly rounded sqrt (the slot of
// x + r) or a 21-entry chain a rep.  The others' terms are a load and an
// operation or two.
template <int kForm>
constexpr bool kHeavyTerm = kForm == kStaticLoop || kForm == kSliceLoop || kForm == kChainLoop;

// One single-shot form's value at element e.
template <int kForm>
__device__ __forceinline__ float form_value(const FormArgs& a, const Column& c, int e) {
  if constexpr (kForm == kBare) {   // indices clipped into the table, as the plain version does
    return c.at(a.row, min(max(a.idx[e], 0), a.n_slot - 1));
  } else if constexpr (kForm == kSlotGather) {
    return c.at(a.row, slot_of(a.x[e]));
  } else if constexpr (kForm == kTouch) {
    return __fadd_rn(a.x[e], c.at(a.row, 0));
  } else if constexpr (kForm == kSqrt) {
    return sqrtf(a.x[e]);
  } else {   // kTruncCast
    return (float)slot_of(a.x[e]);
  }
}

// One loop form's term of rep r for an element of value x and column c.
template <int kForm>
__device__ __forceinline__ float form_term(const FormArgs& a, const Thresholds& thr,
                                           const Column& c, float x, int r) {
  if constexpr (kForm == kStaticLoop) {
    return c.at(a.row, slot_of(__fadd_rn(x, (float)r)));
  } else if constexpr (kForm == kSliceLoop) {
    return c.at(r, slot_of(__fadd_rn(x, (float)r)));
  } else if constexpr (kForm == kRowLoop) {
    return __fmul_rn(c.at(r, 0), __fadd_rn(__fmul_rn(x, 0.0f), 1.0f));
  } else if constexpr (kForm == kParityLoop) {
    const float m = __fsub_rn(__fmul_rn(2.0f, sqrtf(x)), 1.0f);
    return c.at(r, min(max(__float2int_rz(m) + r % 2, 0), kNSlot - 1));
  } else if constexpr (kForm == kChainLoop) {
    float term = c.at(r, 0);
#pragma unroll
    for (int k = 0; k < kMaxChain; ++k) {
      term = x >= thr.v[k] ? __fadd_rn(term, c.at(r, k + 1)) : term;
    }
    return term;
  } else {   // kScalarLoop
    return __fsub_rn(x, a.rec[(size_t)r * a.rec_cols]);
  }
}

// The single-shot forms, and the loops whose terms are light: one thread
// an element, its reps in turn.
template <int kForm>
__global__ void __launch_bounds__(kFormThreads)
gather_form_kernel(FormArgs a, Thresholds thr) {
  const int e = blockIdx.x * kFormThreads + threadIdx.x;
  if (e >= a.n) return;
  const Column c = column(a, e);
  if constexpr (kSingleShot<kForm>) {
    a.out[e] = form_value<kForm>(a, c, e);
  } else {
    const float x = a.x[e];   // once, so what the terms derive from it alone is hoisted
    float acc = 0.0f;
    for (int r = 0; r < a.reps; ++r) acc = __fadd_rn(acc, form_term<kForm>(a, thr, c, x, r));
    a.out[e] = acc;
  }
}

// The loops of heavy terms: a block takes `elems` elements and spreads their
// (element, rep) terms over its threads, one term a thread, kRepThreads /
// elems reps a pass; then thread t < elems adds element t's terms from
// shared memory in rep order onto its running sum, from zero, as the loop
// does.
template <int kForm>
__global__ void __launch_bounds__(kRepThreads)
gather_form_reps_kernel(FormArgs a, Thresholds thr, int elems) {
  __shared__ float s_term[kRepThreads];
  const int e0 = blockIdx.x * elems;
  const int batch = kRepThreads / elems;   // reps a pass
  const int t = threadIdx.x;
  const int e_term = e0 + t % elems;       // this thread's term: (element, rep)
  float acc = 0.0f;
  for (int r0 = 0; r0 < a.reps; r0 += batch) {
    const int n = min(batch, a.reps - r0);
    if (t < n * elems && e_term < a.n) {
      s_term[t] = form_term<kForm>(a, thr, column(a, e_term), a.x[e_term], r0 + t / elems);
    }
    __syncthreads();
    if (t < elems) {
      for (int r = 0; r < n; ++r) acc = __fadd_rn(acc, s_term[r * elems + t]);
    }
    __syncthreads();
  }
  if (t < elems && e0 + t < a.n) a.out[e0 + t] = acc;
}

Thresholds fill(const float* thresholds, int n) {
  Thresholds thr;
  const float inf = std::numeric_limits<float>::infinity();
  for (int k = 0; k < kMaxChain; ++k) thr.v[k] = k < n ? thresholds[k] : inf;
  return thr;
}

template <typename T, int kMode>
int launch_select(const void* d2, const void* tab, float* partial, const Thresholds& thr,
                  int p_count, int rl, int reps, float cutoff2, cudaStream_t s) {
  select_reps_kernel<T, kMode><<<p_count * (rl / kSelectThreads), kSelectThreads, 0, s>>>(
      static_cast<const T*>(d2), static_cast<const T*>(tab), partial, thr, p_count, rl, reps,
      cutoff2);
  return (int)cudaGetLastError();
}

template <typename T>
int select_all(int mode, const void* d2, const void* tab, float* partial, float* totals,
               void* out, const Thresholds& thr, int p_count, int rl, int reps, float cutoff2,
               cudaStream_t s) {
  int err = mode == kChain  ? launch_select<T, kChain>(d2, tab, partial, thr, p_count, rl, reps, cutoff2, s)
            : mode == kTak  ? launch_select<T, kTak>(d2, tab, partial, thr, p_count, rl, reps, cutoff2, s)
                            : launch_select<T, kTourn>(d2, tab, partial, thr, p_count, rl, reps, cutoff2, s);
  if (err != 0) return err;
  err = sum_rows(partial, nullptr, totals, rl / kSelectThreads, p_count * reps, s);
  if (err != 0) return err;
  rep_acc_kernel<T><<<(p_count + 127) / 128, 128, 0, s>>>(totals, static_cast<T*>(out),
                                                          p_count, reps);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_loop(const float* lig, const float* rec, const float* tab, float* out,
                const Thresholds& thr, int p_count, int l_count, int r_count, float cutoff2,
                cudaStream_t s) {
  auto kernel = receptor_loop_kernel<kMode>;
  const size_t smem = (size_t)3 * r_count * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((l_count + kLoopThreads - 1) / kLoopThreads, p_count);
  kernel<<<grid, kLoopThreads, smem, s>>>(lig, rec, tab, out, thr, l_count, r_count, cutoff2);
  return (int)cudaGetLastError();
}

// A loop of heavy terms over more than one rep spreads its terms over
// threads; everything else runs one thread an element.  On the H100 the
// spread took the 64-rep slot gathers from 12-18 us to 6 and the 64-rep
// chain from 55 to 22, and made the light loops and a one-rep chain
// slower (PERF.md).
template <int kForm>
int launch_form(const FormArgs& a, const Thresholds& thr, cudaStream_t s) {
  if constexpr (kHeavyTerm<kForm>) {
    if (a.reps > 1) {
      const int elems = kRepThreads / min(a.reps, kRepThreads);
      gather_form_reps_kernel<kForm><<<(a.n + elems - 1) / elems, kRepThreads, 0, s>>>(a, thr,
                                                                                     elems);
      return (int)cudaGetLastError();
    }
  }
  gather_form_kernel<kForm><<<(a.n + kFormThreads - 1) / kFormThreads, kFormThreads, 0, s>>>(
      a, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// P1: select_reps; 0 or a CUDA error code.
extern "C" int select_reps_launch(const void* d2, const void* tab, void* partial, void* totals,
                                  void* out, int p_count, int rl, int reps, int mode, int bf16,
                                  int n_thr, const float* thresholds, float cutoff2,
                                  void* stream) {
  if (p_count < 1 || rl < kSelectThreads || rl % kSelectThreads != 0 || reps < 1 ||
      n_thr != kK - 1 || mode < kChain || mode > kTourn) {
    return (int)cudaErrorInvalidValue;
  }
  const Thresholds thr = fill(thresholds, n_thr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* tot = static_cast<float*>(totals);
  return bf16 ? select_all<__nv_bfloat16>(mode, d2, tab, part, tot, out, thr, p_count, rl, reps,
                                          cutoff2, s)
              : select_all<float>(mode, d2, tab, part, tot, out, thr, p_count, rl, reps,
                                  cutoff2, s);
}

// P2, P3: receptor_loop; 0 or a CUDA error code.
extern "C" int receptor_loop_launch(const void* lig, const void* rec, const void* tab, void* out,
                                    int p_count, int l_count, int r_count, int mode, int n_thr,
                                    const float* thresholds, float cutoff2, void* stream) {
  if (p_count < 1 || l_count < 1 || r_count < 1 || n_thr != kMaxChain || mode < kLoopSlot ||
      mode > kLoopChain) {
    return (int)cudaErrorInvalidValue;
  }
  const Thresholds thr = fill(thresholds, n_thr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(lig);
  const float* b = static_cast<const float*>(rec);
  const float* t = static_cast<const float*>(tab);
  float* o = static_cast<float*>(out);
  switch (mode) {
    case kLoopSlot: return launch_loop<kLoopSlot>(a, b, t, o, thr, p_count, l_count, r_count, cutoff2, s);
    case kLoopGather: return launch_loop<kLoopGather>(a, b, t, o, thr, p_count, l_count, r_count, cutoff2, s);
    default: return launch_loop<kLoopChain>(a, b, t, o, thr, p_count, l_count, r_count, cutoff2, s);
  }
}

// P4-P6: gather_form; 0 or a CUDA error code.
extern "C" int gather_form_launch(const void* x, const void* tab, const void* idx, const void* rec,
                                  void* out, int p_count, int l_count, int form, int n_slot,
                                  int rec_cols, int reps, int row, int n_thr,
                                  const float* thresholds, void* stream) {
  if (p_count < 1 || l_count < 1 || reps < 1 || n_thr < 0 || n_thr > kMaxChain) {
    return (int)cudaErrorInvalidValue;
  }
  const FormArgs a{static_cast<const float*>(x), static_cast<const float*>(tab),
                   static_cast<const int32_t*>(idx), static_cast<const float*>(rec),
                   static_cast<float*>(out), p_count * l_count, l_count, n_slot, rec_cols,
                   reps, row};
  const Thresholds thr = fill(thresholds, n_thr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kBare: return launch_form<kBare>(a, thr, s);
    case kSlotGather: return launch_form<kSlotGather>(a, thr, s);
    case kStaticLoop: return launch_form<kStaticLoop>(a, thr, s);
    case kSliceLoop: return launch_form<kSliceLoop>(a, thr, s);
    case kRowLoop: return launch_form<kRowLoop>(a, thr, s);
    case kParityLoop: return launch_form<kParityLoop>(a, thr, s);
    case kTouch: return launch_form<kTouch>(a, thr, s);
    case kChainLoop: return launch_form<kChainLoop>(a, thr, s);
    case kSqrt: return launch_form<kSqrt>(a, thr, s);
    case kTruncCast: return launch_form<kTruncCast>(a, thr, s);
    case kScalarLoop: return launch_form<kScalarLoop>(a, thr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
