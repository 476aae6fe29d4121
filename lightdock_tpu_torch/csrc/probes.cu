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
//   receptor_loop_kernel<kMode, kThreads> (P2, P3; the Pallas `kernel` of
//     exp_gather2d.py and exp_gather32.py) sums each (p, l)'s terms over
//     the receptor atoms in order.  Bound by issue slots: a pair issues
//     about 32 instructions (slot), 45 (gather) or 62 (chain): d2 8, the
//     correctly rounded sqrt 10 and the slot 5, the chain's 20 compares
//     and 20 predicated adds; the gather at P3 also waits on memory.  One
//     thread an element ran one receptor atom at a time on 2-8 warps an
//     SM, a full round trip to memory a step, and every pose read the
//     table again.  Now:
//     - many loads in flight: a thread computes one receptor atom's terms
//       for the 8 poses of its tile before any is added; the chain issues
//       its 21 loads with no condition, the gather its 8 after the 8 slots
//       and stores what they bring a batch later, so that they stay in
//       flight through the barrier (at P3 its entries spread over the
//       53.5 MB table, more than L2 holds);
//     - enough warps where elements are few: a block's tile is 8 poses x 8
//       ligand atoms; all but two of its warps split each batch of receptor
//       atoms, one a thread, and put the terms in shared memory, where the
//       other two warps, one thread an element, add the batch before in
//       receptor order.  The block's threads follow the tiles and the SM
//       count (1,024 at P3's 128 tiles, 256 at P2's 512): 32 warps an SM;
//     - table rows shared across poses: the thread that loads tab[r, :, l]
//       (one 32-byte sector a row for the tile's 8 ligand atoms) applies it
//       to the tile's 8 poses from registers, so L2 serves P / 8 reads of
//       the table, not P.  Shared memory holds only the terms; the gather
//       loads its one entry a pair directly: staging a thread's 32 slots
//       in shared memory to read 8 ran about 1.8x slower on the H100.
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
constexpr int kTileL = 8;         // receptor_loop: ligand atoms a tile, a 32-byte table row
constexpr int kTileP = 8;         // receptor_loop: poses a tile, sharing each table load
constexpr int kTileE = kTileL * kTileP;   // a tile's elements: two warps of adders
constexpr int kTermPitch = kTileE + 8;    // a batch row of terms, padded off the next's banks
constexpr int kLoopSmThreads = 1024;      // receptor_loop: threads an SM (64 registers)
constexpr int kMaxDevices = 64;

// receptor_loop: the receptor atoms of a batch, one a computing thread (all
// but the two warps of adders).
__host__ __device__ constexpr int loop_atoms(int threads) { return (threads - kTileE) / kTileL; }
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

// A block takes a tile of kTileP poses x kTileL ligand atoms (kTileE
// elements) and walks the receptor atoms in batches.  Its first two warps
// are the adders, one thread an element; the others compute, one receptor
// atom of the batch a thread (kAtoms atoms a batch).  Computing thread
// (lane_l, rb) takes atom r0 + rb at ligand atom l0 + lane_l for every pose
// of the tile: the chain loads its 21 entries of tab[r, :, l] once, with no
// condition, and applies them to the kTileP poses; the gather computes
// kTileP slots, issues their kTileP loads and stores what they bring one
// batch later, so the loads stay in flight through the barrier and the
// next batch's slots.  The terms go to one of two shared buffers, taken in
// turn; while the computing threads fill one, the adders add the batch in
// the other onto their elements' running sums, in receptor order, so the
// adds' chain of dependent additions is off the batch's critical path.  The
// poses and ligand atoms past a ragged tile's end compute on the last real
// ones and are not stored.
template <int kMode, int kThreads>
__global__ void __launch_bounds__(kThreads, kLoopSmThreads / kThreads)
receptor_loop_kernel(const float* __restrict__ lig, const float* __restrict__ rec,
                     const float* __restrict__ tab, float* __restrict__ out, Thresholds thr,
                     int p_count, int l_count, int r_count, float cutoff2) {
  constexpr int kAtoms = loop_atoms(kThreads);
  constexpr int kLag = kMode == kLoopGather ? 1 : 0;     // batches from a term to its store
  extern __shared__ float s_term[];                       // [2][kAtoms][kTermPitch]
  const int l_tiles = (l_count + kTileL - 1) / kTileL;
  const int l0 = (blockIdx.x % l_tiles) * kTileL;
  const int p0 = (blockIdx.x / l_tiles) * kTileP;
  const int batches = (r_count + kAtoms - 1) / kAtoms;
  const int rounds = batches + kLag + 1;   // one barrier a round

  if (threadIdx.x < kTileE) {   // an adder: in round i, the batch stored in round i - 1
    float acc = 0.0f;
    for (int i = 0; i < rounds; ++i) {
      const int k = i - 1 - kLag;
      if (k >= 0) {
        const float* terms = s_term + (k & 1) * kAtoms * kTermPitch + threadIdx.x;
        const int n = min(kAtoms, r_count - k * kAtoms);
        for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, terms[j * kTermPitch]);
      }
      __syncthreads();
    }
    const int p = p0 + threadIdx.x / kTileL, ll = l0 + threadIdx.x % kTileL;
    if (p < p_count && ll < l_count) out[(size_t)p * l_count + ll] = acc;
    return;
  }

  const int lane_l = (threadIdx.x - kTileE) % kTileL;
  const int rb = (threadIdx.x - kTileE) / kTileL;
  const int l = min(l0 + lane_l, l_count - 1);
  float lx[kTileP], ly[kTileP], lz[kTileP];
#pragma unroll
  for (int p = 0; p < kTileP; ++p) {
    const float* lp = lig + (size_t)min(p0 + p, p_count - 1) * 3 * l_count + l;
    lx[p] = lp[0];
    ly[p] = lp[l_count];
    lz[p] = lp[2 * l_count];
  }
  const size_t row = (size_t)l_count;
  float g[kTileP];   // the gather's entries, stored one round after their loads
  for (int i = 0; i < rounds; ++i) {
    const int r0 = i * kAtoms;
    const int n = i < batches ? min(kAtoms, r_count - r0) : 0;
    float* mine = s_term + (i & 1) * kAtoms * kTermPitch + rb * kTermPitch + lane_l;
    const int r = min(r0 + rb, r_count - 1);
    const float* tr = tab + (size_t)r * kNSlot * row + l;
    float d2[kTileP];
    if (rb < n) {
      const float rx = __ldg(rec + 3 * r), ry = __ldg(rec + 3 * r + 1),
                  rz = __ldg(rec + 3 * r + 2);
#pragma unroll
      for (int p = 0; p < kTileP; ++p) {
        const float dx = __fsub_rn(lx[p], rx);
        const float dy = __fsub_rn(ly[p], ry);
        const float dz = __fsub_rn(lz[p], rz);
        d2[p] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
    }
    if constexpr (kMode == kLoopChain) {
      if (rb < n) {
        float entry[kMaxChain + 1];
#pragma unroll
        for (int k = 0; k <= kMaxChain; ++k) entry[k] = __ldg(tr + k * row);
#pragma unroll
        for (int p = 0; p < kTileP; ++p) {
          float c = entry[0];
#pragma unroll
          for (int k = 0; k < kMaxChain; ++k) {
            c = d2[p] >= thr.v[k] ? __fadd_rn(c, entry[k + 1]) : c;
          }
          mine[p * kTileL] = __fmul_rn(c, d2[p] <= cutoff2 ? 1.0f : 0.0f);
        }
      }
    } else if constexpr (kMode == kLoopSlot) {
      if (rb < n) {
#pragma unroll
        for (int p = 0; p < kTileP; ++p) mine[p * kTileL] = (float)slot_of(d2[p]);
      }
    } else {
      int slot[kTileP];
      if (rb < n) {
#pragma unroll
        for (int p = 0; p < kTileP; ++p) slot[p] = slot_of(d2[p]);
      }
      if (i > 0 && rb < min(kAtoms, r_count - (r0 - kAtoms))) {   // the previous round's loads
        float* prev = s_term + ((i - 1) & 1) * kAtoms * kTermPitch + rb * kTermPitch + lane_l;
#pragma unroll
        for (int p = 0; p < kTileP; ++p) prev[p * kTileL] = g[p];
      }
      if (rb < n) {
#pragma unroll
        for (int p = 0; p < kTileP; ++p) g[p] = __ldg(tr + slot[p] * row);
      }
    }
    __syncthreads();
  }
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

// The SM count of device dev, queried once a device; 0 on an error.
int sm_count(int dev) {
  static int counts[kMaxDevices] = {};
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    counts[dev] = 0;
  }
  return counts[dev];
}

template <int kMode, int kThreads>
int launch_loop_as(const float* lig, const float* rec, const float* tab, float* out,
                   const Thresholds& thr, int p_count, int l_count, int r_count, float cutoff2,
                   int blocks, int dev, cudaStream_t s) {
  auto kernel = receptor_loop_kernel<kMode, kThreads>;
  constexpr size_t smem = (size_t)2 * loop_atoms(kThreads) * kTermPitch * sizeof(float);
  static bool ready[kMaxDevices] = {};   // the shared-memory allowance, set once a device
  if (!ready[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  kernel<<<blocks, kThreads, smem, s>>>(lig, rec, tab, out, thr, p_count, l_count, r_count,
                                        cutoff2);
  return (int)cudaGetLastError();
}

// The threads of a block, chosen from the tiles and the SMs so that the
// card holds about kLoopSmThreads threads an SM: where the tiles leave at
// most one block an SM (P3: 128 tiles), 1,024 threads and 120 receptor
// atoms a batch; else (P2: 512 tiles) 256 and 24, four blocks an SM.
template <int kMode>
int launch_loop(const float* lig, const float* rec, const float* tab, float* out,
                const Thresholds& thr, int p_count, int l_count, int r_count, float cutoff2,
                cudaStream_t s) {
  const int blocks = ((p_count + kTileP - 1) / kTileP) * ((l_count + kTileL - 1) / kTileL);
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  if (blocks <= sms) {
    return launch_loop_as<kMode, 1024>(lig, rec, tab, out, thr, p_count, l_count, r_count,
                                       cutoff2, blocks, dev, s);
  }
  return launch_loop_as<kMode, 256>(lig, rec, tab, out, thr, p_count, l_count, r_count,
                                    cutoff2, blocks, dev, s);
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
