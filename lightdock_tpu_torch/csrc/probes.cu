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
//   select_reps_kernel<kBf16, kMode> (P1) one thread an (r, l) element of
//     one pose, its entries in registers (tak's in shared memory, staged
//     once a block, as the script keeps them in VMEM).  Bound by issue
//     slots: an f32 element-rep issues 48-56 instructions, 35-40 of them
//     the form's (chain: 20 compares and 20 predicated adds; tourn: 20
//     compares and the compiler's 15 selects, all on the half-rate ALU
//     pipe; tak: 20 compares, 20 counts kept in float, so that they issue
//     as predicated FADDs on the FMA pipe (an int count compiled to four
//     instructions a step), one conversion and one shared load), the rest
//     the moved d2, the mask and the term's share of the sum, against
//     under 1 MB of inputs.  bfloat16 tak and tourn select on the widened
//     values, which compare and select as the bfloat16 ones do.  What the
//     design does about it:
//     - many terms in flight: a thread computes a batch of 8 reps' terms
//       for its element before it adds any; chain16 packs two reps in one
//       bf16x2 register, so a chain step is one HSET2 (the mask), one HADD2
//       and one LOP3 (the select) for two terms, each rounded once in
//       bf16, which equals the float operation rounded to bf16 (24 >= 2 8
//       + 2); the rep's shift round(round(i) 1e-6) is computed once a rep,
//       by one thread, a batch ahead, into shared memory;
//     - a full card: the grid splits the reps into chunks besides the
//       poses and the 256-element blocks, as many chunks as the card's
//       resident blocks (queried once a kernel and device) leave room for;
//     - the (R, L) sum without a shuffle tree a term: the terms go to
//       shared memory, then warp w adds rep w of the batch: lane l adds the
//       8 consecutive elements 8l..8l+7 in order from two vector loads, and
//       only the 32 run sums go through a five-step shuffle tree, one
//       barrier a batch (two buffers, taken in turn);
//     - two launches a call: rep_sum_kernel, one block a pose, adds each
//       rep's block sums in block order, rounds the total to the working
//       type and adds the reps in order from zero, as the probe's loop does.
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
// the clip, bfloat16 rounded after every operation (as PyTorch and XLA do:
// P1 rounds each packed operation once, the rest compute in float and
// round).  Sums over r and reps run in the probes' order, and P1's (R, L)
// sum in the kernel's own, so the plain versions (ops/probes.py) repeat them
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <limits>
#include <type_traits>

namespace {

constexpr int kSelectThreads = 256;   // P1: elements a block, one a thread
constexpr int kRepBatch = kSelectThreads / 32;   // P1: a thread's reps in flight; warp w adds rep w
constexpr int kRun = kSelectThreads / 32;        // P1: consecutive elements a lane adds in order
constexpr int kSelectMinBlocks = 4;  // P1: resident blocks an SM (32 warps) at its registers
constexpr int kRepSumThreads = 256;   // P1's second kernel: reps a pass
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

// clip(int32(2 sqrt(d2) - 1), 0, 31): the cast truncates toward zero.
__device__ __forceinline__ int slot_of(float d2) {
  const float m = __fsub_rn(__fmul_rn(2.0f, sqrtf(d2)), 1.0f);
  return min(max(__float2int_rz(m), 0), kNSlot - 1);
}

// P1's arguments: the thresholds and the cutoff in the working type (for
// bfloat16 rounded on the host and widened; chain16 also takes them as
// bf16x2 pairs {s, s}), the shapes and the rep chunks of the grid.
struct SelectArgs {
  float thr[kK - 1];
  uint32_t thr2[kK - 1];
  float cutoff2;
  uint32_t cutoff2_2;
  int p_count, rl, reps, chunks;
};

// exp_gather_kernel.py's tourn_body: a tree of selects over t[LO:HI].
template <int LO, int HI>
__device__ __forceinline__ float tournament(const float (&t)[kK], const SelectArgs& a, float x) {
  if constexpr (HI - LO == 1) {
    return t[LO];
  } else {
    constexpr int MID = (LO + HI) / 2;
    const float left = tournament<LO, MID>(t, a, x);
    const float right = tournament<MID, HI>(t, a, x);
    return x >= a.thr[MID - 1] ? right : left;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Each half 0xffff where a >= b, else 0 (one HSET2 on sm_90).
__device__ __forceinline__ uint32_t ge_mask(uint32_t a, uint32_t b) {
  uint32_t m;
  asm("set.ge.u32.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(a), "r"(b));
  return m;
}

// Rep i's shift round(round(i) 1e-6) in the working type: a float, or the
// bfloat16 pair of reps i and i + 1 (i in the low half).
template <bool kBf16>
__device__ __forceinline__ uint32_t rep_shift(int i) {
  if constexpr (kBf16) {
    const float eps = __bfloat162float(__float2bfloat16_rn(1e-6f));
    uint32_t pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ri = __bfloat162float(__float2bfloat16_rn((float)(i + h)));
      const __nv_bfloat16 d = __float2bfloat16_rn(__fmul_rn(ri, eps));
      pair |= (uint32_t)(*reinterpret_cast<const uint16_t*>(&d)) << (16 * h);
    }
    return pair;
  } else {
    return __float_as_uint(__fmul_rn((float)i, 1e-6f));
  }
}

// Grid: (rep chunk, pose, element block), the block fastest; partial is
// (P, R L / 256, reps): each rep's sum over the block's 256 elements.
// A batch of kRepBatch reps: every thread computes its element's terms of
// the batch into s_term (chain16: four bf16x2 pairs); after one barrier,
// warp w adds rep w: lane l the run 8l..8l+7 in order from its first
// element, then the 32 run sums in a shuffle tree (lane l + off onto lane
// l).  Reps past the chunk's end are computed and not added.
template <bool kBf16, int kMode>
__global__ void __launch_bounds__(kSelectThreads, kSelectMinBlocks)
select_reps_kernel(const void* __restrict__ d2_, const void* __restrict__ tab_,
                   float* __restrict__ partial, SelectArgs a) {
  using Raw = std::conditional_t<kBf16, uint16_t, float>;
  constexpr bool kPacked = kBf16 && kMode == kChain;
  constexpr int kShiftWords = kBf16 ? kRepBatch / 2 : kRepBatch;
  __shared__ __align__(16) float s_term[2][kRepBatch][kSelectThreads];
  __shared__ __align__(16) uint32_t s_shift[2][kRepBatch];
  __shared__ float s_tab[kMode == kTak ? kK : 1][kSelectThreads];   // tak's entries, [k][e]
  const Raw* d2 = static_cast<const Raw*>(d2_);
  const Raw* tab = static_cast<const Raw*>(tab_);
  const int nb = a.rl / kSelectThreads;
  const int b = blockIdx.x % nb;
  const int p = (blockIdx.x / nb) % a.p_count;
  const int c = blockIdx.x / (nb * a.p_count);
  const int i_begin = (int)((long long)c * a.reps / a.chunks);
  const int i_end = (int)((long long)(c + 1) * a.reps / a.chunks);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = b * kSelectThreads + tid;
  float* part = partial + ((size_t)p * nb + b) * a.reps;

  float t[kMode == kChain && !kPacked || kMode == kTourn ? kK : 1];
  uint32_t t2[kPacked ? kK : 1];   // entry k in both halves
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const Raw v = tab[(size_t)k * a.rl + e];
    if constexpr (kMode == kTak) {
      s_tab[k][tid] = widen(v);
    } else if constexpr (kPacked) {
      t2[k] = (uint32_t)v * 0x10001u;
    } else {
      t[k] = widen(v);
    }
  }
  const Raw x0 = d2[(size_t)p * a.rl + e];
  if (tid < kShiftWords) s_shift[0][tid] = rep_shift<kBf16>(i_begin + (kBf16 ? 2 : 1) * tid);
  __syncthreads();

  const int batches = (i_end - i_begin + kRepBatch - 1) / kRepBatch;
#pragma unroll 1
  for (int k = 0; k < batches; ++k) {
    const int buf = k & 1;
    const int i0 = i_begin + k * kRepBatch;
    if (tid < kShiftWords) {   // the next batch's shifts
      s_shift[buf ^ 1][tid] = rep_shift<kBf16>(i0 + kRepBatch + (kBf16 ? 2 : 1) * tid);
    }
    uint32_t sh[kRepBatch];
    {
      const uint4 lo = *reinterpret_cast<const uint4*>(&s_shift[buf][0]);
      const uint4 hi = *reinterpret_cast<const uint4*>(&s_shift[buf][4]);
      sh[0] = lo.x; sh[1] = lo.y; sh[2] = lo.z; sh[3] = lo.w;
      sh[4] = hi.x; sh[5] = hi.y; sh[6] = hi.z; sh[7] = hi.w;
    }
    if constexpr (kPacked) {
      constexpr int kPairs = kRepBatch / 2;
      const uint32_t xx = (uint32_t)x0 * 0x10001u;
      uint32_t x2[kPairs], sel[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        x2[j] = bits(__hadd2(bf2(xx), bf2(sh[j])));
        sel[j] = t2[0];
      }
#pragma unroll
      for (int q = 0; q < kK - 1; ++q) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const uint32_t m = ge_mask(x2[j], a.thr2[q]);
          const uint32_t sum = bits(__hadd2(bf2(sel[j]), bf2(t2[q + 1])));
          sel[j] = (sum & m) | (sel[j] & ~m);
        }
      }
      uint32_t* row = reinterpret_cast<uint32_t*>(&s_term[buf][0][0]);
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        row[j * kSelectThreads + tid] =
            bits(__hmul2(bf2(sel[j]), __hle2(bf2(x2[j]), bf2(a.cutoff2_2))));
      }
    } else {
      float x[kRepBatch];
      if constexpr (kBf16) {
        const uint32_t xx = (uint32_t)x0 * 0x10001u;
#pragma unroll
        for (int j = 0; j < kRepBatch / 2; ++j) {
          const uint32_t x2 = bits(__hadd2(bf2(xx), bf2(sh[j])));
          x[2 * j] = __uint_as_float(x2 << 16);
          x[2 * j + 1] = __uint_as_float(x2 & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRepBatch; ++j) x[j] = __fadd_rn(widen(x0), __uint_as_float(sh[j]));
      }
      float sel[kRepBatch];
      if constexpr (kMode == kChain) {
#pragma unroll
        for (int j = 0; j < kRepBatch; ++j) sel[j] = t[0];
#pragma unroll
        for (int q = 0; q < kK - 1; ++q) {
#pragma unroll
          for (int j = 0; j < kRepBatch; ++j) {
            sel[j] = x[j] >= a.thr[q] ? __fadd_rn(sel[j], t[q + 1]) : sel[j];
          }
        }
      } else if constexpr (kMode == kTak) {
        float cnt[kRepBatch];   // the count in float: a predicated FADD a step
#pragma unroll
        for (int j = 0; j < kRepBatch; ++j) cnt[j] = 0.0f;
#pragma unroll
        for (int q = 0; q < kK - 1; ++q) {
#pragma unroll
          for (int j = 0; j < kRepBatch; ++j) {
            cnt[j] = x[j] >= a.thr[q] ? __fadd_rn(cnt[j], 1.0f) : cnt[j];
          }
        }
#pragma unroll
        for (int j = 0; j < kRepBatch; ++j) sel[j] = s_tab[__float2int_rz(cnt[j])][tid];
      } else {
#pragma unroll
        for (int j = 0; j < kRepBatch; ++j) sel[j] = tournament<0, kK>(t, a, x[j]);
      }
#pragma unroll
      for (int j = 0; j < kRepBatch; ++j) {
        s_term[buf][j][tid] = __fmul_rn(sel[j], x[j] <= a.cutoff2 ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
    if (i0 + warp < i_end) {   // warp w adds rep i0 + w
      float v[kRun];
      if constexpr (kPacked) {
        const uint4* run = reinterpret_cast<const uint4*>(&s_term[buf][warp >> 1][lane * kRun]);
        const uint4 q0 = run[0], q1 = run[1];
        const uint32_t w[kRun] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          v[j] = __uint_as_float(warp & 1 ? w[j] & 0xffff0000u : w[j] << 16);
        }
      } else {
        const float4* run = reinterpret_cast<const float4*>(&s_term[buf][warp][lane * kRun]);
        const float4 q0 = run[0], q1 = run[1];
        v[0] = q0.x; v[1] = q0.y; v[2] = q0.z; v[3] = q0.w;
        v[4] = q1.x; v[5] = q1.y; v[6] = q1.z; v[7] = q1.w;
      }
      float r = v[0];
#pragma unroll
      for (int j = 1; j < kRun; ++j) r = __fadd_rn(r, v[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, off));
      }
      if (lane == 0) part[i0 + warp] = r;
    }
  }
}

// out[p]: each rep's block sums of pose p added in block order, the total
// rounded to the working type, the reps added in order from zero in it.
// One block a pose; kRepSumThreads reps a pass.
template <bool kBf16>
__global__ void __launch_bounds__(kRepSumThreads)
rep_sum_kernel(const float* __restrict__ partial, void* __restrict__ out_, int nb, int reps) {
  using T = std::conditional_t<kBf16, __nv_bfloat16, float>;
  __shared__ float s_tot[kRepSumThreads];   // the totals, rounded to the working type
  const float* part = partial + (size_t)blockIdx.x * nb * reps;
  T acc = T(0.0f);
  for (int i0 = 0; i0 < reps; i0 += kRepSumThreads) {
    const int i = i0 + threadIdx.x;
    if (i < reps) {
      float tot = part[i];
      for (int b = 1; b < nb; ++b) tot = __fadd_rn(tot, part[(size_t)b * reps + i]);
      s_tot[threadIdx.x] = kBf16 ? __bfloat162float(__float2bfloat16_rn(tot)) : tot;
    }
    __syncthreads();
    if (threadIdx.x == 0) {   // one bf16 add rounds once, as the float add rounded to bf16
      const int n = min(kRepSumThreads, reps - i0);
      for (int j = 0; j < n; ++j) {
        if constexpr (kBf16) {
          acc = __hadd(acc, __float2bfloat16_rn(s_tot[j]));
        } else {
          acc = __fadd_rn(acc, s_tot[j]);
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) static_cast<T*>(out_)[blockIdx.x] = acc;
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

// The SM count of device dev, queried once a device; 0 on an error.
int sm_count(int dev) {
  static int counts[kMaxDevices] = {};
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    counts[dev] = 0;
  }
  return counts[dev];
}

const void* select_kernel(int bf16, int mode) {
  if (bf16) {
    return mode == kChain ? (const void*)select_reps_kernel<true, kChain>
           : mode == kTak ? (const void*)select_reps_kernel<true, kTak>
                          : (const void*)select_reps_kernel<true, kTourn>;
  }
  return mode == kChain ? (const void*)select_reps_kernel<false, kChain>
         : mode == kTak ? (const void*)select_reps_kernel<false, kTak>
                        : (const void*)select_reps_kernel<false, kTourn>;
}

// Resident blocks an SM of P1's kernel (bf16, mode) on device dev, queried
// once a kernel and device; 0 on an error.
int select_resident(int bf16, int mode, int dev) {
  static int resident[2][3][kMaxDevices] = {};
  int& n = resident[bf16][mode][dev];
  if (n == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, select_kernel(bf16, mode), kSelectThreads, 0) != cudaSuccess) {
    n = 0;
  }
  return n;
}

// P1's two launches.  The reps split into as many chunks as the card's
// resident blocks hold beside the P (R L / 256) element blocks (at least
// one, at most one a batch of reps).
int launch_select(const void* d2, const void* tab, float* partial, void* out, SelectArgs a,
                  int bf16, int mode, cudaStream_t s) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev), resident = select_resident(bf16, mode, dev);
  if (sms == 0 || resident == 0) return (int)cudaErrorInvalidDevice;
  const int nb = a.rl / kSelectThreads;
  const long long units = (long long)a.p_count * nb;
  const long long room = (long long)sms * resident / units;
  a.chunks = (int)std::max(1LL, std::min<long long>((a.reps + kRepBatch - 1) / kRepBatch, room));
  void* args[] = {(void*)&d2, (void*)&tab, (void*)&partial, (void*)&a};
  const cudaError_t err = cudaLaunchKernel(select_kernel(bf16, mode),
                                           dim3((unsigned)(units * a.chunks)),
                                           dim3(kSelectThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    rep_sum_kernel<true><<<a.p_count, kRepSumThreads, 0, s>>>(partial, out, nb, a.reps);
  } else {
    rep_sum_kernel<false><<<a.p_count, kRepSumThreads, 0, s>>>(partial, out, nb, a.reps);
  }
  return (int)cudaGetLastError();
}

// A float rounded to bfloat16 (to nearest, ties to even) as its bits.
uint16_t bf16_bits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);   // NaN, quiet
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

float bf16_float(uint16_t h) {
  const uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
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

// P1: select_reps; 0 or a CUDA error code.  partial holds P (R L / 256)
// reps floats.
extern "C" int select_reps_launch(const void* d2, const void* tab, void* partial, void* out,
                                  int p_count, int rl, int reps, int mode, int bf16,
                                  int n_thr, const float* thresholds, float cutoff2,
                                  void* stream) {
  if (p_count < 1 || rl < kSelectThreads || rl % kSelectThreads != 0 || reps < 1 ||
      n_thr != kK - 1 || mode < kChain || mode > kTourn) {
    return (int)cudaErrorInvalidValue;
  }
  SelectArgs a{};
  for (int k = 0; k < kK - 1; ++k) {
    const uint16_t h = bf16_bits(thresholds[k]);
    a.thr[k] = bf16 ? bf16_float(h) : thresholds[k];
    a.thr2[k] = (uint32_t)h * 0x10001u;
  }
  const uint16_t hc = bf16_bits(cutoff2);
  a.cutoff2 = bf16 ? bf16_float(hc) : cutoff2;
  a.cutoff2_2 = (uint32_t)hc * 0x10001u;
  a.p_count = p_count;
  a.rl = rl;
  a.reps = reps;
  return launch_select(d2, tab, static_cast<float*>(partial), out, a, bf16 != 0, mode,
                       static_cast<cudaStream_t>(stream));
}

// P1's kernel (bf16, mode): its resident blocks an SM, registers and local
// (stack and spill) bytes a thread; 0 or a CUDA error code.
extern "C" int select_reps_occupancy(int bf16, int mode, int* blocks, int* regs, int* local) {
  if (mode < kChain || mode > kTourn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, select_kernel(bf16 != 0, mode));
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, select_kernel(bf16 != 0, mode),
                                                    kSelectThreads, 0);
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return (int)e;
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
